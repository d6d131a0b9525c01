"""Mixture of experts with sample-sort token dispatch.

Token dispatch is the bucket phase of GPU BUCKET SORT with the router's
expert ids as bucket assignments: a stable sort of the (expert id,
slot) pairs, per-expert counts and their exclusive prefix sum, one
relocation scatter into the dense (E, capacity, d) buffer.  The
capacity is static, so routing is deterministic and bit for bit the
same whichever way the ranks are computed.

Dispatches (``MoEConfig.dispatch``), as the reference tests them:

* ``"sample_sort"``: the router's top-k ids are K4's
  (``kernels.ops.topk``), the dispatch argsort the deterministic sample
  sort (``core.bucket_sort.argsort``: K1, and K2 when the ids pass
  ``direct_max``);
* ``"onehot"``: a stable descending library sort for the top-k, and the
  rank within the expert from a cumsum over a one-hot (M, E) matrix;
* any other value (``"xla_sort"``, ``"dense"``): the same top-k, and a
  stable library argsort for the rank.

The router's rows and the ids go to the sorts contiguous: the kernels
take contiguous rows only (ROADMAP.md Queue 3 F1).

Training: the gates carry the router's gradient on every route.  K4
returns decoded key words, which carry none (nor do the reference's,
whose codec's bitcast cuts the gradient: ROADMAP.md Queue 3 R8), so on
the ``"sample_sort"`` route the gate values are taken from the
probabilities at K4's ids (D21): the codec is a bijection on finite
non-negative float32, so they are bit-equal to K4's values.  The
dispatch permutation, ranks and counts are integers and carry no
gradient, in both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import bucket_sort
from repro_torch.core.sort_config import SortConfig, round_up
from repro_torch.kernels import ops
from repro_torch.models.meta import ParamMeta, ParamModule, torch_dtype

_DISPATCH_SORT_CFG = SortConfig(tile=2048, s=64, direct_max=8192)


def moe_template(cfg: ModelConfig):
    d, pd = cfg.d_model, cfg.param_dtype
    mo = cfg.moe
    e, ff = mo.n_experts, mo.d_ff_expert
    t = {
        "router": ParamMeta((d, e), ("embed", None), "float32", "small"),
        "wg": ParamMeta((e, d, ff), ("expert", "embed", "mlp"), pd),
        "wu": ParamMeta((e, d, ff), ("expert", "embed", "mlp"), pd),
        "wd": ParamMeta((e, ff, d), ("expert", "mlp", "embed"), pd),
    }
    if mo.n_shared_experts:
        sff = mo.n_shared_experts * ff
        t["shared"] = {
            "wg": ParamMeta((d, sff), ("embed", "mlp"), pd),
            "wu": ParamMeta((d, sff), ("embed", "mlp"), pd),
            "wd": ParamMeta((sff, d), ("mlp", "embed"), pd),
        }
    return t


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: the reference's formula, rounded to 128."""
    mo = cfg.moe
    return round_up(int(mo.capacity_factor * n_tokens * mo.top_k / mo.n_experts) + 1, 128)


def _topk_gates(logits, k: int, impl: str):
    """(N,E) f32 logits -> (N,k) normalized gates + (N,k) int32 ids; ties
    toward the smaller expert id, as ``jax.lax.top_k``."""
    probs = torch.softmax(logits, dim=-1)
    if impl == "sample_sort":
        _, ids = ops.topk(probs.detach().contiguous(), k, device=probs.device)
        vals = probs.gather(1, ids.long())  # D21: K4's values, with a gradient
    else:
        # torch.topk does not promise the tie order; a stable sort does.
        vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, ids = vals[:, :k], order[:, :k]
    gates = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
    return gates.float(), ids.to(torch.int32)


def _rank_in_expert_sort(ids_flat, e: int, impl: str):
    """Within-expert rank of each slot via a STABLE sort.

    Returns (rank (M,) int32, counts (E,) int32).
    """
    m = ids_flat.shape[0]
    if impl == "sample_sort":
        perm = bucket_sort.argsort(ids_flat.contiguous(), _DISPATCH_SORT_CFG,
                                   device=ids_flat.device)
    else:
        perm = torch.argsort(ids_flat, stable=True)
    perm = perm.long()
    sorted_ids = ids_flat[perm].long()
    counts = torch.bincount(ids_flat.long(), minlength=e).to(torch.int32)
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    r_sorted = torch.arange(m, dtype=torch.int32, device=ids_flat.device) - starts[sorted_ids]
    rank = torch.empty(m, dtype=torch.int32, device=ids_flat.device)
    rank[perm] = r_sorted  # perm is a permutation: every slot written once
    return rank, counts


def _rank_in_expert_onehot(ids_flat, e: int):
    """GShard-style dense rank: cumsum over a one-hot (M,E) matrix."""
    oh = F.one_hot(ids_flat.long(), e).to(torch.int32)
    rank = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    rank = torch.sum(rank * oh, dim=-1, dtype=torch.int32)
    counts = torch.sum(oh, dim=0, dtype=torch.int32)
    return rank, counts


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar)."""
    mo = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = mo.n_experts, mo.top_k
    cap = capacity(cfg, n)
    dev = x.device

    xf = x.reshape(n, d)
    logits = xf.float() @ p["router"].float()
    gates, ids = _topk_gates(logits, k, mo.dispatch)  # (N,k)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    f_e = torch.mean(torch.sum(F.one_hot(ids.long(), e).float(), dim=1), dim=0)
    aux = e * torch.sum(f_e * torch.mean(probs, dim=0))

    ids_flat = ids.reshape(n * k)
    if mo.dispatch == "onehot":
        rank, counts = _rank_in_expert_onehot(ids_flat, e)
    else:
        rank, counts = _rank_in_expert_sort(ids_flat, e, mo.dispatch)

    keep = rank < cap
    dest = torch.where(keep, ids_flat * cap + rank, e * cap).long()  # drop overflow

    # relocation: one scatter builds the gather map.  Every dropped slot
    # lands on slot e*cap, which is sliced off, so their order is moot.
    src = torch.full((e * cap + 1,), n, dtype=torch.int32, device=dev)
    slot_token = torch.arange(n * k, dtype=torch.int32, device=dev) // k
    src = src.scatter_(0, dest, slot_token)[: e * cap]
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    x_e = x_pad[src.long()].reshape(e, cap, d)

    # expert FFN: stacked products over the experts
    dt = torch_dtype(cfg.dtype)
    x_e = x_e.to(dt)
    g = torch.bmm(x_e, p["wg"].to(dt))
    u = torch.bmm(x_e, p["wu"].to(dt))
    y_e = torch.bmm(F.silu(g) * u, p["wd"].to(dt))
    del x_e, g, u

    # combine: gather back per slot, weight, sum over k
    y_pad = torch.cat([y_e.reshape(e * cap, d), y_e.new_zeros((1, d))], dim=0)
    slot_y = y_pad[dest]  # (N*k, d); dest <= e*cap
    w = torch.where(keep, gates.reshape(n * k), 0.0).float()
    out = torch.sum((slot_y.float() * w[:, None]).reshape(n, k, d), dim=1)

    if mo.n_shared_experts:
        sp = p["shared"]
        xs = xf.to(dt)
        sg = xs @ sp["wg"].to(dt)
        su = xs @ sp["wu"].to(dt)
        out = out + ((F.silu(sg) * su) @ sp["wd"].to(dt)).float()

    return out.reshape(b, s, d).to(dt), aux


class MoE(ParamModule):
    """The MoE ffn of a layer: ``router wg wu wd`` (and ``shared``) from
    :func:`moe_template`."""

    def forward(self, x, cfg: ModelConfig):
        return moe_apply(self, x, cfg)
