"""Decoder-only LM: attention with MoE or dense ffns, trained and served.

The reference stacks its layers per period and scans over them; the
port keeps the stacked template (:func:`lm_template`, the one source of
shapes) and runs a Python loop over :class:`DecoderLayer` modules whose
parameters are period slices of it: ``layers[j].moe.wg`` is the
reference's ``period/slot{j % P}/moe/wg[j // P]`` for a pattern of P
slots (``CausalLM.param_slices``).

Training: :func:`lm_forward`, :func:`chunked_ce` and :func:`lm_loss`,
the backward through autograd, each layer under ``cfg.remat``
(:func:`_remat`; a period of the MoE configs is one layer).  Serving:
:func:`prefill` and :func:`decode_step`, under
``torch.inference_mode``.  MLA and Mamba-2 slots wait for ROADMAP.md
Queue 1 item 12d.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.config import LayerSlot, ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.meta import ParamMeta, torch_dtype, tree_leaves, tree_map_meta

_ITEM_12 = "ROADMAP.md Queue 1 item 12d"


def _check_slot(slot: LayerSlot) -> None:
    if slot.mixer in ("mla", "mamba"):
        raise NotImplementedError(
            f"the {slot.mixer!r} mixer is not ported yet ({_ITEM_12})")


# ----------------------------------------------------------- templates
def _slot_template(cfg: ModelConfig, slot: LayerSlot):
    _check_slot(slot)
    t = {}
    if slot.mixer == "attn":
        t["ln"] = L.norm_template(cfg)
        t["attn"] = attn.gqa_template(cfg)
    if slot.ffn != "none":
        t["ln2"] = L.norm_template(cfg)
    if slot.ffn == "dense":
        t["mlp"] = L.mlp_template(cfg)
    elif slot.ffn == "moe":
        t["moe"] = moe.moe_template(cfg)
    return t


def _stack_period(template, n_periods: int):
    return tree_map_meta(
        lambda m: ParamMeta(
            (n_periods,) + m.shape, ("layers",) + m.axes, m.dtype, m.init, m.scale
        ),
        template,
    )


def lm_template(cfg: ModelConfig):
    period = {
        f"slot{i}": _slot_template(cfg, s) for i, s in enumerate(cfg.layer_pattern)
    }
    return {
        "embed": L.embed_template(cfg),
        "period": _stack_period(period, cfg.n_periods),
        "final_norm": L.norm_template(cfg),
    }


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]  # a view: the layer shares the stacked tensor


# ------------------------------------------------------------- modules
class DecoderLayer(nn.Module):
    """One slot of one period: ``ln``, ``attn`` (GQA), ``ln2`` and
    ``mlp`` or ``moe``, named as the slot template's keys."""

    def __init__(self, cfg: ModelConfig, slot: LayerSlot, tensors: dict):
        super().__init__()
        self.slot = slot
        tpl = _slot_template(cfg, slot)
        kinds = {"ln": L.Norm, "attn": attn.GQAttention, "ln2": L.Norm,
                 "mlp": L.MLP, "moe": moe.MoE}
        for name, t in tpl.items():
            self.add_module(name, kinds[name](t, tensors[name]))

    def forward(self, x, cfg: ModelConfig, positions):
        """Training forward: (x, aux loss), the reference's
        ``_apply_slot_train``."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.slot.mixer == "attn":
            x = x + self.attn(self.ln(x, cfg), cfg, positions)
        if self.slot.ffn == "dense":
            x = x + self.mlp(self.ln2(x, cfg), cfg)
        elif self.slot.ffn == "moe":
            y, aux = self.moe(self.ln2(x, cfg), cfg)
            x = x + y
        return x, aux

    def prefill(self, x, cfg: ModelConfig, positions, cache_len: int):
        cache = {}
        if self.slot.mixer == "attn":
            y, cache = self.attn.prefill(self.ln(x, cfg), cfg, positions, cache_len)
            x = x + y
        return self._ffn(x, cfg), cache

    def decode(self, x, cfg: ModelConfig, cache, pos: int):
        if self.slot.mixer == "attn":
            y, cache = self.attn.decode(self.ln(x, cfg), cfg, cache, pos)
            x = x + y
        return self._ffn(x, cfg), cache

    def _ffn(self, x, cfg: ModelConfig):
        if self.slot.ffn == "dense":
            x = x + self.mlp(self.ln2(x, cfg), cfg)
        elif self.slot.ffn == "moe":
            y, _ = self.moe(self.ln2(x, cfg), cfg)
            x = x + y
        return x


class CausalLM(nn.Module):
    """``embed``, ``layers`` (a ModuleList of :class:`DecoderLayer`) and
    ``final_norm``, from a parameter tree shaped as :func:`lm_template`
    (the layers take views of its period slices)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        pat = cfg.layer_pattern
        for slot in pat:
            _check_slot(slot)
        self.embed = L.Embed(L.embed_template(cfg), params["embed"])
        layers = []
        for j in range(cfg.n_layers):
            period, i = divmod(j, len(pat))
            t = _index_tree(params["period"][f"slot{i}"], period)
            layers.append(DecoderLayer(cfg, pat[i], t))
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.Norm(L.norm_template(cfg), params["final_norm"])

    def param_slices(self):
        """(template path, period or None, parameter) of every parameter,
        leaves in the template's order: a layer's parameter is period
        ``period`` of the stacked leaf at ``path``."""
        pat = len(self.cfg.layer_pattern)
        for path, _ in tree_leaves(lm_template(self.cfg)):
            if path[0] != "period":
                yield path, None, self.get_parameter(".".join(path))
                continue
            slot = int(path[1][len("slot"):])
            for period, layer in enumerate(self.layers[slot::pat]):
                yield path, period, layer.get_parameter(".".join(path[2:]))


# ------------------------------------------------------------ training
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep the products' outputs, recompute the rest."""
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: "none" as it is; "full" recomputes its
    forward in the backward (``torch.utils.checkpoint``, non-reentrant);
    "dots" keeps the outputs of ``mm``, ``bmm`` and ``addmm`` and
    recomputes everything else, a selective-checkpoint policy that
    stands for the reference's ``jax.checkpoint_policies.checkpoint_dots``."""
    if cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kwargs)


def lm_forward(model: CausalLM, tokens, cfg: ModelConfig):
    """tokens (B,S) -> (final hidden states (B,S,d), summed aux loss)."""
    x = model.embed(tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, a = _remat(cfg, layer)(x, cfg, positions)
        aux = aux + a
    return model.final_norm(x, cfg), aux


def chunked_ce(model: CausalLM, x, targets, cfg: ModelConfig):
    """CE summed over (B,S), in sequence chunks of ``cfg.loss_chunk``:
    one chunk's float32 logits at a time are made (each chunk's are kept
    for the backward)."""
    b, s, _ = x.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        logits = model.embed.logits(x[:, i:i + c], cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[:, i:i + c].long()[..., None])[..., 0]
        total = total + torch.sum(lse - gold)
    return total


def lm_loss(model: CausalLM, batch, cfg: ModelConfig, *, aux_weight: float = 0.01):
    """Mean next-token CE plus ``aux_weight`` times the load-balance aux
    loss averaged over the layers."""
    x, aux = lm_forward(model, batch["tokens"], cfg)
    b, s, _ = x.shape
    loss = chunked_ce(model, x, batch["targets"], cfg) / (b * s)
    return loss + aux_weight * aux / max(cfg.n_layers, 1)


# ------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zero KV caches on ``device`` (None = "cuda", raising without CUDA),
    one dict a layer (``k`` and ``v`` of (B, L, K, Dh) for an attention
    slot, empty otherwise)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    caches = []
    for j in range(cfg.n_layers):
        slot = cfg.layer_pattern[j % len(cfg.layer_pattern)]
        _check_slot(slot)
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.dh)
        caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
                      if slot.mixer == "attn" else {})
    return caches


@torch.inference_mode()
def prefill(model: CausalLM, tokens, cfg: ModelConfig, cache_len: int):
    """tokens (B,S) -> (last-position logits (B,V), caches for decode)."""
    x = model.embed(tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for layer in model.layers:
        x, cache = layer.prefill(x, cfg, positions, cache_len)
        caches.append(cache)
    # The norm is per position: normalizing the last alone is the same.
    x = model.final_norm(x[:, -1:, :], cfg)
    return model.embed.logits(x, cfg)[:, 0, :], caches


@torch.inference_mode()
def decode_step(model: CausalLM, token, caches, pos: int, cfg: ModelConfig):
    """token (B,1) int; ``pos`` the position it takes -> (logits (B,V),
    the caches, written in place)."""
    x = model.embed(token, cfg)
    for layer, cache in zip(model.layers, caches):
        x, _ = layer.decode(x, cfg, cache, pos)
    x = model.final_norm(x, cfg)
    return model.embed.logits(x, cfg)[:, 0, :], caches

