"""State that crosses between the JAX package and the port.

A sort has no weights: what crosses is the canonical key words and the
plan.  The JAX package carries words as uint32, the port as biased
int32 (``w ^ 0x80000000``); numpy is the common ground.  A model's
weights cross as the JAX package's parameter tree of numpy arrays
(:func:`params_from_jax`, :func:`params_to_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = np.uint32(0x80000000)


def words_from_numpy(words) -> tuple[torch.Tensor, ...]:
    """uint32 canonical words (array or sequence of arrays, msw first)
    -> biased int32 CPU tensors."""
    if isinstance(words, np.ndarray):
        words = (words,)
    return tuple(
        torch.from_numpy((np.asarray(w, np.uint32) ^ _BIAS).view(np.int32))
        for w in words
    )


def words_to_numpy(words) -> tuple[np.ndarray, ...]:
    """Biased int32 tensors -> uint32 canonical words as numpy arrays."""
    if isinstance(words, torch.Tensor):
        words = (words,)
    return tuple(
        w.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
        ^ _BIAS
        for w in words
    )


def _node_tree(node) -> tuple | None:
    if node is None:
        return None
    return (
        node.kind, node.rows, node.length, node.lp, node.tile, node.s,
        node.m, node.s_round, node.cap, node.fuse_ranking,
        node.fuse_sampling, node.strategy, node.radix_bits, node.merge_run,
        _node_tree(node.sample_plan), _node_tree(node.bucket_plan),
    )


def plan_tree(plan) -> tuple:
    """Nested tuple of a plan's algorithmic fields: (rows, length,
    num_words, root) with each node as (kind, rows, length, lp, tile, s,
    m, s_round, cap, fuse_ranking, fuse_sampling, strategy, radix_bits,
    merge_run, sample subtree, bucket subtree).

    Works on this package's :class:`SortPlan` and, field for field, on
    the JAX package's plans, so the two can be compared for equality.
    """
    return (plan.rows, plan.length, plan.num_words, _node_tree(plan.root))


def shard_plan_tree(plan) -> tuple:
    """Nested tuple of a shard plan's algorithmic fields: (axis, d,
    n_local, n_pad, oversample, pair_align, s_loc, b_t, c_pair, out_cap,
    dtype_name, num_words, descending) and the :func:`plan_tree` of its
    run, dealt, sample and bucket plans.

    Works on this package's ``ShardPlan`` and on the JAX package's, so the
    two can be compared for equality (the config fingerprints, which hash
    each package's own config fields, are left out).
    """
    return (
        tuple(plan.axis), plan.d, plan.n_local, plan.n_pad, plan.oversample,
        plan.pair_align, plan.s_loc, plan.b_t, plan.c_pair, plan.out_cap,
        plan.dtype_name, plan.num_words, plan.descending,
        *(plan_tree(getattr(plan, name)) for name in
          ("run_plan", "dealt_plan", "sample_plan", "bucket_plan")),
    )


def params_from_jax(tree, cfg, device=None):
    """The port's model (``models.transformer.CausalLM``) holding the JAX
    package's parameters: ``tree`` is its ``api.template(cfg)`` tree with
    numpy arrays (any float dtype numpy holds, bfloat16 included) as
    leaves.  Each leaf is cast to the template's dtype into a tensor
    allocated on ``device`` (None = "cuda", raising without CUDA), one
    slice of its first axis (a period, for the stacked layers) at a time;
    the layers then view their period's slice, as a model from
    ``api.init_model`` does.
    """
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import api
    from repro_torch.models.meta import torch_dtype, tree_leaves
    from repro_torch.models.transformer import CausalLM

    device = resolve_device(device)
    params = {}
    for path, m in tree_leaves(api.template(cfg)):
        arr = tree
        for k in path:
            arr = arr[k]
        if tuple(arr.shape) != m.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, template {m.shape}")
        out = torch.empty(m.shape, dtype=torch_dtype(m.dtype), device=device)
        for i, dst in enumerate(out if out.dim() > 1 else (out,)):
            part = arr[i] if out.dim() > 1 else arr
            dst.copy_(torch.from_numpy(np.array(part, np.float32)))
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = out
    return CausalLM(cfg, params)


def params_to_jax(model) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX package's
    parameter tree of numpy arrays, the layers stacked per period again.
    float32 leaves come back as float32, bfloat16 ones widened to float32
    (exact)."""
    from repro_torch.models.transformer import lm_template
    from repro_torch.models.meta import tree_leaves

    cfg = model.cfg
    pat = len(cfg.layer_pattern)

    def numpy(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = {}
    for path, _ in tree_leaves(lm_template(cfg)):
        if path[0] == "period":
            slot = int(path[1][len("slot"):])
            layers = model.layers[slot::pat]
            leaf = np.stack([numpy(layer.get_parameter(".".join(path[2:])))
                             for layer in layers])
        else:
            leaf = numpy(model.get_parameter(".".join(path)))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
