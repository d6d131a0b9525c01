"""State that crosses between the JAX package and the port.

A sort has no weights: what crosses is the canonical key words and the
plan.  The JAX package carries words as uint32, the port as biased
int32 (``w ^ 0x80000000``); numpy is the common ground.  A model's
weights cross as the JAX package's parameter tree of numpy arrays
(:func:`params_from_jax`, :func:`params_to_jax`), and a train state as
its ``(params, opt_state)`` trees (:func:`train_state_from_jax`,
:func:`opt_state_from_jax`, :func:`opt_state_to_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import get, leaves, map_tree

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


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tensor_from_numpy(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A float numpy array (bfloat16 included) cast to ``dtype`` in a
    tensor on ``device``, one slice of its first axis at a time."""
    out = torch.empty(arr.shape, dtype=dtype, device=device)
    for i, dst in enumerate(out if out.dim() > 1 else (out,)):
        part = arr[i] if out.dim() > 1 else arr
        dst.copy_(torch.from_numpy(np.array(part, np.float32)))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """float32 and integer tensors as they are, bfloat16 widened to
    float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _param_tree_from_jax(tree, cfg, device, dtype=None) -> dict:
    """The JAX package's parameter tree (numpy leaves) as tensors on
    ``device``, each in the template's dtype or ``dtype``."""
    from repro_torch.models import api
    from repro_torch.models.meta import torch_dtype, tree_leaves

    params = {}
    for path, m in tree_leaves(api.template(cfg)):
        arr = get(tree, path)
        if tuple(arr.shape) != m.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, template {m.shape}")
        _put(params, path, _tensor_from_numpy(
            arr, dtype if dtype is not None else torch_dtype(m.dtype), device))
    return params


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
    from repro_torch.models.transformer import CausalLM

    return CausalLM(cfg, _param_tree_from_jax(tree, cfg, resolve_device(device)))


def params_to_jax(model) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX package's
    parameter tree of numpy arrays, the layers stacked per period again.
    float32 leaves come back as float32, bfloat16 ones widened to float32
    (exact)."""
    tree, stacks = {}, {}
    for path, period, p in model.param_slices():
        if period is None:
            _put(tree, path, _to_numpy(p))
        else:
            stacks.setdefault(path, []).append(_to_numpy(p))
    for path, parts in stacks.items():
        _put(tree, path, np.stack(parts))
    return tree


def opt_state_from_jax(opt_state, cfg, device=None) -> dict:
    """The JAX package's ``adamw_init`` state (``{"m", "v", "step"}``,
    numpy leaves) as the port's: ``m`` and ``v`` trees of tensors in the
    arrays' own dtype ("float32" or "bfloat16", the moment dtype) on
    ``device`` (None = "cuda"), ``step`` an int32 0-dim tensor."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.meta import torch_dtype

    device = resolve_device(device)
    mdt = torch_dtype(str(leaves(opt_state["m"])[0][1].dtype))
    return {"m": _param_tree_from_jax(opt_state["m"], cfg, device, mdt),
            "v": _param_tree_from_jax(opt_state["v"], cfg, device, mdt),
            "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_jax(opt_state) -> dict:
    """The inverse of :func:`opt_state_from_jax`: numpy leaves, bfloat16
    moments widened to float32 (exact), ``step`` an int32 0-dim array."""
    return {"m": map_tree(_to_numpy, opt_state["m"]),
            "v": map_tree(_to_numpy, opt_state["v"]),
            "step": np.asarray(int(opt_state["step"]), np.int32)}


def train_state_from_jax(params, opt_state, cfg, device=None):
    """The port's train state ``(params, opt_state)`` from the JAX
    package's (numpy leaves): the stacked parameter tree in the
    template's dtypes, which ``CausalLM(cfg, params)`` and
    ``launch.steps.build_train_step`` view, and the optimizer state of
    :func:`opt_state_from_jax`, both on ``device`` (None = "cuda")."""
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    return (_param_tree_from_jax(params, cfg, device),
            opt_state_from_jax(opt_state, cfg, device))
