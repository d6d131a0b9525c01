"""AdamW over the parameter tree: dtype-configurable moments, in place.

The reference's update (its ``optim/adamw.py``), computed in float32
whatever the storage dtypes, and stored back in the parameter's dtype
and ``moment_dtype``.  The port writes the results into the parameter
and moment tensors in place, one leaf at a time under
``torch.no_grad()``, and each leaf in slices of at most
``CHUNK_ELEMENTS`` along its first axis, so the float32 temporaries stay
a few hundred MB whatever the model's size.

:func:`clip_by_global_norm` returns the clip's scale and the norm, not
clipped gradients: :func:`adamw_update` multiplies each slice by the
scale as it reads it.  The reference's clip builds a float32 copy of
the whole gradient tree, 12.3 GB at 3.08 B parameters.
"""

from __future__ import annotations

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.models.meta import torch_dtype
from repro_torch.tree import leaves, map_tree

# Elements of one float32 slice (256 MiB): a period slice of a stacked
# expert weight at full width is 201 M elements.
CHUNK_ELEMENTS = 1 << 26


def _slices(t: torch.Tensor):
    """Views of ``t`` along its first axis, each at most CHUNK_ELEMENTS
    (a row wider than that is one slice)."""
    if t.dim() == 0 or t.numel() <= CHUNK_ELEMENTS:
        yield t
        return
    rows = max(1, CHUNK_ELEMENTS // max(t[0].numel(), 1))
    for i in range(0, t.shape[0], rows):
        yield t[i:i + rows]


def adamw_init(params, cfg: OptimizerConfig):
    """{"m", "v": zeros of the parameters' shapes in ``moment_dtype``,
    "step": int32 0}, on the parameters' device."""
    mdt = torch_dtype(cfg.moment_dtype)
    dev = leaves(params)[0][1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(scale, gnorm): the global L2 norm of the float32 gradients and
    min(1, max_norm / gnorm), 0-dim float32 tensors on the gradients'
    device.  Pass ``scale`` to :func:`adamw_update` as ``grad_scale``."""
    gsq = 0
    for _, g in leaves(grads):
        gsq = gsq + sum(torch.sum(torch.square(s.float())) for s in _slices(g))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return scale, gnorm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig, lr, grad_scale=None):
    """One AdamW step, in place: ``params`` and ``state["m"]``,
    ``state["v"]`` are overwritten, ``state["step"]`` incremented.
    ``lr`` is a scalar (scheduled outside); the gradients are multiplied
    by ``grad_scale`` (from :func:`clip_by_global_norm`) where given.
    Returns (params, state), the same objects."""
    flat = [leaves(t) for t in (params, grads, state["m"], state["v"])]
    if len({len(f) for f in flat}) != 1:
        raise ValueError(f"{len(flat[1])} gradients and {len(flat[2])} moments "
                         f"for {len(flat[0])} parameters")
    for (path, p), (gpath, g) in zip(flat[0], flat[1]):
        if path != gpath or p.shape != g.shape:
            raise ValueError(f"gradient {gpath} {tuple(g.shape)} does not match "
                             f"parameter {path} {tuple(p.shape)}")
    state["step"] += 1
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = state["step"].float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for (_, p), (_, g), (_, m), (_, v) in zip(*flat):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            gf = gs.float()
            if grad_scale is not None:
                gf = gf * grad_scale
            mf = ms.float() * b1 + gf * (1 - b1)
            vf = vs.float() * b2 + gf * gf * (1 - b2)
            mhat = mf / c1
            vhat = vf / c2
            pf = ps.float()
            pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf)
            ps.copy_(pf)
            ms.copy_(mf)
            vs.copy_(vf)
    return params, state
