"""Parameter templates: the one source of shapes, dtypes and init kinds.

A model describes its parameters as a nested dict of ``ParamMeta``
leaves, the JAX package's templates leaf for leaf (the decoder's layers
stacked per period on a leading axis).  :func:`init_params` draws them
on a device; :class:`ParamModule` holds a template's tensors as
parameters named after its leaves, which the model's modules extend.

Trainable parameters: the per-layer views are the autograd leaves.  A
layer's parameter is a view of its period's slice of the stacked tensor
(an ``nn.Parameter`` made from a view shares its storage), so the
weights exist once, in the stacked tree that the optimizer and the
checkpoint see, shaped as the reference's.  Its gradient is written
into a view of a stacked gradient tensor that the training step binds
to ``.grad`` beforehand (autograd accumulates into an existing ``.grad``
in place), and the optimizer's moments are stacked tensors as well, so
an in-place update of a stacked leaf writes through to every layer.
The parameters are created with ``requires_grad=False``: serving keeps
no gradient and the same memory; a trainer calls
``model.requires_grad_(True)`` (``launch/steps.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.kernels.ops import resolve_device
from repro_torch.tree import leaves

# Elements of one float32 draw in :func:`init_params` (1 GiB): a period
# slice of the largest stacked weight fits, the whole stack never does.
DRAW_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axes, len == len(shape)
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones | small
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def tree_map_meta(f, template):
    """f over every ParamMeta leaf of a nested dict, keeping its structure."""
    if is_meta(template):
        return f(template)
    return {k: tree_map_meta(f, v) for k, v in template.items()}


def tree_leaves(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf of a nested dict, keys in sorted order
    (the order ``jax.tree.flatten`` gives a dict)."""
    return leaves(tree, prefix)


def count_params(template) -> int:
    return sum(math.prod(m.shape) for _, m in tree_leaves(template))


def init_scale(m: ParamMeta) -> float:
    """The reference's scale: ``m.scale``, else 1/sqrt(shape[0]) (for a
    weight stacked per period that is the number of periods, not the
    input width: ROADMAP.md Queue 3 R7), and 0.02 for "small"."""
    if m.init == "small":
        return 0.02
    if m.scale is not None:
        return m.scale
    fan_in = m.shape[0] if m.shape else 1
    return 1.0 / max(fan_in, 1) ** 0.5


def _materialize(m: ParamMeta, generator: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(m.dtype)
    if m.init == "zeros":
        return torch.zeros(m.shape, dtype=dt, device=device)
    if m.init == "ones":
        return torch.ones(m.shape, dtype=dt, device=device)
    if m.init not in ("normal", "small"):
        raise ValueError(f"unknown init kind {m.init!r}")
    scale = init_scale(m)
    out = torch.empty(m.shape, dtype=dt, device=device)
    flat = out.view(-1, *m.shape[1:]) if m.shape else out.view(1)
    inner = math.prod(m.shape[1:])
    rows = max(1, DRAW_ELEMENTS // max(inner, 1))
    for i in range(0, flat.shape[0], rows):
        blk = flat[i:i + rows]
        draw = torch.randn(blk.shape, generator=generator, device=device,
                           dtype=torch.float32)
        blk.copy_(draw.mul_(scale))  # the reference's f32 product, then cast
    return out


def init_params(template, generator: torch.Generator, device=None) -> dict:
    """Materialize a template on ``device`` (None = "cuda", raising
    without CUDA; "cpu" for the host), leaf by leaf in sorted key
    order, float32 normal draws from ``generator`` (which must live on
    ``device``) times :func:`init_scale`, cast to the leaf's dtype.

    A leaf is drawn ``DRAW_ELEMENTS`` at a time along its first axis
    (a period slice of a stacked weight), so no float32 copy of a large
    leaf, let alone of the model, is ever held; nothing goes through the
    host.  The draws are torch's, not ``jax.random``'s: the same template
    and seed give other values than the reference (tests bring the
    reference's values across with ``interop.params_from_jax``).
    """
    device = resolve_device(device)
    out = {}
    for path, m in tree_leaves(template):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _materialize(m, generator, device)
    return out


class ParamModule(nn.Module):
    """Parameters named after a template's leaves (a nested dict becomes
    a child module), taken from ``tensors`` (same structure, shapes and
    dtypes; views are kept as views, sharing the tensors' storage).
    Indexing (``p["w"]``, ``"bq" in p``) reads like the reference's
    parameter dicts, so the plain functions take a module or a dict
    alike.  The parameters start with ``requires_grad=False`` (serving);
    ``requires_grad_(True)`` makes them trainable."""

    def __init__(self, template: dict, tensors: dict):
        super().__init__()
        for name, t in template.items():
            sub = tensors[name]
            if not is_meta(t):
                self.add_module(name, ParamModule(t, sub))
                continue
            if tuple(sub.shape) != t.shape or sub.dtype != torch_dtype(t.dtype):
                raise ValueError(
                    f"parameter {name!r}: got {tuple(sub.shape)} {sub.dtype}, "
                    f"template {t.shape} {t.dtype}")
            self.register_parameter(name, nn.Parameter(sub, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules
