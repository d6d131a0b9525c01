"""Int8 gradient compression with error feedback (DP all-reduce trick).

Each gradient leaf is quantized to int8 with a per-leaf float32 scale,
and the quantization residual kept to be added into the next step's
gradient (error feedback, Seide et al. 2014 / Karimireddy et al. 2019):
the reference's arithmetic, leaf for leaf.  The reference's
``allreduce_compressed`` needs a process group and waits for ROADMAP.md
Queue 1 item 12e.
"""

from __future__ import annotations

import torch

from repro_torch.tree import map_tree


def compress_grads_int8(grads, residual=None):
    """grads -> (q int8 tree, scales tree of 0-dim float32, new residual
    tree of float32)."""

    def comp(g, r):
        gf = g.float() + r
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        res = gf - q.float() * scale
        return q, scale, res

    if residual is None:
        residual = map_tree(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
    out = map_tree(comp, grads, residual)
    q = map_tree(lambda _, t: t[0], grads, out)
    s = map_tree(lambda _, t: t[1], grads, out)
    r = map_tree(lambda _, t: t[2], grads, out)
    return q, s, r


def decompress_grads_int8(q, scales):
    return map_tree(lambda qq, ss: qq.float() * ss, q, scales)
