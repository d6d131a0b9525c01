"""LR schedules."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step: int, lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_ratio * lr``
    at ``total_steps``: the reference's float32 arithmetic, op for op, on
    a host scalar.  Returns a 0-dim float32 CPU tensor."""
    s = torch.tensor(step, dtype=torch.float32)
    warm = lr * s / max(warmup_steps, 1)
    prog = torch.clamp(
        (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
