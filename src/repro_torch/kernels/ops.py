"""Kernel dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the kernel's plain PyTorch version.  There
is no fallback from one to the other, and no other device is taken.

Keys are one or two biased int32 word tensors (``core/key_codec``),
most significant first, or a bare tensor for one word; payloads int32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitonic as _bitonic
from repro_torch.kernels import splitter as _splitter
from repro_torch.kernels.bitonic import as_words, like_words, take_samples

COUNTERS = (_bitonic.LAUNCHES, _splitter.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.reset()


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def sort_tiles(keys, vals: torch.Tensor):
    """Sort each row of (m, T) on (*words, payload); T a power of two.

    Returns:
        (sorted keys in the input structure, sorted vals).
    """
    if _on_cuda(vals):
        return _bitonic.sort_tiles_kv(keys, vals)
    return _bitonic.bitonic_network_rows(keys, vals)


def sort_tiles_sample(keys, vals: torch.Tensor, *, num_samples: int):
    """Sorted (m, T) tiles plus s equidistant samples per tile.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s)).
    """
    if _on_cuda(vals):
        return _bitonic.sort_tiles_sample_kv(keys, vals, num_samples=num_samples)
    sk, sv = _bitonic.bitonic_network_rows(keys, vals)
    sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
    return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)


def splitter_partition(keys, vals, sp_keys, sp_vals):
    """Splitter ranks (m, S) and bucket counts (m, S+1) per tile.  On CUDA
    the tiles must be sorted (see ``splitter.splitter_partition_cuda``)."""
    if _on_cuda(vals):
        return _splitter.splitter_partition_cuda(keys, vals, sp_keys, sp_vals)
    return _splitter.splitter_partition(keys, vals, sp_keys, sp_vals)
