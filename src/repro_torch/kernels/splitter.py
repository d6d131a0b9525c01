"""K2: fused splitter partition (steps 6-7): splitter ranks and per-tile
bucket counts.

:func:`splitter_partition` is the plain PyTorch version and keeps the
JAX package's counting formulation (``_lt_matrix`` summed over the
tile), so it holds for unsorted tiles too.  :func:`splitter_partition_cuda`
is the wrapper of the CUDA kernel (``csrc/splitter_partition.cu``),
which binary-searches each splitter instead.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import as_words

LAUNCHES = _build.LaunchCounter("splitter_partition")

# Tiles one kernel CTA partitions (64 threads each).
_TILES_PER_CTA = 4
# Splitter ranks one CTA keeps in 48 KB of shared memory.
_MAX_SPLITTERS = 48 * 1024 // 4
# Elements of the (rows, T, S) comparison matrix the plain version
# builds at once; it walks the tiles in chunks to stay near this.
_PLAIN_CHUNK = 1 << 26


def _lt_matrix(words, vals, sp_words, sp_vals) -> torch.Tensor:
    """(..., T, S) lexicographic (*words, val) < (*sp_words, sp_val)."""
    parts = words + (vals,)
    sp_parts = sp_words + (sp_vals,)
    lt = parts[0][..., :, None] < sp_parts[0][..., None, :]
    eq = parts[0][..., :, None] == sp_parts[0][..., None, :]
    for a, b in zip(parts[1:], sp_parts[1:]):
        lt = lt | (eq & (a[..., :, None] < b[..., None, :]))
        eq = eq & (a[..., :, None] == b[..., None, :])
    return lt


def counts_from_ranks(ranks: torch.Tensor, t: int) -> torch.Tensor:
    """(m, S+1) bucket sizes of tiles of width t: ends - starts."""
    zero = torch.zeros_like(ranks[:, :1])
    starts = torch.cat([zero, ranks], dim=1)
    ends = torch.cat([ranks, zero + t], dim=1)
    return ends - starts


def splitter_partition(keys, vals, sp_keys, sp_vals):
    """Plain version of K2 (counting; any tiles, sorted or not).

    Args:
        keys/vals: (m, T) int32 key words (tensor or tuple) and payloads.
        sp_keys/sp_vals: (m, S) per-tile splitters, same key structure.
    Returns:
        ranks (m, S) int32: elements of tile i lexicographically below
        splitter (i, j); counts (m, S+1) int32: size of bucket j in tile
        i (sums to T).
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    m, t = vals.shape
    s = sp_vals.shape[1]
    step = max(1, _PLAIN_CHUNK // max(t * s, 1))
    ranks = torch.cat([
        _lt_matrix(
            tuple(w[i:i + step] for w in words), vals[i:i + step],
            tuple(w[i:i + step] for w in sp_words), sp_vals[i:i + step],
        ).sum(dim=1, dtype=torch.int32)
        for i in range(0, m, step)
    ]) if m else torch.zeros((0, s), dtype=torch.int32, device=vals.device)
    return ranks, counts_from_ranks(ranks, t)


def partition_block_rows(m: int) -> int:
    """Tiles one K2 CTA takes for m tiles (the kernel masks the edge)."""
    return max(1, min(_TILES_PER_CTA, m))


def _lib() -> ctypes.CDLL:
    lib = _build.library("splitter_partition")
    fn = lib.repro_splitter_partition
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
        ]
        fn.restype = ctypes.c_int
    return lib


def splitter_partition_cuda(keys, vals, sp_keys, sp_vals):
    """Launch K2 on CUDA tensors.

    PRECONDITION: every tile (row of ``keys``/``vals``) is sorted
    ascending on (*words, payload), as K1 leaves it on the sort's path.
    The kernel binary-searches each splitter in its tile, which equals
    the plain version's count only on sorted tiles; it does not check.

    Args/Returns: as :func:`splitter_partition`.
    Raises:
        ValueError: for tensors the kernel does not take.
        RuntimeError: when the launch fails.
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    nw = len(words)
    if nw not in (1, 2) or len(sp_words) != nw:
        raise ValueError(
            f"splitter partition takes 1 or 2 key words on both sides, got "
            f"{nw} and {len(sp_words)}"
        )
    m, t = vals.shape
    s = sp_vals.shape[1]
    for x, shape in [(x, (m, t)) for x in words + (vals,)] + [
        (x, (m, s)) for x in sp_words + (sp_vals,)
    ]:
        if not x.is_cuda or x.device != vals.device:
            raise ValueError("splitter partition takes CUDA tensors on one device")
        if x.dtype != torch.int32 or x.shape != shape or not x.is_contiguous():
            raise ValueError(
                f"splitter partition takes contiguous int32 {shape} tensors, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
    if not 1 <= s <= _MAX_SPLITTERS:
        raise ValueError(
            f"splitter partition takes 1 <= S <= {_MAX_SPLITTERS}, got {s}"
        )
    # The ranks of a CTA's tiles sit in 48 KB of static-limit shared memory.
    tiles = min(partition_block_rows(m), _MAX_SPLITTERS // s)
    ranks = torch.empty((m, s), dtype=torch.int32, device=vals.device)
    counts = torch.empty((m, s + 1), dtype=torch.int32, device=vals.device)
    if m == 0:
        return ranks, counts
    lib = _lib()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_splitter_partition(
            nw, *_build.word_ptrs(words + (vals,)),
            *_build.word_ptrs(sp_words + (sp_vals,)),
            ranks.data_ptr(), counts.data_ptr(), m, t, s, tiles, stream,
        )
    _build.check(lib, err, "splitter_partition")
    LAUNCHES.add()
    return ranks, counts
