"""K2 and K3: splitter ranks per tile (step 6), fused with the per-tile
bucket counts (step 7) in K2.

:func:`splitter_ranks` and :func:`splitter_partition` are the plain
PyTorch versions and keep the JAX package's counting formulation
(``_lt_matrix`` summed over the tile), so they hold for unsorted tiles
too.  :func:`splitter_partition_cuda` wraps the CUDA kernel K2
(``csrc/splitter_partition.cu``), which binary-searches each splitter in
its sorted tile; :func:`splitter_ranks_cuda` wraps K3
(``csrc/splitter_ranks.cu``), which counts like the plain version and so
takes any tiles and any splitters.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import as_words

LAUNCHES = _build.LaunchCounter("splitter_partition")
RANKS_LAUNCHES = _build.LaunchCounter("splitter_ranks")

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


def splitter_ranks(keys, vals, sp_keys, sp_vals):
    """Plain version of K3 (counting; any tiles and splitters).

    Args:
        keys/vals: (m, T) int32 key words (tensor or tuple) and payloads.
        sp_keys/sp_vals: (m, S) per-tile splitters, same key structure.
    Returns:
        ranks (m, S) int32: elements of tile i lexicographically below
        splitter (i, j).
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    m, t = vals.shape
    s = sp_vals.shape[1]
    if m == 0:
        return torch.zeros((0, s), dtype=torch.int32, device=vals.device)
    step = max(1, _PLAIN_CHUNK // max(t * s, 1))
    return torch.cat([
        _lt_matrix(
            tuple(w[i:i + step] for w in words), vals[i:i + step],
            tuple(w[i:i + step] for w in sp_words), sp_vals[i:i + step],
        ).sum(dim=1, dtype=torch.int32)
        for i in range(0, m, step)
    ])


def splitter_partition(keys, vals, sp_keys, sp_vals):
    """Plain version of K2 (counting; any tiles, sorted or not).

    Returns:
        ranks (m, S) int32 as :func:`splitter_ranks`; counts (m, S+1)
        int32: size of bucket j in tile i (sums to T).
    """
    ranks = splitter_ranks(keys, vals, sp_keys, sp_vals)
    return ranks, counts_from_ranks(ranks, vals.shape[1])


def partition_block_rows(m: int) -> int:
    """Tiles one K2 CTA takes for m tiles (the kernel masks the edge)."""
    return max(1, min(_TILES_PER_CTA, m))


def _lib(name: str, pointers: int, ints: int) -> ctypes.CDLL:
    """Library of K2 or K3, whose C functions take (int nw, pointers,
    long long m, ints, stream)."""
    lib = _build.library(name)
    fn = getattr(lib, f"repro_{name}")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * pointers + [ctypes.c_longlong] + [
            ctypes.c_int] * ints + [p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(kernel: str, words, vals, sp_words, sp_vals):
    """(nw, m, T, S) of a kernel call; raises ValueError for tensors the
    kernels do not take."""
    nw = len(words)
    if nw not in (1, 2) or len(sp_words) != nw:
        raise ValueError(
            f"{kernel} takes 1 or 2 key words on both sides, got "
            f"{nw} and {len(sp_words)}"
        )
    m, t = vals.shape
    s = sp_vals.shape[1]
    for x, shape in [(x, (m, t)) for x in words + (vals,)] + [
        (x, (m, s)) for x in sp_words + (sp_vals,)
    ]:
        if not x.is_cuda or x.device != vals.device:
            raise ValueError(f"{kernel} takes CUDA tensors on one device")
        if x.dtype != torch.int32 or x.shape != shape or not x.is_contiguous():
            raise ValueError(
                f"{kernel} takes contiguous int32 {shape} tensors, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
    if m >= 2**31:
        raise ValueError(f"{kernel} takes fewer than 2^31 tiles, got {m}")
    return nw, m, t, s


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
    nw, m, t, s = _check_cuda_args("splitter partition", words, vals,
                                   sp_words, sp_vals)
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
    lib = _lib("splitter_partition", 8, 3)
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


def splitter_ranks_cuda(keys, vals, sp_keys, sp_vals):
    """Launch K3 on CUDA tensors: the rank of each splitter in each tile
    by counting, so tiles and splitters may be in any order.

    Args/Returns: as :func:`splitter_ranks`.
    Raises:
        ValueError: for tensors the kernel does not take.
        RuntimeError: when the launch fails.
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    nw, m, t, s = _check_cuda_args("splitter ranks", words, vals, sp_words,
                                   sp_vals)
    ranks = torch.empty((m, s), dtype=torch.int32, device=vals.device)
    if m == 0 or s == 0:
        return ranks
    lib = _lib("splitter_ranks", 7, 2)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_splitter_ranks(
            nw, *_build.word_ptrs(words + (vals,)),
            *_build.word_ptrs(sp_words + (sp_vals,)),
            ranks.data_ptr(), m, t, s, stream,
        )
    _build.check(lib, err, "splitter_ranks")
    RANKS_LAUNCHES.add()
    return ranks
