"""K2 and K3: splitter ranks per tile (step 6), fused with the per-tile
bucket counts (step 7) in K2.

:func:`splitter_ranks` and :func:`splitter_partition` are the plain
PyTorch versions and keep the JAX package's counting formulation
(``_lt_matrix`` summed over the tile), so they hold for unsorted tiles
too.  :func:`splitter_partition_cuda` wraps the CUDA kernel K2
(``csrc/splitter_partition.cu``), which searches each splitter in its
sorted tile through a coarse index; :func:`splitter_ranks_cuda` wraps K3
(``csrc/splitter_ranks.cu``), which searches each element among its
tile's splitters and so takes any tiles and any splitters.  Their launch
geometry is pure Python (:func:`partition_geometry`,
:func:`ranks_geometry`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import as_words

LAUNCHES = _build.LaunchCounter("splitter_partition")
RANKS_LAUNCHES = _build.LaunchCounter("splitter_ranks")

# Tiles one K2 CTA partitions at most, one to eight warps each.
_TILES_PER_CTA = 4
# K2's window, one 128-byte line of int32 per word array, and the
# splitters a warp searches at once (kBatch in splitter_partition.cu).
_WINDOW = 32
_WARP_SPLITTERS = 8
# Shared memory one CTA may take on the H100 (227 KB).
_SMEM_LIMIT = 232_448
# K3: threads a CTA at most and contiguous elements a thread takes per
# slab (kMaxThreads and kRun in splitter_ranks.cu), and the CTAs that
# fill the card's 132 SMs a few deep, below which a tile is split.
_RANKS_THREADS = 256
_RANKS_RUN = 16
_FILL_CTAS = 4 * 132
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
    """Tiles one K2 CTA takes at most for m tiles (the kernel masks the
    edge)."""
    return max(1, min(_TILES_PER_CTA, m))


def partition_geometry(m: int, t: int, s: int, nw: int):
    """K2's launch for m tiles of t >= 1 elements, s >= 1 splitters and
    nw key words: (tiles per CTA, warps per tile, window W, coarse
    entries G per tile, dynamic shared-memory bytes).

    A warp searches 8 splitters at a time, so a tile takes up to eight
    warps; a CTA at most 256 threads.  Shared memory holds each tile's
    coarse index (the last of every W elements, packed: 8 bytes, 12 with
    two words) and its s ranks.

    Raises:
        ValueError: when one tile's share exceeds the 227 KB a CTA may
            have (s in the tens of thousands).
    """
    window = min(_WINDOW, t)
    groups = -(-t // window)
    warps = min(-(-s // _WARP_SPLITTERS), 8)
    per_tile = (8 + 4 * (nw == 2)) * groups + 4 * s
    tiles = min(partition_block_rows(m), 8 // warps, _SMEM_LIMIT // per_tile)
    if tiles < 1:
        raise ValueError(
            f"splitter partition of T={t}, S={s}, {nw} word(s) needs "
            f"{per_tile} bytes of shared memory a tile, above {_SMEM_LIMIT}"
        )
    return tiles, warps, window, groups, tiles * per_tile


def ranks_geometry(m: int, t: int):
    """K3's launch for m >= 1 tiles of t >= 1 elements: (split, part_len,
    threads).

    CTA b takes part b % split of tile b // split, elements
    [part * part_len, min(t, (part + 1) * part_len)), in slabs of
    threads * 16; thread x takes elements [x * 16, x * 16 + 16) of each
    slab.  A tile is split only when m tiles are too few CTAs to fill the
    card; part_len is a multiple of 16, so the kernel's 16-byte copies stay
    aligned.
    """
    split = 1
    if m < _FILL_CTAS:
        split = max(1, min(-(-_FILL_CTAS // m),
                           t // (_RANKS_THREADS * _RANKS_RUN)))
    part_len = -(-t // split)
    part_len += -part_len % _RANKS_RUN
    split = -(-t // part_len)
    # No more threads than the part has runs of 16, and at least a warp.
    threads = min(_RANKS_THREADS,
                  max(32, 1 << (-(-part_len // _RANKS_RUN) - 1).bit_length()))
    return split, part_len, threads


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
    ascending on (*words, payload), as K1, K5 and K6 leave it on the
    sort's path.  The kernel searches each splitter in its tile, which
    equals the plain version's count only on sorted tiles; it does not
    check.

    One tile's coarse index and ranks sit in a CTA's shared memory
    (:func:`partition_geometry`), which bounds T and S: at S = 63, T up to
    2^19 with one or two words, far above ``bitonic.MAX_TILE``, the
    widest tile any row sort leaves.

    Args/Returns: as :func:`splitter_partition`.
    Raises:
        ValueError: for tensors the kernel does not take, and for tiles
            whose share of shared memory exceeds 227 KB.
        RuntimeError: when the launch fails.
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    nw, m, t, s = _check_cuda_args("splitter partition", words, vals,
                                   sp_words, sp_vals)
    if s < 1:
        raise ValueError(f"splitter partition takes S >= 1, got {s}")
    if m == 0 or t == 0:
        return (torch.zeros((m, s), dtype=torch.int32, device=vals.device),
                torch.zeros((m, s + 1), dtype=torch.int32, device=vals.device))
    geometry = partition_geometry(m, t, s, nw)
    ranks = torch.empty((m, s), dtype=torch.int32, device=vals.device)
    counts = torch.empty((m, s + 1), dtype=torch.int32, device=vals.device)
    lib = _lib("splitter_partition", 8, 7)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_splitter_partition(
            nw, *_build.word_ptrs(words + (vals,)),
            *_build.word_ptrs(sp_words + (sp_vals,)),
            ranks.data_ptr(), counts.data_ptr(), m, t, s, *geometry, stream,
        )
    _build.check(lib, err, "splitter_partition")
    LAUNCHES.add()
    return ranks, counts


def splitter_ranks_cuda(keys, vals, sp_keys, sp_vals):
    """Launch K3 on CUDA tensors: the rank of each splitter in each tile,
    from a search of each element among the sorted splitters, so tiles
    and splitters may be in any order.

    Args/Returns: as :func:`splitter_ranks`.
    Raises:
        ValueError: for tensors the kernel does not take.
        RuntimeError: when the launch fails.
    """
    words, sp_words = as_words(keys), as_words(sp_keys)
    nw, m, t, s = _check_cuda_args("splitter ranks", words, vals, sp_words,
                                   sp_vals)
    if m == 0 or s == 0 or t == 0:
        return torch.zeros((m, s), dtype=torch.int32, device=vals.device)
    geometry = ranks_geometry(m, t)
    # Parts of a split tile add their partial ranks into zeros.
    ranks = (torch.zeros if geometry[0] > 1 else torch.empty)(
        (m, s), dtype=torch.int32, device=vals.device)
    lib = _lib("splitter_ranks", 7, 5)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_splitter_ranks(
            nw, *_build.word_ptrs(words + (vals,)),
            *_build.word_ptrs(sp_words + (sp_vals,)),
            ranks.data_ptr(), m, t, s, *geometry, stream,
        )
    _build.check(lib, err, "splitter_ranks")
    RANKS_LAUNCHES.add()
    return ranks
