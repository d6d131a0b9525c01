"""K1: row-wise bitonic (key words, payload) sort of (m, T) tiles.

The plain PyTorch version (:func:`bitonic_network_rows`) mirrors the
JAX package's ``kernels/bitonic.py`` network line for line; the CUDA
kernel (``csrc/tile_sort.cu``) sorts the same rows on the card in
registers, with the launch geometry of :func:`row_sort_geometry`.
:func:`sort_tiles_kv` and :func:`sort_tiles_sample_kv` are the kernel's
wrappers: they take CUDA tensors only, launch the kernel and count the
launch; ``kernels/ops.py`` gives CPU tensors the plain version.

Keys are one or two biased int32 word tensors (``core/key_codec``),
most significant first, or a bare tensor for one word; the payload is
int32 and the last word of the comparison.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# Elements one CTA of the kernel should hold: rows of T < 2048 share a
# CTA (direct levels sort rows as narrow as 2).
_CTA_ELEMENTS = 2048
# Widest row the row sorts take: at T = 16384 with two key words K6's
# shared copy of packed keys is 198 KB (227 KB per block).
MAX_TILE = 16384
# Elements a thread of the register-resident kernels (K1, K4, K5, K6);
# twice as many in the one CTA of a row of MAX_TILE, whose 512 threads
# are the kernels' most.
_ITEMS = 16
_MAX_THREADS = 512

LAUNCHES = _build.LaunchCounter("tile_sort")


def as_words(keys) -> tuple[torch.Tensor, ...]:
    """Normalize a key argument (tensor or tuple of tensors) to a tuple."""
    if isinstance(keys, (tuple, list)):
        if not keys:
            raise ValueError("keys must hold at least one word")
        return tuple(keys)
    return (keys,)


def like_words(words, keys):
    """``words`` in the structure of the caller's ``keys``."""
    if isinstance(keys, (tuple, list)):
        return tuple(words)
    return words[0]


def lex_gt(lo_parts, hi_parts) -> torch.Tensor:
    """Elementwise lexicographic ``lo > hi`` over parallel word lists."""
    gt = lo_parts[0] > hi_parts[0]
    eq = lo_parts[0] == hi_parts[0]
    for a, b in zip(lo_parts[1:], hi_parts[1:]):
        gt = gt | (eq & (a > b))
        eq = eq & (a == b)
    return gt


def _row_compare_exchange(parts, d: int, size: int):
    """One compare-exchange pass at stride d within size-blocks along the
    last axis of every tensor in ``parts`` (key words + payload)."""
    c = parts[0].shape[-1]
    lead = parts[0].shape[:-1]
    nb = c // (2 * d)
    r3 = [p.reshape(*lead, nb, 2, d) for p in parts]
    blk = torch.arange(nb, device=parts[0].device).reshape(nb, 1)
    asc = ((2 * blk * d) & size) == 0  # (nb, 1)
    los = [p[..., 0, :] for p in r3]
    his = [p[..., 1, :] for p in r3]
    gt = lex_gt(los, his)
    swap = torch.where(asc, gt, ~gt)
    return tuple(
        torch.stack(
            (torch.where(swap, hi, lo), torch.where(swap, lo, hi)), dim=-2
        ).reshape(*lead, c)
        for lo, hi in zip(los, his)
    )


def bitonic_network_rows(keys, vals):
    """Plain version of K1: bitonic sort along the last axis of (..., C),
    C a power of two, ascending on (*words, payload).

    Returns:
        (sorted keys in the input structure, sorted vals).
    """
    words = as_words(keys)
    c = words[0].shape[-1]
    if c & (c - 1):
        raise ValueError(f"row width {c} must be a power of two")
    parts = words + (vals,)
    size = 2
    while size <= c:
        d = size // 2
        while d >= 1:
            parts = _row_compare_exchange(parts, d, size)
            d //= 2
        size *= 2
    return like_words(parts[:-1], keys), parts[-1]


def take_samples(t: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Sample j of each sorted row of (m, T): element (j+1)*T/s - 1.
    A contiguous (m, s) copy, as the kernels' sample epilogue writes: a
    strided view would reach the next level's row sort, and the kernels
    take contiguous rows only."""
    m, width = t.shape
    return t.reshape(m, num_samples, width // num_samples)[:, :, -1].contiguous()


def largest_pow2_divisor(m: int, limit: int) -> int:
    """Largest power of two that divides ``m`` and is <= ``limit``."""
    b = 1
    while b * 2 <= limit and m % (b * 2) == 0:
        b *= 2
    return b


def effective_block_rows(m: int, t: int) -> int:
    """Rows of width ``t`` one kernel CTA sorts, for ``m`` rows: the
    largest power-of-two divisor of m that keeps the CTA near
    ``_CTA_ELEMENTS`` elements (1 for T >= 2048)."""
    return largest_pow2_divisor(m, max(_CTA_ELEMENTS // t, 1))


class RowSortGeometry(NamedTuple):
    """K1's and K6's launch: ``threads`` of ``items`` consecutive elements
    each sort ``rows`` rows a CTA; K1 takes ``shared_bytes`` of dynamic
    shared memory (its exchange buffer, none when a row fits one warp's
    registers), K6 ``merge_shared_bytes`` (its padded merge copy)."""

    threads: int
    items: int
    rows: int
    shared_bytes: int
    merge_shared_bytes: int


def row_sort_geometry(m: int, t: int, nw: int) -> RowSortGeometry:
    """K1's and K6's launch for m rows of T (a power of two in [2,
    MAX_TILE]) and nw key words.

    A CTA holds E = rows * T elements (``effective_block_rows``), 16 a
    thread, or E / 512 when that is more (32 at E = MAX_TILE), or E when
    that is less.  An element is an 8-byte packed key, plus its 4-byte
    payload with two words.  K1 exchanges through shared memory only the
    strides of 32 * items and more, so it takes E keys when T exceeds
    what one warp holds; K6's copy has one slot of padding per ``items``.
    """
    rows = effective_block_rows(m, t)
    e = rows * t
    threads, items, shared = register_launch(e, t, nw)
    key = 8 if nw == 1 else 12
    return RowSortGeometry(threads, items, rows, shared, (e + e // items) * key)


def register_launch(e: int, t: int, nw: int) -> tuple[int, int, int]:
    """Threads, items a thread and shared bytes of K1's register network
    (``bitonic_sort_regs``, also K4's) for a CTA of e elements in rows of
    t: 16 items a thread, or e / 512 when that is more (32 at e =
    MAX_TILE), or e when that is less; e packed keys of shared exchange
    when a row is wider than one warp's registers hold, else none."""
    items = min(max(_ITEMS, e // _MAX_THREADS), e)
    key = 8 if nw == 1 else 12
    return e // items, items, (e * key if t > 32 * items else 0)


def _lib(source: str, extra_ints: int) -> ctypes.CDLL:
    lib = _build.library(source)
    fn = getattr(lib, f"repro_{source}")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 9 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ] + [ctypes.c_int] * extra_ints + [p]
        fn.restype = ctypes.c_int
    return lib


def launch_row_sort(source: str, counter: _build.LaunchCounter, words, vals,
                    num_samples: int, *extra: int, geometry=None):
    """Check the tensors and launch one of the row-sort kernels, K1
    (``tile_sort``), K5 (``radix_sort``) or K6 (``merge_sort``).

    They share one C interface, ``repro_<source>(nw, k0, k1, v, ok0, ok1,
    ov, sk0, sk1, sv, m, T, rows_per_cta, num_samples, *extra,
    *geometry(m, T, nw), stream)``, and one layout: (m, T) contiguous
    int32 rows, T a power of two in [2, MAX_TILE],
    ``effective_block_rows`` rows per CTA.  ``geometry`` (the kernel's
    launch arguments: :func:`row_sort_geometry`'s for K1 and K6,
    ``radix.radix_geometry``'s for K5) is called after the tensors are
    checked.

    Returns:
        ([sorted words..., sorted vals], [sample words..., sample vals]
        or [] when num_samples is 0).
    """
    nw = len(words)
    if nw not in (1, 2):
        raise ValueError(f"{source} takes 1 or 2 key words, got {nw}")
    m, t = vals.shape
    for x in words + (vals,):
        if not x.is_cuda:
            raise ValueError(f"{source} kernel takes CUDA tensors only")
        if x.dtype != torch.int32 or x.shape != (m, t) or not x.is_contiguous():
            raise ValueError(
                f"{source} takes contiguous int32 ({m}, {t}) tensors, got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        if x.device != vals.device:
            raise ValueError(f"{source} inputs must share one device")
    if t < 2 or t & (t - 1) or t > MAX_TILE:
        raise ValueError(f"tile width {t} must be a power of two in [2, {MAX_TILE}]")
    if num_samples and t % num_samples:
        raise ValueError(f"num_samples {num_samples} must divide T = {t}")
    rows = effective_block_rows(m, t)
    out = [torch.empty_like(x) for x in words + (vals,)]
    samp = [
        torch.empty((m, num_samples), dtype=torch.int32, device=vals.device)
        for _ in range(nw + 1)
    ] if num_samples else []
    if m == 0:
        return out, samp
    if geometry is not None:
        extra += tuple(geometry(m, t, nw))
    lib = _lib(source, len(extra))
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"repro_{source}")(
            nw, *_build.word_ptrs(words + (vals,)), *_build.word_ptrs(out),
            *_build.word_ptrs(samp), m, t, rows, num_samples, *extra, stream,
        )
    _build.check(lib, err, source)
    counter.add()
    return out, samp


def _k1_geometry(m: int, t: int, nw: int) -> tuple[int, int, int]:
    """K1's launch arguments after ``num_samples``: threads, items, shared
    bytes."""
    g = row_sort_geometry(m, t, nw)
    return g.threads, g.items, g.shared_bytes


def sort_tiles_kv(keys, vals: torch.Tensor):
    """Launch K1 on CUDA tensors: sort each row of (m, T) lexicographically.

    Args:
        keys: (m, T) int32 word tensor or tuple of 1-2 of them (msw first).
        vals: (m, T) int32 payloads, unique within each row.
    Returns:
        (sorted keys in the input structure, sorted vals), new tensors.
    Raises:
        ValueError: for tensors the kernel does not take.
        RuntimeError: when the launch fails.
    """
    out, _ = launch_row_sort("tile_sort", LAUNCHES, as_words(keys), vals, 0,
                             geometry=_k1_geometry)
    return like_words(out[:-1], keys), out[-1]


def sort_tiles_sample_kv(keys, vals: torch.Tensor, *, num_samples: int):
    """Launch K1 with the fused sample epilogue on CUDA tensors.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s))
        with keys in the input structure; sample j of row i is sorted
        element (j+1)*T/s - 1.
    """
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    out, samp = launch_row_sort("tile_sort", LAUNCHES, as_words(keys), vals,
                                num_samples, geometry=_k1_geometry)
    return (
        like_words(out[:-1], keys), out[-1],
        like_words(samp[:-1], keys), samp[-1],
    )
