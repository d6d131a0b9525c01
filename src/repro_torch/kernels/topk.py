"""K4: row-wise top-k of descending-codec key words (MoE router, sampling).

:func:`topk_desc` is the plain PyTorch version: the JAX package's
``kernels/topk.py`` body, a bitonic sort of each row on (*words, column
index) (``bitonic.bitonic_network_rows``) and its first k columns.
:func:`topk_desc_cuda` wraps the CUDA kernel (``csrc/topk.cu``), which
runs K1's register network from the shared ``csrc/bitonic_network.cuh``
with the launch geometry of :func:`topk_geometry`, makes the column
index itself and stores only the first k of each row.

Keys are one or two biased int32 word tensors in the descending codec
(``ops.topk`` encodes), so the k smallest words are the k highest
scores, ties toward the smaller column.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import (
    _CTA_ELEMENTS,
    MAX_TILE,
    as_words,
    bitonic_network_rows,
    like_words,
    register_launch,
)

LAUNCHES = _build.LaunchCounter("topk")


def topk_desc(keys, k: int):
    """Plain version of K4: per row of (R, C) words (C a power of two),
    the k smallest keys on (*words, column) and their columns.

    Returns:
        (top keys (R, k) in the input structure, top columns (R, k) int32).
    """
    words = as_words(keys)
    r, c = words[0].shape
    idx = torch.arange(c, dtype=torch.int32, device=words[0].device).expand(r, c)
    sw, si = bitonic_network_rows(words, idx)
    return like_words(tuple(w[:, :k] for w in as_words(sw)), keys), si[:, :k]


def rows_per_cta(r: int, c: int) -> int:
    """Rows of width c one K4 CTA sorts: about ``_CTA_ELEMENTS`` elements,
    no more rows than the next power of two above r (the kernel masks
    the last CTA's extra rows)."""
    rows = max(_CTA_ELEMENTS // c, 1)
    while rows > 1 and rows // 2 >= r:
        rows //= 2
    return rows


class TopkGeometry(NamedTuple):
    """K4's launch: ``threads`` of ``items`` consecutive elements each
    sort ``rows`` rows a CTA, with ``shared_bytes`` of dynamic shared
    memory (K1's exchange, none when a row fits one warp's registers)."""

    threads: int
    items: int
    rows: int
    shared_bytes: int


def topk_geometry(r: int, c: int, nw: int) -> TopkGeometry:
    """K4's launch for r rows of C (a power of two in [1, MAX_TILE]) and
    nw key words: :func:`rows_per_cta` rows a CTA, laid out as K1's
    (``bitonic.register_launch``)."""
    rows = rows_per_cta(r, c)
    threads, items, shared = register_launch(rows * c, c, nw)
    return TopkGeometry(threads, items, rows, shared)


def _lib() -> ctypes.CDLL:
    lib = _build.library("topk")
    fn = lib.repro_topk
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 5 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib


def topk_desc_cuda(keys, k: int):
    """Launch K4 on CUDA tensors.

    Args:
        keys: (R, C) contiguous int32 word tensor or tuple of 1-2 of
            them; C a power of two <= ``MAX_TILE``.
        k: 1 <= k <= C.
    Returns:
        As :func:`topk_desc`.
    Raises:
        ValueError: for tensors or a k the kernel does not take.
        RuntimeError: when the launch fails.
    """
    words = as_words(keys)
    nw = len(words)
    if nw not in (1, 2):
        raise ValueError(f"top-k takes 1 or 2 key words, got {nw}")
    r, c = words[0].shape
    for w in words:
        if not w.is_cuda or w.device != words[0].device:
            raise ValueError("top-k kernel takes CUDA tensors on one device")
        if w.dtype != torch.int32 or w.shape != (r, c) or not w.is_contiguous():
            raise ValueError(
                f"top-k takes contiguous int32 ({r}, {c}) tensors, got "
                f"{w.dtype} {tuple(w.shape)}"
            )
    if c < 1 or c & (c - 1) or c > MAX_TILE:
        raise ValueError(f"row width {c} must be a power of two in [1, {MAX_TILE}]")
    if not 1 <= k <= c:
        raise ValueError(f"top-k needs 1 <= k <= {c}, got {k}")
    dev = words[0].device
    out = [torch.empty((r, k), dtype=torch.int32, device=dev)
           for _ in range(nw + 1)]
    if r == 0:
        return like_words(tuple(out[:-1]), keys), out[-1]
    g = topk_geometry(r, c, nw)
    if -(-r // g.rows) >= 2**31:
        raise ValueError(f"top-k takes fewer than 2^31 CTAs of rows, got {r} rows")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        second = (lambda ts: ts[1].data_ptr() if nw == 2 else None)
        err = lib.repro_topk(
            nw, words[0].data_ptr(), second(words), out[0].data_ptr(),
            second(out), out[-1].data_ptr(), r, c, g.rows, k, g.threads,
            g.items, g.shared_bytes, stream,
        )
    _build.check(lib, err, "topk")
    LAUNCHES.add()
    return like_words(tuple(out[:-1]), keys), out[-1]
