"""K6: merge-path sort of (m, T) rows: bitonic runs, then merge levels.

The "merge" local-sort strategy.  :func:`merge_sort_rows` (with
:func:`_merge_level`) is the plain PyTorch version, the JAX package's
``kernels/merge.py`` body line for line; the CUDA kernel
(``csrc/merge_sort.cu``) sorts the same rows on the card, in K1's
registers and launch geometry (``bitonic.row_sort_geometry``).
:func:`sort_tiles_kv` and :func:`sort_tiles_sample_kv` are the kernel's
wrappers: they take CUDA tensors only, launch the kernel and count the
launch.  :func:`hybrid_sort_rows` / :func:`hybrid_sort_sample_rows`
(with :func:`_bitonic_merge_stage`) are the JAX package's xla stand-ins
for this strategy, ported for parity; no path of the port runs them.

Algorithm per row: runs of ``r0 = min(merge_run, T)`` elements are
sorted with the bitonic network on (*words, payload); then each merge
level merges adjacent run pairs, every output slot finding its source by
a merge-path diagonal search.  The merge levels compare the key words
only and send ties to the left run: a stable sort on the key words, the
strategy contract of ``kernels/radix.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import radix as _radix
from repro_torch.kernels.bitonic import (
    as_words,
    bitonic_network_rows,
    launch_row_sort,
    lex_gt,
    like_words,
    row_sort_geometry,
    take_samples,
)

LAUNCHES = _build.LaunchCounter("merge_sort")


def _check_merge_run(merge_run: int) -> None:
    if not (isinstance(merge_run, int) and merge_run >= 2
            and merge_run & (merge_run - 1) == 0):
        raise ValueError(f"merge_run must be a power of two >= 2, got {merge_run!r}")


def _merge_level(parts, run: int):
    """One merge level: every adjacent pair of sorted length-``run`` runs
    in each (rows, T) row of ``parts`` (key words + payload) merged by a
    merge-path diagonal search.  Key words only, ties to the left run."""
    words, vals = parts[:-1], parts[-1]
    rows, t = words[0].shape
    pairs = t // (2 * run)
    wr = [w.reshape(rows * pairs, 2 * run) for w in words]
    vr = vals.reshape(rows * pairs, 2 * run)
    a_w = [w[:, :run] for w in wr]
    b_w = [w[:, run:] for w in wr]
    p = torch.arange(2 * run, device=vals.device).expand(rows * pairs, 2 * run)

    def probe(side, idx):
        return [torch.gather(w, 1, idx) for w in side]

    # Diagonal binary search: a = the elements taken from A for slot p.
    lo = torch.clamp(p - run, min=0)
    hi = torch.clamp(p, max=run)
    for _ in range((run + 1).bit_length()):
        mid = (lo + hi) >> 1
        bidx = p - mid - 1
        a_v = probe(a_w, torch.clamp(mid, max=run - 1))
        b_v = probe(b_w, torch.clamp(bidx, 0, run - 1))
        take_a = ~lex_gt(a_v, b_v)  # A[mid] <= B[bidx]: ties to A
        take_a = torch.where(bidx >= run, True, take_a)
        take_a = torch.where((mid >= run) | (bidx < 0), False, take_a)
        upd = lo < hi
        lo = torch.where(upd & take_a, mid + 1, lo)
        hi = torch.where(upd & ~take_a, mid, hi)
    a = lo
    b = p - a
    a_v = probe(a_w, torch.clamp(a, max=run - 1))
    b_v = probe(b_w, torch.clamp(b, 0, run - 1))
    take_a = (b >= run) | ((a < run) & ~lex_gt(a_v, b_v))
    src = torch.where(take_a, torch.clamp(a, max=run - 1),
                      run + torch.clamp(b, 0, run - 1))
    return [torch.gather(x, 1, src).reshape(rows, t) for x in wr + [vr]]


def merge_sort_rows(keys, vals: torch.Tensor, *, merge_run: int = 512):
    """Plain version of K6: bitonic-network runs of ``min(merge_run, T)``
    elements, then merge-path levels, on each row of (rows, T).

    Args:
        keys: (rows, T) biased int32 word tensor or tuple (msw first); T
            a power of two.
        vals: (rows, T) int32 payloads (compared only inside the runs).
        merge_run: initial run length r0 (clamped to T).
    Returns:
        (sorted keys in the input structure, payloads moved alongside).
    """
    _check_merge_run(merge_run)
    words = as_words(keys)
    rows, t = words[0].shape
    if t & (t - 1):
        raise ValueError(f"row width {t} must be a power of two")
    r0 = min(merge_run, t)
    if r0 > 1:
        wr, vr = bitonic_network_rows(tuple(w.reshape(-1, r0) for w in words),
                                      vals.reshape(-1, r0))
        words = tuple(w.reshape(rows, t) for w in wr)
        vals = vr.reshape(rows, t)
    parts = list(words) + [vals]
    run = r0
    while run < t:
        parts = _merge_level(parts, run)
        run *= 2
    return like_words(tuple(parts[:-1]), keys), parts[-1]


def _k6_geometry(m: int, t: int, nw: int) -> tuple[int, int, int]:
    """K6's launch arguments after ``merge_run``: K1's threads and items,
    the merge copy's shared bytes."""
    g = row_sort_geometry(m, t, nw)
    return g.threads, g.items, g.merge_shared_bytes


def sort_tiles_kv(keys, vals: torch.Tensor, *, merge_run: int = 512):
    """Launch K6 on CUDA tensors: merge-path sort of each row of (m, T).

    Returns:
        (sorted keys in the input structure, sorted vals), new tensors.
    Raises:
        ValueError: for tensors or a merge_run the kernel does not take.
        RuntimeError: when the launch fails.
    """
    _check_merge_run(merge_run)
    out, _ = launch_row_sort("merge_sort", LAUNCHES, as_words(keys), vals, 0,
                             merge_run, geometry=_k6_geometry)
    return like_words(out[:-1], keys), out[-1]


def sort_tiles_sample_kv(keys, vals: torch.Tensor, *, num_samples: int,
                         merge_run: int = 512):
    """Launch K6 with the sample epilogue of K1 on CUDA tensors.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s)).
    """
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    _check_merge_run(merge_run)
    out, samp = launch_row_sort("merge_sort", LAUNCHES, as_words(keys), vals,
                                num_samples, merge_run, geometry=_k6_geometry)
    return (
        like_words(out[:-1], keys), out[-1],
        like_words(samp[:-1], keys), samp[-1],
    )


def _bitonic_merge_stage(parts, run: int):
    """Merge adjacent sorted run pairs with the bitonic merge network:
    reverse the right run of each pair, then log2(2*run) ascending
    compare-exchange passes on (*words, payload)."""
    rows = parts[0].shape[0]
    width = 2 * run
    rs = []
    for x in parts:
        q = x.reshape(rows, -1, width)
        rs.append(torch.cat([q[:, :, :run], q[:, :, run:].flip(-1)], dim=2))
    d = run
    while d >= 1:
        q3 = [q.reshape(rows, -1, width // (2 * d), 2, d) for q in rs]
        los = [q[..., 0, :] for q in q3]
        his = [q[..., 1, :] for q in q3]
        gt = lex_gt(los, his)
        rs = [
            torch.stack((torch.where(gt, hi, lo), torch.where(gt, lo, hi)),
                        dim=-2).reshape(rows, -1, width)
            for lo, hi in zip(los, his)
        ]
        d //= 2
    t = parts[0].shape[1]
    return [q.reshape(rows, t) for q in rs]


def hybrid_sort_rows(keys, vals: torch.Tensor, *, merge_run: int = 512):
    """The JAX package's xla stand-in for the merge strategy: composite
    radix runs (``radix.composite_sort_rows``), then bitonic-merge
    network stages with the payload tiebreak."""
    words = as_words(keys)
    rows, t = words[0].shape
    if t == 1:
        return like_words(words, keys), vals
    if t & (t - 1):
        raise ValueError(f"row width {t} must be a power of two")
    r0 = min(merge_run, t)
    if r0 > 1:
        wr, vr = _radix.composite_sort_rows(
            tuple(w.reshape(-1, r0) for w in words), vals.reshape(-1, r0))
        words = tuple(w.reshape(rows, t) for w in as_words(wr))
        vals = vr.reshape(rows, t)
    parts = list(words) + [vals]
    run = r0
    while run < t:
        parts = _bitonic_merge_stage(parts, run)
        run *= 2
    return like_words(tuple(parts[:-1]), keys), parts[-1]


def hybrid_sort_sample_rows(keys, vals: torch.Tensor, *, num_samples: int,
                            merge_run: int = 512):
    """Stand-in of the sort+sample entry: :func:`hybrid_sort_rows`, then
    the s equidistant samples."""
    sk, sv = hybrid_sort_rows(keys, vals, merge_run=merge_run)
    sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
    return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)
