"""The baselines the paper compares against (§5, Figs. 6-7), in PyTorch.

The port's counterpart of the JAX package's ``core/baselines.py``:

1. :func:`randomized_sample_sort`: Leischner, Osipov and Sanders'
   randomized sample sort (IPDPS 2010), the pipeline of Algorithm 1
   with splitters from random samples.  Bucket sizes are then only
   probabilistically bounded, so a static capacity can overflow
   (elements dropped, then a retry with a larger capacity).  It reports
   the overflow count and the largest bucket fill, whose dependence on
   the input is the paper's argument for the deterministic sort.
2. :func:`merge_sort`: a Thrust-merge-like sort (Satish, Harris and
   Garland, IPDPS 2009): sorted tiles, then log2(m) rounds of pairwise
   bitonic merges.
3. :func:`torch_sort` / :func:`torch_sort_batched`: stable
   ``torch.sort``, the vendor library, counterparts of the JAX package's
   ``xla_sort`` / ``xla_sort_batched``.

All of them sort through the ``core/key_codec`` codecs, so every codec
dtype works, and ``cfg.descending`` (or ``descending``) is honoured.
The tiles go through ``kernels/ops`` (K1 on the card) and the random
splitters' ranks through K3, as in the reference; what the reference
computes with XLA ops outside any Pallas kernel is plain torch here.
Entry points take ``device=None``, meaning "cuda", as the sorts do.
"""

from __future__ import annotations

import torch

from repro_torch.core import guard
from repro_torch.core.key_codec import codec_for
from repro_torch.core.sort_config import (
    DEFAULT_CONFIG,
    SortConfig,
    next_pow2,
    round_up,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic import lex_gt
from repro_torch.kernels.ops import resolve_device

_PAD = 2**31 - 1  # biased all-ones word (canonical 0xFFFFFFFF)
_INT_MAX = 2**31 - 1
# Random samples drawn per bucket: a*s samples, every a-th of them sorted
# is a splitter (Leischner et al.'s oversampling).
OVERSAMPLE = 8


def _one_d(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 1:
        raise ValueError(f"expected 1-D keys, got shape {tuple(x.shape)}")
    return x


def _pad_to(kw, vals, length: int):
    """Pad 1-D words and index payloads to ``length`` with (all-ones
    words, length + j): pads unique, above every index, sorting last."""
    n = vals.shape[0]
    if length == n:
        return kw, vals
    dev = vals.device
    pw = torch.full((length - n,), _PAD, dtype=torch.int32, device=dev)
    pv = length + torch.arange(length - n, dtype=torch.int32, device=dev)
    return tuple(torch.cat([w, pw]) for w in kw), torch.cat([vals, pv])


# ----------------------------------------------------------------------
# Randomized sample sort (one bucket round, then a row sort of buckets)
# ----------------------------------------------------------------------


def _pad_row(x: torch.Tensor, fill: int) -> torch.Tensor:
    """1-D x padded with ``fill`` to a power of two, as one (1, L) row."""
    n = x.shape[0]
    width = next_pow2(n)
    if width > n:
        x = torch.cat([x, x.new_full((width - n,), fill)])
    return x[None]


def _randomized_canonical(kw, sample_idx, cfg: SortConfig,
                          capacity_factor: float, with_stats: bool):
    """One randomized bucket round on 1-D key words (most significant
    first), payload = original index.

    ``sample_idx`` holds the ``OVERSAMPLE * cfg.s`` random positions in
    [0, lp) of the splitter sample, lp = n rounded up to a tile (a tensor
    of any integer dtype): the caller draws them, so a test can feed the
    positions the JAX package drew.

    Returns (words, perm, (max bucket fill, overflow count) or (None,
    None)), the stats as 0-d int32 tensors.  The buckets are sorted by
    stable ``torch.sort`` passes over the payload, then the words from
    the least significant (``kernels/ref.py`` ``lex_order``): the JAX
    package sorts them with ``jax.lax.sort``, outside any Pallas kernel,
    and this step alone stands in for it.
    """
    n = kw[0].shape[0]
    dev = kw[0].device
    t, s = cfg.tile, cfg.s
    lp = round_up(n, t)
    kw, vals = _pad_to(kw, torch.arange(n, dtype=torch.int32, device=dev), lp)
    m = lp // t

    tkw, tv = ops.sort_tiles(tuple(w.reshape(m, t) for w in kw),
                             vals.reshape(m, t))

    # Random oversampled splitters: every OVERSAMPLE-th of the sorted
    # sample of a*s random elements.
    idx = sample_idx.to(device=dev, dtype=torch.int64)
    sskw, ssv = ops.sort_tiles(tuple(_pad_row(w[idx], _PAD) for w in kw),
                               _pad_row(vals[idx], _INT_MAX))
    sp_idx = torch.arange(1, s, device=dev) * OVERSAMPLE
    spkw = tuple(w[0, sp_idx].expand(m, s - 1).contiguous() for w in sskw)
    spv = ssv[0, sp_idx].expand(m, s - 1).contiguous()

    ranks = ops.splitter_ranks(tkw, tv, spkw, spv)  # (m, s-1)
    starts = torch.cat([torch.zeros_like(ranks[:, :1]), ranks], 1)
    counts = torch.cat([ranks, torch.full_like(ranks[:, :1], t)], 1) - starts
    tile_off = torch.cumsum(counts, 0, dtype=torch.int32) - counts  # (m, s)
    totals = counts.sum(0, dtype=torch.int32)  # (s,)

    # No deterministic bound: a static capacity from the factor, and the
    # elements past it dropped (the reference's mode="drop" scatter).
    cap = round_up(int(capacity_factor * lp / s), 128)
    ind = torch.zeros((m, t + 1), dtype=torch.int32, device=dev)
    ind.scatter_add_(1, ranks.long(), torch.ones_like(ranks))
    bucket_id = torch.cumsum(ind, 1, dtype=torch.int32)[:, :t].long()
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    within = (torch.gather(tile_off, 1, bucket_id)
              + (pos - torch.gather(starts, 1, bucket_id)))
    keep = within < cap
    overflow = (~keep).sum(dtype=torch.int32)
    dest = (bucket_id * cap + within)[keep]
    bkw = tuple(torch.full((s * cap,), _PAD, dtype=torch.int32, device=dev)
                .index_put_((dest,), w[keep]) for w in tkw)
    bv = torch.full((s * cap,), _INT_MAX, dtype=torch.int32, device=dev)
    bv.index_put_((dest,), tv[keep])
    del dest, keep, within, bucket_id

    # The bucket rows' sort (the reference's stand-in for step 9).
    rows = tuple(w.reshape(s, cap) for w in bkw) + (bv.reshape(s, cap),)
    order = ref.lex_order(rows)
    rows = tuple(torch.gather(p, 1, order) for p in rows)
    del order, bkw, bv

    # Compaction back to dense: each bucket's first min(fill, cap) slots.
    boff = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    p = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = p < totals[:, None]  # (s, cap)
    dflat = (boff[:, None] + p)[valid].long()
    out = [torch.full((lp,), fill, dtype=torch.int32, device=dev)
           .index_put_((dflat,), r[valid])
           for r, fill in zip(rows, [_PAD] * (len(rows) - 1) + [_INT_MAX])]
    stats = (totals.max(), overflow) if with_stats else (None, None)
    return tuple(w[:n] for w in out[:-1]), out[-1][:n], stats


def randomized_sample_sort(x, generator: torch.Generator,
                           cfg: SortConfig = DEFAULT_CONFIG,
                           capacity_factor: float = 4.0,
                           with_stats: bool = False, max_attempts: int = 4,
                           *, device=None):
    """Randomized sample sort, with the retry loop a deployment of
    Leischner et al. needs: on overflow (elements dropped, result
    invalid) it runs again with the capacity factor doubled and a fresh
    splitter sample from ``generator``, up to ``max_attempts`` times.
    Each retry is logged in ``guard.degradation_log()``; a spent budget
    raises ``guard.SortRuntimeError``.  The deterministic sort's static
    capacity bound makes this loop unnecessary (the paper's claim C2).

    Args:
        x: 1-D tensor of any codec dtype (``cfg.descending`` honoured).
        generator: draws the splitter sample's positions, on its own
            device (the JAX package takes a PRNG key).
        capacity_factor: static bucket capacity = factor * lp / s,
            doubled on each retry.
        with_stats: also return (max bucket fill, overflow count) of the
            attempt whose result is returned, as 0-d int32 tensors.
        max_attempts: the retry budget.  1 returns the possibly
            overflowed result and its stats as they are, never raising:
            the observational mode.
        device: where to sort (None = "cuda"; "cpu" runs the plain
            versions).  ``x`` is moved there.
    Returns:
        (sorted, perm[, stats]).
    Raises:
        ValueError: for max_attempts < 1 or keys that are not 1-D.
        guard.SortRuntimeError: overflow persisted through every attempt
            (only when max_attempts > 1).
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    x = _one_d(x, device)
    codec = codec_for(x.dtype, cfg.descending)
    kw = codec.encode(x)
    n = x.shape[0]
    lp = round_up(n, cfg.tile)
    site = f"baselines.randomized_sample_sort(n={n})"
    factor = capacity_factor
    for attempt in range(max_attempts):
        idx = torch.randint(0, lp, (OVERSAMPLE * cfg.s,), generator=generator,
                            device=generator.device)
        skw, sv, stats = _randomized_canonical(kw, idx, cfg, factor, True)
        ovf = int(stats[1])
        if ovf == 0 or max_attempts == 1:
            out = codec.decode(skw)
            return (out, sv, stats) if with_stats else (out, sv)
        if attempt + 1 < max_attempts:
            guard.record_degradation(
                site, "retry",
                f"capacity_factor={factor:g}",
                f"capacity_factor={factor * 2:g}, splitter sample re-drawn",
                f"{ovf} element(s) overflowed the static buckets",
            )
            factor *= 2.0
    raise guard.SortRuntimeError(
        site, "bucket fill <= static capacity",
        f"overflow persisted after {max_attempts} attempts "
        f"(final capacity_factor={factor:g}, overflow={ovf}); the "
        f"deterministic sort (core/bucket_sort.py) has no such failure mode",
    )


# ----------------------------------------------------------------------
# Thrust-merge-like: tile sort, then log2(m) pairwise bitonic merge rounds
# ----------------------------------------------------------------------


def _merge_pass(parts, d: int):
    """Compare-exchange at stride d within blocks of 2d along the last axis."""
    lead = parts[0].shape[:-1]
    c = parts[0].shape[-1]
    r3 = [p.reshape(*lead, c // (2 * d), 2, d) for p in parts]
    los = [p[..., 0, :] for p in r3]
    his = [p[..., 1, :] for p in r3]
    swap = lex_gt(los, his)
    return tuple(
        torch.stack((torch.where(swap, hi, lo), torch.where(swap, lo, hi)),
                    dim=-2).reshape(*lead, c)
        for lo, hi in zip(los, his)
    )


def _bitonic_merge_rows(parts):
    """Merge rows of (r, 2L) parts whose [:, :L] ascends and [:, L:]
    descends, jointly on (key words..., payload)."""
    d = parts[0].shape[-1] // 2
    while d >= 1:
        parts = _merge_pass(parts, d)
        d //= 2
    return parts


def _merge_canonical(kw, cfg: SortConfig):
    n = kw[0].shape[0]
    dev = kw[0].device
    t = cfg.tile
    lp = max(round_up(n, t), t)
    kw, vals = _pad_to(kw, torch.arange(n, dtype=torch.int32, device=dev), lp)
    m = lp // t
    tkw, tv = ops.sort_tiles(tuple(w.reshape(m, t) for w in kw),
                             vals.reshape(m, t))
    # Pad the row count to a power of two with all-MAX rows.
    mp = next_pow2(m)
    if mp > m:
        tkw = tuple(torch.cat([w, w.new_full((mp - m, t), _PAD)]) for w in tkw)
        tv = torch.cat([tv, tv.new_full((mp - m, t), _INT_MAX)])
    parts = tkw + (tv,)
    while parts[0].shape[0] > 1:
        # Bitonic rows: even rows ascend, odd rows reversed (descend).
        parts = _bitonic_merge_rows(tuple(
            torch.cat([p[0::2], p[1::2].flip(1)], dim=1) for p in parts))
    return tuple(p[0, :n] for p in parts[:-1]), parts[-1][0, :n]


def merge_sort(x, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Thrust-merge-like baseline: the tile sort (K1 on the card), then
    pairwise bitonic merge rounds of plain torch elementwise passes, as
    the JAX package computes them with jnp ops outside Pallas.

    Args:
        x: 1-D tensor of any codec dtype (``cfg.descending`` honoured).
        device: as :func:`randomized_sample_sort`.
    Returns:
        (sorted, perm), stable like the main pipeline.
    """
    x = _one_d(x, device)
    codec = codec_for(x.dtype, cfg.descending)
    skw, sv = _merge_canonical(codec.encode(x), cfg)
    return codec.decode(skw), sv


# ----------------------------------------------------------------------
# The vendor library: stable torch.sort
# ----------------------------------------------------------------------


def _torch_sort_words(x, descending: bool):
    codec = codec_for(x.dtype, descending)
    kw = codec.encode(x)
    # Stable passes over the words: equal keys keep their index order,
    # the index tie-break of the reference's sort.
    idx = ref.lex_order(kw)
    return codec.decode(tuple(torch.gather(w, -1, idx) for w in kw)), \
        idx.to(torch.int32)


def torch_sort(x, descending: bool = False, *, device=None):
    """Stable ``torch.sort`` over the codec words: the vendor library's
    sort, the counterpart of the JAX package's ``xla_sort``.

    Args:
        x: 1-D tensor of any codec dtype.
        descending: stable descending order (codec complement).
        device: as :func:`randomized_sample_sort`.
    Returns:
        (sorted, perm) with perm the stable argsort (int32).
    """
    return _torch_sort_words(_one_d(x, device), descending)


def torch_sort_batched(x, descending: bool = False, *, device=None):
    """Row-wise stable ``torch.sort`` of (B, L) over the codec words, the
    counterpart of the JAX package's ``xla_sort_batched``.

    Args/Returns: as :func:`torch_sort`, per row.
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"expected (B, L) keys, got shape {tuple(x.shape)}")
    return _torch_sort_words(x, descending)
