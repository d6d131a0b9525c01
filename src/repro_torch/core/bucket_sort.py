"""GPU BUCKET SORT (Dehne & Zaboli 2010, Algorithm 1) in PyTorch.

Port of the JAX package's ``core/bucket_sort.py`` main path: the same
plan-walking executor, on biased int32 key words (``core/key_codec``)
and int32 payloads, with hand-written CUDA kernels:

  step 1  split into tiles            -> reshape (rows, L) -> (rows*m, T)
  step 2  local sort per tile         -> K1 bitonic tile sort, or K5 radix
                                         / K6 merge by the plan's strategy
  step 3  s equidistant local samples -> the tile sort's fused sample
                                         epilogue, or a strided slice of
                                         the sorted tiles (unfused)
  step 4  sort all samples            -> recursion on the sample array
  step 5  s equidistant global samples-> strided slice of sorted samples
  step 6  sample indexing             -> K2 splitter partition, or K3
                                         splitter ranks when
                                         fuse_ranking=False
  step 7  column-major prefix sum     -> cumsums over (rows, m, s) counts
  step 8  data relocation             -> source index per bucket slot
                                         (searchsorted), then one gather
  step 9  sublist sort                -> recursion on bucket rows, then a
                                         gather back to dense rows

Every entry point takes ``device=None``, which means ``"cuda"``: it
raises when CUDA is absent unless the caller passes ``device="cpu"``.
On CUDA tensors every kernel call launches its kernel or raises; CPU
tensors take the kernels' plain versions.  Nothing falls back from one
to the other.

Every entry point runs through the guarded funnel
:func:`_execute_packed`: the plan, then ``SortConfig.check``'s
invariants (``core/guard.py``).  A failure on CUDA tensors is retried
once with the same plan and then raised as a ``SortRuntimeError``
naming the plan node and the kernel or check; on CPU tensors the chain
keeps the JAX package's three rungs (the plan, the default-config plan,
a stable sort), so that tests can hold it against the reference.

``segment_sort`` / ``segment_argsort`` pack ragged segments, whose
offsets the host knows, into the rows of one batched sort.

Invariants (as in the reference): payloads are unique per row (the
original index, or pads drawn from one per-row range above every real
payload), so every compared pair is distinct, the bucket capacity bound
holds for any input and the sort is stable.  Equal keys always arrive
in increasing-payload order (entry payloads are indices, pads come
after, and sampling, relocation and compaction keep the order of equal
keys), which is what lets the radix and merge strategies, stable on the
key words alone, give the bitonic order.  Flat gather indices are
int64 (torch's index type); the reference builds them in int32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import guard
from repro_torch.core.key_codec import codec_for
from repro_torch.core.plan import (
    SORTERS,
    LevelPlan,
    SortPlan,
    build_plan,
    build_words_plan,
)
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic import take_samples
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.splitter import counts_from_ranks

_PAD = 2**31 - 1  # biased pad word (canonical 0xFFFFFFFF)
_INT_MAX = 2**31 - 1
# Elements of one chunk of the relocation and compaction index math:
# bounds their int64 temporaries (8 bytes each) per level.
_GLUE_CHUNK = 1 << 25


def _pad_cols(kw, vals, new_len: int, pad_base: int):
    """Pad the last axis to new_len with (pad words, pad_base + j).

    Pad payloads are unique per row and above every real payload, so
    pads sort after all real elements.
    """
    r, length = vals.shape
    extra = new_len - length
    if extra == 0:
        return kw, vals, pad_base
    pk = torch.full((r, extra), _PAD, dtype=torch.int32, device=vals.device)
    pv = (pad_base + torch.arange(extra, dtype=torch.int32,
                                  device=vals.device)).expand(r, extra)
    kw = tuple(torch.cat([w, pk], dim=1) for w in kw)
    return kw, torch.cat([vals, pv], dim=1), pad_base + extra


def _direct_sort(data: list, node: LevelPlan, pad_base: int, site: str):
    """One tile sort of each (rows, L) row, L <= direct_max, padded to
    lp; takes and empties ``data`` as :func:`_run_node` does."""
    kw, vals = data
    data.clear()
    kw, vals, pad_base = _pad_cols(kw, vals, node.lp, pad_base)
    sk, sv = _launch(site, _sorter(node), ops.sort_tiles, kw, vals,
                     **_local_sort(node))
    return sk, sv, pad_base


def _local_sort(node) -> dict:
    """The local-sort knobs of a LevelPlan or TopkPlan, as
    ``ops.sort_tiles*`` take them."""
    return dict(strategy=node.strategy, radix_bits=node.radix_bits,
                merge_run=node.merge_run)


def _sorter(node) -> str:
    """The kernel of a LevelPlan's or TopkPlan's row sort: K1, K5 or K6."""
    return SORTERS[node.strategy]


def _launch(site: str, kernel: str, fn, *args, **kwargs):
    """Call the ``kernels/ops`` dispatcher ``fn`` of ``kernel``.

    A failure there (a build or launch error, a refused shape, an
    injected ``kernel.launch`` fault) raises ``guard.SortRuntimeError``
    at ``site:kernel`` with the error as its cause; running out of
    device memory is no kernel's fault and passes as it is.
    """
    try:
        return fn(*args, **kwargs)
    except torch.cuda.OutOfMemoryError:
        raise
    except Exception as e:
        raise guard.SortRuntimeError(
            f"{site}:{kernel}", "kernel launch", f"{type(e).__name__}: {e}"
        ) from e


def _chunk_search(offsets: torch.Tensor, positions: torch.Tensor):
    """Row-wise index j of the last chunk with offsets[q, j] <= position
    (skips empty chunks); offsets (Q, C) non-decreasing, positions (Q, P).
    Returns int32 (Q, P)."""
    return torch.searchsorted(offsets, positions, right=True,
                              out_int32=True) - 1


def _row_chunks(rows: int, width: int):
    """(first, end) row ranges of about ``_GLUE_CHUNK`` elements each."""
    step = max(1, _GLUE_CHUNK // width)
    return ((a, min(a + step, rows)) for a in range(0, rows, step))


def _relocate_gather(tkw, tv, starts, tile_off, totals, r, m, s_round, t,
                     cap, pad_base):
    """Step 8: for every slot of the (r*s_round, cap) bucket array, the
    source element it receives, then one gather per word.

    Slot p of bucket row q = r'*s_round + j reads from the tile whose
    chunk covers p, at p minus that chunk's offset; slots past the
    bucket's fill become fresh pads, unique within their row.  Bucket
    rows are filled in chunks, so the int64 index temporaries stay
    near ``_GLUE_CHUNK`` elements whatever the level's size.
    """
    q = r * s_round
    dev = tv.device
    offs = tile_off.permute(0, 2, 1).reshape(q, m).contiguous()
    st = starts.reshape(r, m, s_round).permute(0, 2, 1).reshape(q, m)
    fill = totals.reshape(q, 1)
    src_w = tuple(w.reshape(-1) for w in tkw)
    src_v = tv.reshape(-1)
    bkw = tuple(torch.empty((q, cap), dtype=torch.int32, device=dev) for _ in tkw)
    bv = torch.empty((q, cap), dtype=torch.int32, device=dev)
    p = torch.arange(cap, dtype=torch.int32, device=dev)
    pad_word = torch.tensor(_PAD, dtype=torch.int32, device=dev)
    for a, b in _row_chunks(q, cap):
        src_tile = _chunk_search(offs[a:b], p.expand(b - a, cap).contiguous()).long()
        within = p + (torch.gather(st[a:b], 1, src_tile)
                      - torch.gather(offs[a:b], 1, src_tile))
        row_base = (torch.arange(a, b, device=dev) // s_round * m).unsqueeze(1)
        src = (row_base + src_tile) * t + within
        del src_tile, within
        valid = p < fill[a:b]
        src = src.masked_fill_(~valid, 0).reshape(-1)
        for w, out in zip(src_w, bkw):
            torch.where(valid, w[src].reshape(b - a, cap), pad_word,
                        out=out[a:b])
        torch.where(valid, src_v[src].reshape(b - a, cap), pad_base + p,
                    out=bv[a:b])
    return bkw, bv


def _compact_gather(ckw, cv, totals, r, s_round, lp):
    """Step 9 compaction: dense column c of row r' reads from the bucket
    covering c, at c minus that bucket's offset (every slot has exactly
    one source, since fills sum to lp).  ``ckw`` / ``cv`` are the sorted
    (r*s_round, width) bucket rows, width >= cap; rows are filled in
    chunks as in relocation."""
    dev = cv.device
    width = cv.shape[1]
    bucket_off = torch.cumsum(totals, 1, dtype=torch.int32) - totals
    src_w = tuple(w.reshape(-1) for w in ckw)
    src_v = cv.reshape(-1)
    okw = tuple(torch.empty((r, lp), dtype=torch.int32, device=dev) for _ in ckw)
    ov = torch.empty((r, lp), dtype=torch.int32, device=dev)
    c = torch.arange(lp, dtype=torch.int32, device=dev)
    for a, b in _row_chunks(r, lp):
        srcj = _chunk_search(bucket_off[a:b], c.expand(b - a, lp).contiguous()).long()
        # A fill above the row width (a plan whose cap is below the
        # fills, which check="bounds" reports after the run) must not
        # read past its bucket row: clamp, a no-op on a sound plan.
        within = (c - torch.gather(bucket_off[a:b], 1, srcj)).clamp_(max=width - 1)
        row = torch.arange(a, b, device=dev).unsqueeze(1) * s_round
        src = ((row + srcj) * width + within).reshape(-1)
        del srcj, within
        for w, out in zip(src_w, okw):
            torch.index_select(w, 0, src, out=out[a:b].view(-1))
        torch.index_select(src_v, 0, src, out=ov[a:b].view(-1))
    return okw, ov


def _node_site(site: str, node: LevelPlan) -> str:
    if node.kind == "direct":
        return f"{site}:direct(rows={node.rows}, lp={node.lp})"
    return (f"{site}:bucket(rows={node.rows}, lp={node.lp}, "
            f"s_round={node.s_round}, cap={node.cap})")


def _run_node(data: list, node: LevelPlan, pad_base: int, stats: list | None,
              site: str):
    """Sort each row of (rows, L) key words / payloads by walking one plan
    node.  ``data`` is the list [key words, payloads], which the node
    empties: it owns its input, so each level's input is freed once its
    tile sort has read it.  ``site`` is the node's path from the plan,
    for the errors of its kernels (:func:`_launch`).

    Returns:
        (sorted kw, sorted vals, pad_base), rows of the node's padded
        width lp: the first L columns are the sorted row, then pads.
    """
    r, length = data[1].shape
    if (r, length) != (node.rows, node.length):
        raise ValueError(
            f"plan/data mismatch: data {(r, length)} vs plan node "
            f"{(node.rows, node.length)}"
        )
    site = _node_site(site, node)
    if node.kind == "direct":
        return _direct_sort(data, node, pad_base, site)
    kw, vals = data
    data.clear()

    t, sper, lp, m = node.tile, node.s, node.lp, node.m
    s_round, cap = node.s_round, node.cap
    kw, vals, pad_base = _pad_cols(kw, vals, lp, pad_base)

    # Steps 1-3: tile sort, with the samples emitted by its epilogue or
    # sliced out of the sorted tiles: element (j+1)*T/s - 1 of each.
    tiles = (tuple(w.reshape(r * m, t) for w in kw), vals.reshape(r * m, t))
    del kw, vals
    if node.fuse_sampling:
        tkw, tv, samp_kw, samp_v = _launch(
            site, _sorter(node), ops.sort_tiles_sample, *tiles,
            num_samples=sper, **_local_sort(node))
    else:
        tkw, tv = _launch(site, _sorter(node), ops.sort_tiles, *tiles,
                          **_local_sort(node))
        samp_kw = tuple(take_samples(w, sper) for w in tkw)
        samp_v = take_samples(tv, sper)
    del tiles

    # Step 4: sort all samples (recursion on the (r, m*s) sample array).
    sskw, ssv, pad_base = _run_node(
        [tuple(w.reshape(r, m * sper) for w in samp_kw),
         samp_v.reshape(r, m * sper)],
        node.sample_plan, pad_base, None, f"{site}/sample",
    )
    del samp_kw, samp_v

    # Step 5: s_round - 1 equidistant global splitters per row.
    total = m * sper
    sp_idx = torch.arange(1, s_round, device=ssv.device) * total // s_round
    spkw_t = tuple(w[:, sp_idx].repeat_interleave(m, dim=0).contiguous()
                   for w in sskw)  # (r*m, s_round-1)
    spv_t = ssv[:, sp_idx].repeat_interleave(m, dim=0).contiguous()
    del sskw, ssv

    # Steps 6-7: splitter ranks and per-tile bucket counts, then the
    # column-major prefix sums over (rows, m, s_round).
    if node.fuse_ranking:
        ranks, counts2 = _launch(site, "splitter_partition",
                                 ops.splitter_partition, tkw, tv, spkw_t, spv_t)
    else:
        ranks = _launch(site, "splitter_ranks", ops.splitter_ranks,
                        tkw, tv, spkw_t, spv_t)
        counts2 = counts_from_ranks(ranks, t)
    starts = torch.cat([torch.zeros_like(ranks[:, :1]), ranks], dim=1)
    counts = counts2.reshape(r, m, s_round)
    tile_off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    totals = counts.sum(1, dtype=torch.int32)  # (r, s_round) bucket fills
    del ranks, counts, counts2, spkw_t, spv_t

    # Step 8: relocation into the dense (r*s_round, cap) bucket array,
    # handed to the bucket recursion with no reference kept here.
    bucket_data = list(_relocate_gather(
        tkw, tv, starts, tile_off, totals, r, m, s_round, t, cap, pad_base
    ))
    del tkw, tv, starts, tile_off
    pad_base += cap

    if stats is not None:
        stats.append(dict(
            level_len=lp, rows=r, s_round=s_round, capacity=cap,
            totals=totals, max_within=totals.max() - 1,
        ))

    # Step 9: sort every bucket row (recursion), then compact.
    ckw, cv, pad_base = _run_node(bucket_data, node.bucket_plan, pad_base,
                                  stats, f"{site}/bucket")
    okw, ov = _compact_gather(ckw, cv, totals, r, s_round, lp)
    return okw, ov, pad_base


def _run_plan(kw, vals, plan: SortPlan, pad_base0: int, with_stats: bool):
    """Walk ``plan`` on (rows, L) words and payloads.  Returns (kw, vals,
    stats), stats [] unless ``with_stats``."""
    stats: list | None = [] if with_stats else None
    skw, sv, pad_base = _run_node([tuple(kw), vals], plan.root, pad_base0,
                                  stats, f"{guard.plan_site(plan)}/top")
    if pad_base >= _INT_MAX:
        raise OverflowError(
            f"pad payload budget exhausted ({pad_base}); reduce L or raise "
            "s/tile"
        )
    return (tuple(w[:, :plan.length] for w in skw), sv[:, :plan.length],
            stats or [])


def _fallback_plan(plan: SortPlan) -> SortPlan | None:
    """The CPU chain's second rung: the ``DEFAULT_CONFIG`` plan of the
    same (rows, length, key words) signature, or None when it equals the
    failing plan."""
    try:
        alt = build_words_plan(plan.length, plan.num_words, DEFAULT_CONFIG,
                               rows=plan.rows)
    except ValueError:
        return None
    return None if alt == plan else alt


def _reference_sort_packed(kw, vals):
    """The CPU chain's last rung: a stable sort of each row on (key
    words..., payload), no plan and no kernel (``kernels/ref.py``), the
    counterpart of the JAX package's ``jax.lax.sort`` rung."""
    idx = ref.lex_order(tuple(kw) + (vals,))
    return tuple(torch.gather(w, 1, idx) for w in kw), torch.gather(vals, 1, idx)


def _execute_packed(kw, vals, plan: SortPlan, pad_base0: int, *,
                    check: str = "off", degrade: bool = True,
                    with_stats: bool = False):
    """Guarded funnel every entry point runs through.

    Runs ``plan``, then the ``check`` invariants (``core/guard.py``):
    ``"bounds"`` the capacity bound on the measured bucket fills of each
    round, ``"full"`` also permutation checksums and sortedness of the
    output.  ``pad_base0`` must exceed every payload already in ``vals``.

    With ``degrade=True`` a failure walks a chain that depends on the
    device of the tensors:

    * CUDA: a ``guard.SortRuntimeError`` (a kernel's build or launch
      error, an injected fault, a check violation) is logged as a
      ``"retry"`` and the same plan runs once more; if that fails too,
      a ``SortRuntimeError`` naming the node and the kernel or check is
      raised, the first error its cause.  Nothing on the card leaves
      the port's kernels (ROADMAP.md Queue 3 D8); other errors, such as
      running out of memory, propagate.
    * CPU: the JAX package's chain, each step logged as a
      ``"fallback"``: the plan, then the default-config plan of the same
      words signature (:func:`_fallback_plan`), then a stable sort
      (:func:`_reference_sort_packed`, stats ``[]``).

    ``degrade=False`` (an explicit plan, or a caller with its own chain)
    raises the first error.  Returns (kw, vals[, stats]).
    """
    guard.validate_check(check)
    want_stats = with_stats or check != "off"

    def run(p: SortPlan):
        skw, sv, stats = _run_plan(kw, vals, p, pad_base0, want_stats)
        if check != "off":
            guard.check_bounds(p, stats)
        if check == "full":
            guard.check_full(p, kw, vals, skw, sv)
        return skw, sv, stats

    def reference():
        skw, sv = _reference_sort_packed(kw, vals)
        if check == "full":
            guard.check_full(plan, kw, vals, skw, sv)
        return skw, sv, []

    try:
        skw, sv, stats = run(plan)
    except Exception as e1:
        if not degrade:
            raise
        site = guard.plan_site(plan)
        if not vals.is_cuda:
            skw, sv, stats = guard.fall_back(site, run, _fallback_plan(plan),
                                             reference, e1)
        elif isinstance(e1, guard.SortRuntimeError):
            skw, sv, stats = guard.retry_once(site, lambda: run(plan), e1)
        else:
            raise
    return (skw, sv, stats) if with_stats else (skw, sv)


def _index_rows(b: int, n: int, device) -> torch.Tensor:
    """(b, n) int32 payloads: the original index within each row."""
    return torch.arange(n, dtype=torch.int32, device=device).repeat(b, 1)


def resolve_plan(length: int, dtype, cfg: SortConfig, *, rows: int = 1,
                 device=None) -> SortPlan:
    """The plan of a sort signature, as ``cfg.plan`` says:

      * ``"default"``: :func:`repro_torch.core.plan.build_plan` (memoized);
      * ``"autotune"``: the measured-best plan on ``device`` (None =
        "cuda"), from the store or tuned on the first miss
        (``core/autotune.plan_for``; the device is part of its key);
      * a path: a plan file written by ``autotune.save_plan``, whose
        signature must match (ValueError otherwise).
    """
    if cfg.plan == "default":
        return build_plan(length, dtype, cfg, rows=rows)
    from repro_torch.core import autotune  # autotune imports this module

    if cfg.plan == "autotune":
        return autotune.plan_for(length, dtype, cfg, rows=rows, device=device)
    return autotune.load_plan(cfg.plan, length=length, dtype=dtype, cfg=cfg,
                              rows=rows)


def _prepare(keys, cfg: SortConfig, device, ndim: int):
    """Device, tensor and plan of an entry point's keys; the plan is None
    when there is nothing to sort (no rows, or rows of at most one key),
    which every entry point returns before sorting."""
    dev = resolve_device(device)
    keys = torch.as_tensor(keys, device=dev)
    if keys.dim() != ndim:
        raise ValueError(f"expected {ndim}-D keys, got shape {tuple(keys.shape)}")
    codec = codec_for(keys.dtype, cfg.descending)
    rows, length = (1, keys.shape[0]) if ndim == 1 else tuple(keys.shape)
    plan = None
    if rows and length > 1:
        plan = resolve_plan(length, keys.dtype, cfg, rows=rows, device=dev)
    return keys, codec, plan


def _sort_rows(keys, codec, plan: SortPlan, check: str, *,
               with_stats: bool = False, degrade: bool = True):
    """(B, L) keys -> sorted words, permutation[, stats], through the
    guarded funnel."""
    b, n = keys.shape
    kw = codec.encode(keys)
    return _execute_packed(kw, _index_rows(b, n, keys.device), plan, n,
                           check=check, degrade=degrade, with_stats=with_stats)


# ----------------------------------------------------------------------
# Public 1-D API
# ----------------------------------------------------------------------


def sort(keys, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Deterministic sample sort of a 1-D tensor (stable, total order).

    Args:
        keys: 1-D tensor of any codec dtype (``key_codec.SUPPORTED_DTYPES``);
            floats follow the IEEE total order (NaN last ascending).
        cfg: pipeline knobs; ``cfg.descending`` flips the order.
        device: where to sort (None = "cuda"; "cpu" runs the plain
            versions).  ``keys`` is moved there.
    Returns:
        Sorted tensor, same shape and dtype, on ``device``.
    """
    keys, codec, plan = _prepare(keys, cfg, device, 1)
    if keys.shape[0] <= 1:
        return keys.clone()
    skw, _ = _sort_rows(keys[None, :], codec, plan, cfg.check)
    return codec.decode(tuple(w[0] for w in skw))


def argsort(keys, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Stable argsort (int32 permutation) of a 1-D tensor; == numpy's
    ``argsort(kind="stable")`` in the key dtype's total order."""
    keys, codec, plan = _prepare(keys, cfg, device, 1)
    if keys.shape[0] <= 1:
        return torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = _sort_rows(keys[None, :], codec, plan, cfg.check)
    return perm[0]


def sort_kv(keys, values, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Stable (keys, values) sort by keys.

    Args:
        keys: 1-D tensor of length n; values: tensor with leading dim n,
            permuted along axis 0.
    Returns:
        (sorted keys, values[perm]) on ``device``.
    """
    keys, codec, plan = _prepare(keys, cfg, device, 1)
    values = torch.as_tensor(values, device=keys.device)
    if values.shape[:1] != keys.shape:
        raise ValueError(
            f"values {tuple(values.shape)} do not match keys {tuple(keys.shape)}"
        )
    if keys.shape[0] <= 1:
        return keys.clone(), values.clone()
    skw, perm = _sort_rows(keys[None, :], codec, plan, cfg.check)
    return codec.decode(tuple(w[0] for w in skw)), values[perm[0].long()]


def sort_with_stats(keys, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Sort + per-round stats (one dict per bucket round: level_len, rows,
    s_round, capacity, totals, max_within); [] on the direct path.

    Returns:
        (sorted, perm, stats).
    """
    keys, codec, plan = _prepare(keys, cfg, device, 1)
    if keys.shape[0] <= 1:
        perm = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
        return keys.clone(), perm, []
    skw, perm, stats = _sort_rows(keys[None, :], codec, plan, cfg.check,
                                   with_stats=True)
    return codec.decode(tuple(w[0] for w in skw)), perm[0], stats


def sort_planned(keys, plan: SortPlan, check: str = "off", *, device=None):
    """Sort with an explicit plan from :func:`repro_torch.core.plan.build_plan`.

    ``keys`` is 1-D (plan.rows == 1) or (B, L); it must match the plan's
    signature.  The plan holds no device: ``device`` (None = "cuda";
    "cpu" runs the plain versions) decides, and ``keys`` is moved there.
    The caller asked for this schedule, so it runs without degradation:
    a failure, including a ``check`` violation, raises.
    Returns the sorted tensor (each row for 2-D).

    Raises:
        RuntimeError: for CUDA when it is not available.
        ValueError: when keys' shape or dtype do not match, or for an
            unknown ``check`` mode.
        repro_torch.core.guard.SortRuntimeError: a kernel failed, or
            ``check`` found a violated invariant.
    """
    keys = torch.as_tensor(keys, device=resolve_device(device))
    shape = (1, keys.shape[0]) if keys.dim() == 1 else tuple(keys.shape)
    codec = codec_for(keys.dtype, plan.descending)
    if keys.dim() not in (1, 2) or shape != (plan.rows, plan.length) or (
        codec.dtype_name != plan.dtype_name
    ):
        raise ValueError(
            f"keys {tuple(keys.shape)}/{codec.dtype_name} do not match plan "
            f"signature rows={plan.rows} length={plan.length} "
            f"dtype={plan.dtype_name}"
        )
    if plan.length <= 1:
        return keys.clone()
    skw, _ = _sort_rows(keys.reshape(shape), codec, plan, check, degrade=False)
    return codec.decode(skw).reshape(keys.shape)


# ----------------------------------------------------------------------
# Batched API: B independent sorts on the rows of (B, L)
# ----------------------------------------------------------------------


def sort_batched(keys, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Sort each row of a (B, L) tensor independently (stable), the whole
    batch through one recursion: one launch per pipeline step."""
    keys, codec, plan = _prepare(keys, cfg, device, 2)
    b, length = keys.shape
    if b == 0 or length <= 1:
        return keys.clone()
    skw, _ = _sort_rows(keys, codec, plan, cfg.check)
    return codec.decode(skw)


def argsort_batched(keys, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Per-row stable argsort of (B, L): (B, L) int32 permutations."""
    keys, codec, plan = _prepare(keys, cfg, device, 2)
    b, length = keys.shape
    if b == 0 or length <= 1:
        return _index_rows(b, length, keys.device)
    _, perm = _sort_rows(keys, codec, plan, cfg.check)
    return perm


def sort_kv_batched(keys, values, cfg: SortConfig = DEFAULT_CONFIG, *,
                    device=None):
    """Per-row stable (keys, values) sort of (B, L) keys; values (B, L, ...)
    are permuted along axis 1 with each row's permutation."""
    keys, codec, plan = _prepare(keys, cfg, device, 2)
    values = torch.as_tensor(values, device=keys.device)
    if values.shape[:2] != keys.shape:
        raise ValueError(
            f"values {tuple(values.shape)} do not match keys {tuple(keys.shape)}"
        )
    b, length = keys.shape
    if b == 0 or length <= 1:
        return keys.clone(), values.clone()
    skw, perm = _sort_rows(keys, codec, plan, cfg.check)
    idx = perm.long().reshape(perm.shape + (1,) * (values.dim() - 2))
    return codec.decode(skw), torch.gather(values, 1, idx.expand_as(values))


def sort_batched_with_stats(keys, cfg: SortConfig = DEFAULT_CONFIG, *,
                            device=None):
    """Batched sort + per-round stats over the whole batch; stats is []
    when L fits ``cfg.direct_max``.  Returns (sorted, perm, stats)."""
    keys, codec, plan = _prepare(keys, cfg, device, 2)
    b, length = keys.shape
    if b == 0 or length <= 1:
        return keys.clone(), _index_rows(b, length, keys.device), []
    skw, perm, stats = _sort_rows(keys, codec, plan, cfg.check,
                                   with_stats=True)
    return codec.decode(skw), perm, stats


# ----------------------------------------------------------------------
# Segmented API: ragged independent sorts, packed into padded rows
# ----------------------------------------------------------------------


def _segment_layout(n: int, segment_offsets):
    """Host-side packing layout of ragged segments, in numpy.

    ``segment_offsets``: host data (a sequence, a numpy array or a CPU
    tensor) of non-decreasing ints with off[0] == 0 and off[-1] == n.
    The packed row width is a shape, so offsets on a card are refused,
    as the JAX package refuses traced offsets.

    Returns (off, lens, W, valid, src, unpack_src, seg_of_pos), all
    numpy; W is the padded row width (the longest segment).
    Raises:
        ValueError: for offsets on a card, or offsets that are not such
            a sequence.
    """
    if isinstance(segment_offsets, torch.Tensor) and (
            segment_offsets.device.type != "cpu"):
        raise ValueError(
            f"segment_offsets must be host data, got a tensor on "
            f"{segment_offsets.device}: the packed row width is a shape")
    off = np.asarray(segment_offsets)
    if off.ndim != 1 or off.size < 1:
        raise ValueError("segment_offsets must be a 1-D sequence [0, ..., n]")
    off = off.astype(np.int64)
    lens = np.diff(off)
    if off[0] != 0 or off[-1] != n or (lens < 0).any():
        raise ValueError(
            f"segment_offsets must be non-decreasing with off[0] = 0 and "
            f"off[-1] = n = {n}")
    w = int(lens.max()) if lens.size else 0
    col = np.arange(max(w, 1))
    valid = col[None, :] < lens[:, None]  # (S, W)
    src = np.where(valid, off[:-1, None] + col[None, :], 0)
    pos = np.arange(n)
    seg_of_pos = np.searchsorted(off, pos, side="right") - 1  # skips empties
    unpack_src = seg_of_pos * max(w, 1) + (pos - off[seg_of_pos])
    return off, lens, w, valid, src, unpack_src, seg_of_pos


def _segment_sorted_packed(x, layout, cfg: SortConfig):
    """Pack the ragged segments of 1-D x into a padded (S, W) batch, sort
    its rows through the funnel and return (codec, sorted words (S, W),
    local permutation (S, W)).

    Row i holds segment i left-justified; columns past its length hold
    (all-ones words, W + column) pads, unique per row and above every
    real payload (the local index, < W), so they sort last and leave
    the per-row capacity bound as it is.  The next pads start at 2·W.
    """
    _, lens, w, valid, src, _, _ = layout
    dev = x.device
    codec = codec_for(x.dtype, cfg.descending)
    kw = codec.encode(x)
    validt = torch.from_numpy(valid).to(dev)
    srct = torch.from_numpy(src).to(dev)
    col = torch.arange(w, dtype=torch.int32, device=dev)
    pkw = tuple(torch.where(validt, u[srct], _PAD) for u in kw)
    pv = torch.where(validt, col, w + col)
    del validt, srct
    plan = resolve_plan(w, x.dtype, cfg, rows=lens.size, device=dev)
    skw, sv = _execute_packed(pkw, pv, plan, 2 * w, check=cfg.check)
    return codec, skw, sv


def _segments(x, segment_offsets, device):
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 1:
        raise ValueError(f"expected 1-D keys, got shape {tuple(x.shape)}")
    return x, _segment_layout(x.shape[0], segment_offsets)


def segment_sort(x, segment_offsets, cfg: SortConfig = DEFAULT_CONFIG, *,
                 device=None):
    """Sort each segment x[off[i]:off[i+1]] independently, in place.

    Args:
        x: 1-D tensor of any codec dtype (``key_codec.SUPPORTED_DTYPES``).
        segment_offsets: host data (a sequence, a numpy array or a CPU
            tensor): non-decreasing ints, off[0] = 0, off[-1] = len(x).
            Empty segments are fine.
        cfg: pipeline knobs (``descending`` sorts every segment
            descending; ``check`` as for :func:`sort`).
        device: where to sort (None = "cuda"; "cpu" runs the plain
            versions).  ``x`` is moved there.
    Returns:
        Tensor of x's shape on ``device``: all segments go through one
        batched sort of (segments, longest segment) rows.
    Raises:
        ValueError: for offsets on a card or not of that form.

    Example:
        >>> import torch
        >>> from repro_torch.core import segment_sort
        >>> segment_sort(torch.tensor([3, 1, 9, 7, 8]), [0, 2, 5], device="cpu")
        tensor([1, 3, 7, 8, 9])
    """
    x, layout = _segments(x, segment_offsets, device)
    if layout[2] <= 1:  # no segment holds two keys
        return x.clone()
    codec, skw, _ = _segment_sorted_packed(x, layout, cfg)
    unpack = torch.from_numpy(layout[5]).to(x.device)
    return codec.decode(tuple(u.reshape(-1)[unpack] for u in skw))


def segment_argsort(x, segment_offsets, cfg: SortConfig = DEFAULT_CONFIG, *,
                    device=None):
    """Per-segment stable argsort with global indices: out[off[i]:off[i+1]]
    is a permutation of [off[i], off[i+1]) and x[out] == segment_sort(x).

    Args/Raises: as :func:`segment_sort`.
    Returns:
        int32 permutation of x's shape on ``device``.
    """
    x, layout = _segments(x, segment_offsets, device)
    n = x.shape[0]
    if layout[2] <= 1:
        return torch.arange(n, dtype=torch.int32, device=x.device)
    _, _, sv = _segment_sorted_packed(x, layout, cfg)
    off, _, _, _, _, unpack_src, seg_of_pos = layout
    local = sv.reshape(-1)[torch.from_numpy(unpack_src).to(x.device)]
    base = torch.from_numpy(off[seg_of_pos].astype(np.int32)).to(x.device)
    return base + local
