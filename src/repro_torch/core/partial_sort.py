"""Partial deterministic sample sort: top-k of large rows, in PyTorch.

Port of the JAX package's ``core/partial_sort.py``.  One bucket round
of Algorithm 1 (steps 1-6) finds a splitter threshold θ whose global
rank is >= k; the fewer than k + cap elements below θ (cap = the
guaranteed bucket capacity, which makes the candidate buffer static)
are packed and sorted, and their first k are the answer:

  tile sort with samples        -> K1, K5 or K6 by the plan's strategy
  sort the samples               -> the same kernel, or the bucket-sort
                                    executor for a row wider than a
                                    CTA takes
  splitter ranks per tile        -> K3 (kernels/splitter)
  θ, candidate pack              -> torch glue (searchsorted + gather)
  sort the candidates            -> as the samples

Everything works on "the k smallest canonical key words": the entry
points encode with the descending codec, under which ascending order is
descending score order and ties go to the smaller index, as
``jax.lax.top_k``.  ``cfg.descending`` is ignored.

The JAX package's 1-D helpers (``_sort_small``, ``_smallest_k``) are
its row helpers at one row, and so is the 1-D ``topk`` here: it runs
:func:`topk_batched` on one row, whose plan is the 1-D plan.

Entry points take ``device=None``, meaning "cuda", and raise without
CUDA unless given ``device="cpu"``.  ``cfg.check`` adds
``guard.check_topk``'s post-conditions, and a failure walks the chain
of ``bucket_sort._execute_packed``: on CUDA tensors one retry of the
same plan, then a ``SortRuntimeError`` naming the kernel or check; on
CPU tensors the JAX package's rungs, the default-config plan and then a
stable sort with ties toward the smaller index (``kernels/ref.py``
``topk_desc``, not ``torch.topk``, whose tie order differs).  Nothing on
the card calls a library top-k or sort.
"""

from __future__ import annotations

import torch

from repro_torch.core import guard
from repro_torch.core.bucket_sort import (
    _INT_MAX,
    _PAD,
    _chunk_search,
    _execute_packed,
    _launch,
    _local_sort,
    _sorter,
)
from repro_torch.core.key_codec import codec_for
from repro_torch.core.plan import SortPlan, TopkPlan, build_topk_plan
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig, next_pow2
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import resolve_device


def _pad_max(kw, vals, width: int):
    """(r, L) words / payloads padded to ``width`` columns with
    (pad word, INT_MAX) pairs, which sort last and are never candidates."""
    r, length = vals.shape
    if width == length:
        return kw, vals
    dev = vals.device
    pk = torch.full((r, width - length), _PAD, dtype=torch.int32, device=dev)
    pv = torch.full((r, width - length), _INT_MAX, dtype=torch.int32,
                    device=dev)
    return (tuple(torch.cat([w, pk], 1) for w in kw), torch.cat([vals, pv], 1))


def _pad_pow2(kw, v2):
    """Pad (r, L) to the next power of two (at least 2, the narrowest
    tile of the row sorts), as :func:`_pad_max`."""
    return _pad_max(kw, v2, max(2, next_pow2(v2.shape[1])))


def _sort_wide_rows(kw, v2, plan: SortPlan, base: int):
    """Sort each row of (r, L) with the bucket-sort executor on ``plan``.

    The executor needs distinct (words, payload) pairs within a row, and
    the rows may hold several (pad word, INT_MAX) pads.  Real payloads
    are indices below ``base`` (the top-k length), so each pad gets the
    payload base + its column for the call and INT_MAX back after it
    (``build_topk_plan`` refuses a length where that overflows): the
    pads still sort after every real element, and the result is the
    sorted row that :func:`_pad_pow2` and one row sort give.
    """
    n = v2.shape[1]
    cols = torch.arange(n, dtype=torch.int32, device=v2.device)
    v = torch.where(v2 == _INT_MAX, base + cols, v2)
    # The top-k's own chain handles a failure (topk_batched).
    skw, sv = _execute_packed(kw, v, plan, base + n, degrade=False)
    return skw, torch.where(sv >= base, _INT_MAX, sv)


def _sort_small_rows(kw, v2, plan: SortPlan | None, base: int,
                     tplan: TopkPlan, site: str):
    """Sort each row of (r, L) on (*words, payload); returns (r, L).

    ``plan`` is the TopkPlan's choice for this row, made from the shape
    alone before anything launches: None pads the row to a power of two
    and sorts it with one launch of the plan's local sort (K1, K5 or
    K6; the pads come after every real element in the row, so the
    stable K5 and K6 keep them last); a SortPlan (a row wider than
    ``bitonic.MAX_TILE``: the sample and candidate rows of a long 1-D
    top-k) runs the bucket-sort executor (:func:`_sort_wide_rows`).
    This is not a fallback, and both give the same sorted rows.
    ``site`` names the rows for a kernel's error.
    """
    n = v2.shape[1]
    if plan is None:
        skw, sv = _launch(site, _sorter(tplan), ops.sort_tiles,
                          *_pad_pow2(kw, v2), **_local_sort(tplan))
    else:
        skw, sv = _sort_wide_rows(kw, v2, plan, base)
    return tuple(w[:, :n] for w in skw), sv[:, :n]


def _smallest_k_rows(kw, tplan: TopkPlan):
    """Per-row ascending smallest-k of (B, n) canonical key words, with
    the original column as payload.  One bucket round for the whole
    batch; θ and the candidate set are per row.

    Returns:
        ((B, k) words, (B, k) int32 columns).
    """
    b, n = kw[0].shape
    k, t, s, lp, m, ccap = (tplan.k, tplan.tile, tplan.s, tplan.lp,
                            tplan.m, tplan.ccap)
    dev = kw[0].device
    vals = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    kw, vals = _pad_max(kw, vals.contiguous(), lp)

    site = _topk_site(tplan)
    # Steps 1-3: tile sort of every row's tiles, samples from its epilogue.
    tkw, tv, samp_kw, samp_v = _launch(
        f"{site}/tiles", _sorter(tplan), ops.sort_tiles_sample,
        tuple(w.reshape(b * m, t) for w in kw), vals.reshape(b * m, t),
        num_samples=s, **_local_sort(tplan),
    )
    del kw, vals

    # Steps 4-5: sorted sample rows, s - 1 splitters per row.
    sskw, ssv = _sort_small_rows(
        tuple(w.reshape(b, m * s) for w in samp_kw), samp_v.reshape(b, m * s),
        tplan.sample_plan, tplan.length, tplan, f"{site}/samples",
    )
    sp_idx = torch.arange(1, s, device=dev) * (m * s) // s
    spkw_t = tuple(w[:, sp_idx].repeat_interleave(m, dim=0).contiguous()
                   for w in sskw)  # (b*m, s-1)
    spv_t = ssv[:, sp_idx].repeat_interleave(m, dim=0).contiguous()

    # Step 6: ranks, reduced per row.
    ranks = _launch(f"{site}/tiles", "splitter_ranks", ops.splitter_ranks,
                    tkw, tv, spkw_t, spv_t).reshape(b, m, s - 1)
    glob_ranks = ranks.sum(1, dtype=torch.int32)  # (b, s-1)

    # θ: the first splitter with global rank >= k (ranks are monotone in
    # the splitter).  If none qualifies, the last bucket alone exceeds
    # lp - k, so cap > lp - k and ccap covers every element.
    qualifies = (glob_ranks >= k).to(torch.int32)
    any_q = qualifies.amax(1) > 0  # (b,)
    theta = qualifies.argmax(1)  # first maximum: the first qualifying
    tile_rank = torch.where(
        any_q[:, None],
        torch.gather(ranks, 2, theta.view(b, 1, 1).expand(b, m, 1))[:, :, 0],
        t,
    )  # (b, m) elements of each tile below θ (or all)

    # Candidate pack: slot p of row q reads the tile whose prefix interval
    # of candidate counts covers p, at its first tile_rank positions (the
    # candidates are a prefix of each sorted tile).
    tile_excl = torch.cumsum(tile_rank, 1, dtype=torch.int32) - tile_rank
    total = tile_rank.sum(1, dtype=torch.int32)
    p = torch.arange(ccap, dtype=torch.int32, device=dev)
    src_tile = _chunk_search(tile_excl, p.expand(b, ccap).contiguous()).long()
    src_off = torch.gather(tile_excl, 1, src_tile)
    row_base = (torch.arange(b, device=dev) * m).unsqueeze(1)
    src = (row_base + src_tile) * t + (p - src_off)
    valid = p < total[:, None]
    src = src.masked_fill_(~valid, 0).reshape(-1)
    ckw = tuple(torch.where(valid, w.reshape(-1)[src].reshape(b, ccap), _PAD)
                for w in tkw)
    cv = torch.where(valid, tv.reshape(-1)[src].reshape(b, ccap), _INT_MAX)
    del tkw, tv, src

    fkw, fv = _sort_small_rows(ckw, cv, tplan.final_plan, tplan.length, tplan,
                               f"{site}/candidates")
    return tuple(w[:, :k] for w in fkw), fv[:, :k]


def _topk_site(tplan: TopkPlan) -> str:
    return (f"TopkPlan(rows={tplan.rows}, n={tplan.length}, k={tplan.k}, "
            f"strategy={tplan.strategy})")


def _fallback_topk_plan(x, k: int, tplan: TopkPlan) -> TopkPlan | None:
    """The CPU chain's second rung: the ``DEFAULT_CONFIG`` top-k plan of
    the same signature, or None when it equals the failing plan."""
    b, n = x.shape
    try:
        alt = build_topk_plan(n, k, x.dtype, DEFAULT_CONFIG, rows=b)
    except ValueError:
        return None
    return None if alt == tplan else alt


def topk(x, k: int, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Top-k (descending) values and original indices of 1-D ``x``.

    Args:
        x: 1-D scores of any codec dtype (``key_codec.SUPPORTED_DTYPES``).
        k: 1 <= k <= len(x).
        cfg: pipeline knobs (``descending`` is ignored: top-k is
            descending by definition).
        device: where to run (None = "cuda"; "cpu" runs the plain
            versions).  ``x`` is moved there.
    Returns:
        (values (k,) in x.dtype, indices (k,) int32); ties toward the
        smaller index, as ``jax.lax.top_k``.
    Raises:
        ValueError: unless x is 1-D and 1 <= k <= len(x).

    Example:
        >>> import torch
        >>> from repro_torch.core import topk
        >>> topk(torch.tensor([1.0, 9.0, 4.0, 9.0]), 2, device="cpu")
        (tensor([9., 9.]), tensor([1, 3], dtype=torch.int32))
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 1:
        raise ValueError(f"expected 1-D scores, got shape {tuple(x.shape)}")
    v, i = topk_batched(x[None], k, cfg, device=x.device)
    return v[0], i[0]


def topk_batched(x, k: int, cfg: SortConfig = DEFAULT_CONFIG, *, device=None):
    """Top-k (descending) values and column indices of every row of (B, C):
    one bucket round for the whole batch, the serving shape (batch,
    vocab) of logits.

    Args/Raises: as :func:`topk`, with x (B, C) and 1 <= k <= C.
    Returns:
        (values (B, k) in x.dtype, indices (B, k) int32).
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"expected (B, C) scores, got shape {tuple(x.shape)}")
    b, n = x.shape
    tplan = build_topk_plan(n, k, x.dtype, cfg, rows=b)
    if b == 0:
        return (torch.zeros((0, k), dtype=x.dtype, device=x.device),
                torch.zeros((0, k), dtype=torch.int32, device=x.device))
    guard.validate_check(cfg.check)
    codec = codec_for(x.dtype, descending=True)
    kw = codec.encode(x)  # ascending canonical == descending score

    def run(tp: TopkPlan):
        if n <= tp.direct_max:
            vals = torch.arange(n, dtype=torch.int32, device=x.device)
            fkw, fv = _sort_small_rows(kw, vals.expand(b, n).contiguous(),
                                       tp.final_plan, n, tp,
                                       f"{_topk_site(tp)}/rows")
            fkw, fv = tuple(w[:, :k] for w in fkw), fv[:, :k]
        else:
            fkw, fv = _smallest_k_rows(kw, tp)
        v, i = codec.decode(fkw), fv
        if cfg.check != "off":
            guard.check_topk(x, v, i, k, cfg.check, codec)
        return v, i

    def reference():
        # Ties toward the smaller index, as jax.lax.top_k: a stable sort
        # of the words with the column as tie-break, not torch.topk.
        tk, ti = ref.topk_desc(kw, k)
        v = codec.decode(tk)
        if cfg.check != "off":
            guard.check_topk(x, v, ti, k, cfg.check, codec)
        return v, ti

    try:
        return run(tplan)
    except Exception as e1:
        site = _topk_site(tplan)
        if not x.is_cuda:
            return guard.fall_back(site, run, _fallback_topk_plan(x, k, tplan),
                                   reference, e1)
        if not isinstance(e1, guard.SortRuntimeError):
            raise
        return guard.retry_once(site, lambda: run(tplan), e1)
