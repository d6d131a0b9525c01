"""Analytic cost model of a plan on the H100: rank schedules without
running them.

Port of the JAX package's ``core/cost_model.py``.  Regular sampling
makes the cost of a plan a function of its geometry, not of the data:
bytes moved per pass, compare counts, radix passes, merge levels and
kernel launches are all closed-form in the plan fields.
:func:`estimate` walks a ``SortPlan``, ``TopkPlan`` or ``ShardPlan`` and
returns one
number per channel, so the autotuner (``core/autotune.py``) can score
the whole candidate space and measure only the cheapest few.

Channels kept equal to the JAX package's: ``hbm_bytes`` (every pass's
reads and writes, the reference's ``_estimate_node`` / ``_estimate_topk``
formulas with gather relocation, the only one the port runs) and
``op_units`` of bitonic and merge levels.  Radix op units differ on
purpose: on the card K5 ranks 8-bit digits, four passes a key word,
whatever ``radix_bits`` says (``kernels/radix.py`` ``radix_geometry``),
so the port counts ``num_words * 32 / radix.DIGIT_BITS`` passes.

The TPU's terms (VMEM budget, lane and sublane alignment) become the
card's:

* ``smem_peak_bytes``: the most shared memory one CTA of any row sort of
  the plan takes (``bitonic.row_sort_geometry``,
  ``radix.radix_geometry``).  A plan with a row wider than
  ``bitonic.MAX_TILE``, or above 227 KB a CTA, does not run on the card
  and scores ``+inf``.
* ``launches``: the kernel launches of the plan's walk
  (``plan.kernel_launches`` / ``topk_launches``), each of which costs the
  host its wrapper's Python.
* ``glue_bytes``: the relocation and compaction bytes, a part of
  ``hbm_bytes``.  The executor computes them in PyTorch ops over int64
  indices, several passes each, which makes them the bulk of the device
  time (``PERF.md`` §5); they get a weight of their own.

A ``ShardPlan`` (the distributed sort) sums its four local sorts, as
the reference does, and adds ``collective_bytes``: a rank's deal, sample
gather and c_pair-padded exchange, the reference's channel, weighted by
``COLLECTIVE_BYTE_WEIGHT``.  It is 0 for single-device plans.

The unit is HBM byte-equivalents; ``total`` ranks plans and is not a
time.  ``total = hbm + GLUE_FACTOR*glue + OP_BYTE_EQUIV*ops +
LAUNCH_BYTE_EQUIV*launches + COLLECTIVE_BYTE_WEIGHT*collective``, the
first three constants fitted on an H100 (see below).  :func:`spearman` is the rank correlation the calibration
reports.

Distribution priors (``probe.priors_for``) shift only the
strategy-dependent op terms, as in the reference: sortedness discounts
the merge strategy's compares, low top-bits entropy penalizes radix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.plan import (
    SHARD_SUBPLANS,
    SORTERS,
    LevelPlan,
    ShardPlan,
    SortPlan,
    TopkPlan,
    kernel_launches,
    shard_launches,
    topk_launches,
)
from repro_torch.core.sort_config import next_pow2
from repro_torch.kernels import bitonic, radix

# Bump on any change to the constants or formulas below: autotuned store
# records carry this tag, and a mismatch is a clean re-tune.  A namespace
# of its own, apart from the JAX package's "cost_model/v1".
COST_MODEL_VERSION = "torch_cost_model/h100-v1"

# Fitted on an NVIDIA H100 80GB HBM3 at a 700 W power limit: the least
# squares fit, in log time, of the 11 candidates around DEFAULT_CONFIG
# at 2^26 int32 keys over ``chip_smoke.py``'s grid (its autotune phase
# prints the fit; PERF.md §6).  A glue byte costs nine plain ones (the
# executor's int64 index passes); launches fitted to no weight at 2^26,
# where 10 to 22 of them are under a millisecond of host time.
OP_BYTE_EQUIV = 0.1
GLUE_FACTOR = 8.0
LAUNCH_BYTE_EQUIV = 0.0
# Not fitted: one card has no interconnect to fit it on.  An H100 SXM's
# HBM3 moves 3.35 TB/s, one direction of its NVLink 4 450 GB/s (NVIDIA
# data sheet), so a byte sent to a peer costs 3.35e12 / 450e9 = 7.44 HBM
# bytes.  Single-device plans move none, so their totals do not depend
# on it.
COLLECTIVE_BYTE_WEIGHT = 3.35e12 / 450e9

# The reference's per-element work constants, unchanged.
RADIX_PASS_BASE = 3.0
RANK_UNITS_PER_BUCKET = 2.0
MERGE_SEARCH_FRACTION = 0.25
MERGE_LEVEL_BASE = 2.0
# Shared memory one CTA may take on the H100.
SMEM_BUDGET_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class Priors:
    """Distribution priors for the strategy-dependent op terms.

    ``sortedness``: fraction of adjacent pairs already in canonical order
    (0.5 = random); ``top_bits_entropy``: Shannon bits (at most 8) of the
    top byte of the most significant canonical word.  The defaults are
    the data-free neutral assumptions (random keys, full entropy);
    ``probe.priors_for`` measures both on a sample.
    """

    sortedness: float = 0.5
    top_bits_entropy: float = 8.0


DEFAULT_PRIORS = Priors()


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """The estimator's output, one number per channel.

    Attributes:
        hbm_bytes: device-memory bytes read and written across every
            pass of the plan (the reference's channel).
        op_units: compare units (compare-exchanges, radix pass work,
            merge-path searches, splitter ranking) across every level.
        glue_bytes: the relocation and compaction part of ``hbm_bytes``.
        launches: kernel launches of the plan's walk.
        smem_peak_bytes: the most shared memory a CTA of any of the
            plan's row sorts takes (rows the card can sort).
        collective_bytes: bytes one rank moves through collectives (a
            ShardPlan's; 0 for the others).
        total: the score the autotuner ranks by, in byte-equivalents;
            ``inf`` for a plan the card cannot run.
    """

    hbm_bytes: float
    op_units: float
    glue_bytes: float
    launches: int
    smem_peak_bytes: int
    total: float
    collective_bytes: float = 0.0

    def as_dict(self) -> dict:
        """The channels and the total; ``collective_bytes`` only for a
        plan that moves bytes between ranks (a ShardPlan's)."""
        d = dataclasses.asdict(self)
        if not self.collective_bytes:
            del d["collective_bytes"]
        return d


def _log2(x: int) -> int:
    return max(next_pow2(x).bit_length() - 1, 0)


def _stages(width: int) -> int:
    """Compare-exchange stages of the bitonic network on next_pow2(width)
    elements: L(L+1)/2."""
    lg = _log2(width)
    return lg * (lg + 1) // 2


def local_sort_op_units(width: int, num_words: int, strategy: str,
                        merge_run: int, priors: Priors) -> float:
    """Compare units per element of one local sort of ``width``.

    bitonic: ``stages(T) * (w+1)``, data-oblivious.
    radix: ``w * 32 / radix.DIGIT_BITS`` passes (K5's own digit width) at
        ``RADIX_PASS_BASE + log2(T)/4`` units each, scaled up as the
        top-bits entropy drops.
    merge: run formation ``stages(r)`` plus ``log2(T/r)`` merge levels at
        ``MERGE_SEARCH_FRACTION*log2(T) + MERGE_LEVEL_BASE`` units, all
        ``*(w+1)``, discounted as sortedness rises above 0.5.
    """
    wfac = num_words + 1  # key words + the payload tiebreak word
    lg = _log2(width)
    if strategy == "radix":
        passes = num_words * (32 // radix.DIGIT_BITS)
        per_pass = RADIX_PASS_BASE + lg / 4.0
        entropy = min(max(priors.top_bits_entropy, 0.0), 8.0)
        skew = 2.0 - entropy / 8.0  # 1.0 at full entropy, 2.0 degenerate
        return passes * per_pass * skew
    if strategy == "merge":
        r = min(next_pow2(merge_run), next_pow2(width))
        levels = max(lg - _log2(r), 0)
        merge = levels * (MERGE_SEARCH_FRACTION * lg + MERGE_LEVEL_BASE)
        p = min(max(priors.sortedness, 0.0), 1.0)
        discount = 1.0 - 1.4 * max(p - 0.5, 0.0)  # 0.3x at fully sorted
        return (_stages(r) + merge) * wfac * discount
    return _stages(width) * wfac  # bitonic


def _estimate_node(node: LevelPlan | None, nw: int,
                   priors: Priors) -> tuple[float, float, float]:
    """(hbm_bytes, op_units, glue_bytes) of a level tree."""
    if node is None:
        return 0.0, 0.0, 0.0
    bpe = 4 * (nw + 1)
    if node.kind == "direct":
        e = node.rows * node.lp
        ops = e * local_sort_op_units(node.lp, nw, node.strategy,
                                      node.merge_run, priors)
        return 2.0 * e * bpe, ops, 0.0  # one read + one write

    e = node.rows * node.lp                  # elements entering the round
    eb = node.rows * node.s_round * node.cap  # the bucket array
    # Step 2, the tile sort: one read and one write.
    hbm = 2.0 * e * bpe
    ops = e * local_sort_op_units(node.tile, nw, node.strategy,
                                  node.merge_run, priors)
    # Step 3: fused samples are the kernel's epilogue; unfused, one more
    # pass over the sorted tiles.
    if not node.fuse_sampling:
        hbm += e * bpe
    # Steps 6-7: one read of the tiles (K2), or ranks and counts (K3 and
    # a counting pass); ranking is linear in the bucket count.
    hbm += (1.0 if node.fuse_ranking else 2.0) * e * bpe
    ops += e * node.s_round * RANK_UNITS_PER_BUCKET * (nw + 1)
    # Step 8, gather relocation into the bucket array (with its source
    # search), then step 9's compaction back to dense rows.
    glue = (e + eb) * bpe + (eb + e) * bpe
    hbm += glue
    ops += eb * (_log2(node.m * node.s_round) + 1)
    for child in (node.sample_plan, node.bucket_plan):
        ch, co, cg = _estimate_node(child, nw, priors)
        hbm += ch
        ops += co
        glue += cg
    return hbm, ops, glue


def _smem_peak(launches: list, nw: int) -> tuple[int, bool]:
    """(the most shared memory a CTA of any row sort among ``launches``
    takes, whether the card runs them all): a row wider than
    ``bitonic.MAX_TILE`` has no kernel, and a CTA takes at most
    ``SMEM_BUDGET_BYTES``."""
    peak, runnable = 0, True
    for kernel, rows, width, _ in launches:
        if kernel not in SORTERS.values():
            continue
        if width > bitonic.MAX_TILE:
            runnable = False
        elif kernel == "radix_sort":
            peak = max(peak, radix.radix_geometry(rows, width, nw).shared_bytes)
        else:
            g = bitonic.row_sort_geometry(rows, width, nw)
            peak = max(peak, g.merge_shared_bytes if kernel == "merge_sort"
                       else g.shared_bytes)
    return peak, runnable and peak <= SMEM_BUDGET_BYTES


def _finish(hbm: float, ops: float, glue: float, launches: list,
            nw: int, coll: float = 0.0) -> CostBreakdown:
    smem, runnable = _smem_peak(launches, nw)
    total = (hbm + GLUE_FACTOR * glue + OP_BYTE_EQUIV * ops
             + LAUNCH_BYTE_EQUIV * len(launches)
             + COLLECTIVE_BYTE_WEIGHT * coll)
    return CostBreakdown(
        hbm_bytes=hbm, op_units=ops, glue_bytes=glue, launches=len(launches),
        smem_peak_bytes=smem, total=total if runnable else math.inf,
        collective_bytes=coll,
    )


def _estimate_sort(plan: SortPlan, priors: Priors) -> CostBreakdown:
    hbm, ops, glue = _estimate_node(plan.root, plan.num_words, priors)
    return _finish(hbm, ops, glue, kernel_launches(plan.root), plan.num_words)


def _estimate_topk(plan: TopkPlan, priors: Priors) -> CostBreakdown:
    # One key word, as in the reference (its TopkPlan has no num_words).
    nw, bpe = 1, 8
    launches = topk_launches(plan)
    if plan.length <= plan.direct_max:
        e = max(plan.rows, 1) * next_pow2(plan.length)
        ops = e * local_sort_op_units(plan.length, nw, plan.strategy,
                                      plan.merge_run, priors)
        return _finish(2.0 * e * bpe, ops, 0.0, launches, nw)
    e = max(plan.rows, 1) * plan.lp
    ec = max(plan.rows, 1) * plan.ccap
    # tile sort + threshold pass + candidate pack + candidate sort
    hbm = 2.0 * e * bpe + e * bpe + (e + ec) * bpe + 2.0 * ec * bpe
    ops = e * local_sort_op_units(plan.tile, nw, plan.strategy,
                                  plan.merge_run, priors)
    ops += ec * local_sort_op_units(plan.ccap, nw, plan.strategy,
                                    plan.merge_run, priors)
    return _finish(hbm, ops, 0.0, launches, nw)


def _estimate_shard(plan: ShardPlan, priors: Priors) -> CostBreakdown:
    # The dealt, sample and bucket phases sort concatenations of d sorted
    # runs: sorted in large part whatever the input, as in the reference.
    piecewise = dataclasses.replace(
        priors, sortedness=max(priors.sortedness, 0.75))
    hbm = ops = glue = 0.0
    for name in SHARD_SUBPLANS:
        sub: SortPlan = getattr(plan, name)
        hb, op, gl = _estimate_node(sub.root, sub.num_words,
                                    priors if name == "run_plan" else piecewise)
        hbm, ops, glue = hbm + hb, ops + op, glue + gl
    # The deal, the sample gather and the c_pair-padded exchange: padding
    # is charged in full, which lets the tuner weigh pair_align.
    coll = float(plan.collective_elements) * plan.bytes_per_element
    return _finish(hbm, ops, glue, shard_launches(plan), plan.num_words, coll)


def estimate(plan, priors: Priors | None = None) -> CostBreakdown:
    """Analytic cost of a plan: the autotuner's ranking score.

    Deterministic and pure: equal ``(plan, priors)`` give equal
    breakdowns; the total is positive and grows with n at fixed config
    geometry.

    Args:
        plan: a :class:`~repro_torch.core.plan.SortPlan`,
            :class:`~repro_torch.core.plan.TopkPlan` or
            :class:`~repro_torch.core.plan.ShardPlan`.
        priors: distribution priors (``probe.priors_for``); None means
            :data:`DEFAULT_PRIORS`.
    Returns:
        A :class:`CostBreakdown`; rank candidates by ``.total``.
    Raises:
        TypeError: for another type of plan.

    Example:
        >>> from repro_torch.core.cost_model import estimate
        >>> from repro_torch.core.plan import build_plan
        >>> from repro_torch.core.sort_config import SortConfig
        >>> cfg = SortConfig(tile=256, s=16, direct_max=512)
        >>> small = estimate(build_plan(10_000, "int32", cfg))
        >>> big = estimate(build_plan(80_000, "int32", cfg))
        >>> (small.total > 0, big.total > small.total)
        (True, True)
    """
    priors = DEFAULT_PRIORS if priors is None else priors
    if isinstance(plan, SortPlan):
        return _estimate_sort(plan, priors)
    if isinstance(plan, TopkPlan):
        return _estimate_topk(plan, priors)
    if isinstance(plan, ShardPlan):
        return _estimate_shard(plan, priors)
    raise TypeError(
        f"estimate() takes a SortPlan or TopkPlan (or a ShardPlan), got "
        f"{type(plan).__name__}"
    )


def spearman(a, b) -> float:
    """Spearman rank correlation of two equal-length sequences (ties
    ranked by position), the formula of the JAX package's cost-model
    test: 1 - 6 * sum(d^2) / (n (n^2 - 1))."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    n = len(a)

    def _ranks(v):
        r = np.empty(n)
        r[np.argsort(v, kind="stable")] = np.arange(n)
        return r

    ra, rb = _ranks(a), _ranks(b)
    return float(1.0 - 6.0 * np.sum((ra - rb) ** 2) / (n * (n * n - 1)))
