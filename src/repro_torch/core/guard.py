"""Guarded execution: runtime invariant checks and the degradation log.

The port's copy of the JAX package's ``core/guard.py``.  Regular
sampling makes every bucket capacity a static guarantee (``cap =
round_up(lp/s_round + lp/s, 128)``); ``SortConfig.check`` turns it into
a check at run time:

* ``check="bounds"`` verifies the capacity invariant on the measured
  bucket fills of every round: no bucket exceeds its capacity, and each
  row's fills sum to the padded row length (conservation).
* ``check="full"`` adds output post-conditions: a permutation checksum
  (per-row sum and XOR of the payloads, per-row sums of the key words,
  input against output) and lexicographic sortedness of the key words.

A violation raises :class:`SortRuntimeError` naming the plan node and
the invariant, never a silently corrupt result.  The checks compute on
the device of the tensors they are given and bring only per-row
scalars, or a count, to the host: at 2^26 keys a host copy of the
words and payloads would be about 0.5 GB a check.

The degradation side: :func:`with_retries` (bounded exponential backoff),
the two chains of a failed sort (:func:`retry_once` on the card,
:func:`fall_back` on the CPU; ``core/bucket_sort.py``
``_execute_packed`` says why they differ) and a bounded, lock-protected
:func:`degradation_log` fed by :func:`record_degradation`, each event
also issued as a :class:`DegradationWarning`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings

import torch

__all__ = [
    "CHECK_MODES",
    "SortRuntimeError",
    "DegradationWarning",
    "DegradationEvent",
    "record_degradation",
    "degradation_log",
    "clear_degradation_log",
    "with_retries",
    "retry_once",
    "fall_back",
    "validate_check",
    "bucket_spine",
    "plan_site",
    "check_bounds",
    "check_full",
    "check_topk",
]

#: Valid values of ``SortConfig.check``.
CHECK_MODES = ("off", "bounds", "full")


class SortRuntimeError(RuntimeError):
    """A runtime invariant of the sort engine was violated.

    Attributes:
        site: where: a plan-node path (e.g. ``"SortPlan(rows=1,
            length=65536, dtype=int32, strategy=bitonic)/level0:bucket(...)"``)
            or a named site (e.g. ``"baselines.randomized_sample_sort(n=8)"``).
        invariant: which guarantee failed, as a short expression (e.g.
            ``"bucket_fill <= cap"``).
        detail: the measured numbers behind the violation.
    """

    def __init__(self, site: str, invariant: str, detail: str = ""):
        self.site = site
        self.invariant = invariant
        self.detail = detail
        msg = f"sort invariant violated at {site}: {invariant}"
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)


class DegradationWarning(UserWarning):
    """A degradation chain retried, or fell back to another path."""


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One recorded retry or fallback step of a degradation chain."""

    site: str
    action: str      # "retry" | "fallback"
    frm: str         # what failed
    to: str          # what the chain moved to
    error: str       # repr of the triggering exception


_LOG_MAX = 256
_log_lock = threading.Lock()
_log: list[DegradationEvent] = []


def record_degradation(site: str, action: str, frm: str, to: str,
                       error: BaseException | str) -> DegradationEvent:
    """Append an event to the bounded degradation log and warn."""
    err = error if isinstance(error, str) else f"{type(error).__name__}: {error}"
    ev = DegradationEvent(site=site, action=action, frm=frm, to=to, error=err)
    with _log_lock:
        if len(_log) >= _LOG_MAX:
            del _log[0]
        _log.append(ev)
    warnings.warn(
        f"degraded at {site}: {frm} -> {to} ({action}) after {err}",
        DegradationWarning,
        stacklevel=3,
    )
    return ev


def degradation_log() -> tuple[DegradationEvent, ...]:
    """Snapshot of recorded degradation events (most recent last)."""
    with _log_lock:
        return tuple(_log)


def clear_degradation_log() -> None:
    with _log_lock:
        _log.clear()


def with_retries(fn, *, site: str, attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, retry_on=(Exception,),
                 sleep=time.sleep):
    """Call ``fn()`` with bounded retry and exponential backoff.

    Retries up to ``attempts`` total calls on ``retry_on`` exceptions,
    sleeping ``base_delay * 2**k`` (capped at ``max_delay``) between
    them and recording each retry in the degradation log.  The final
    failure re-raises the original exception.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            record_degradation(
                site, "retry", f"attempt {attempt + 1}", f"attempt {attempt + 2}", e
            )
            sleep(min(delay, max_delay))
            delay *= 2


def retry_once(site: str, attempt, first_error: BaseException):
    """The chain of a run on the card after ``first_error``: log a
    ``"retry"`` and call ``attempt()`` once more.  If it raises a
    :class:`SortRuntimeError` again, raise one at its site and invariant
    with ``first_error`` as the cause: the card never falls back to
    another path (``core/bucket_sort.py`` ``_execute_packed``)."""
    record_degradation(site, "retry", "the plan", "the same plan once more",
                       first_error)
    try:
        return attempt()
    except SortRuntimeError as e2:
        raise SortRuntimeError(
            e2.site, e2.invariant,
            f"failed on the run and on its retry: {e2.detail}"
        ) from first_error


def fall_back(site: str, run, alt, reference, first_error: BaseException):
    """The chain of a run on the CPU after ``first_error``, the JAX
    package's: ``run(alt)`` on the default-config plan ``alt`` (skipped
    when None), then ``reference()``, a stable sort; each step logged as
    a ``"fallback"``."""
    if alt is not None:
        record_degradation(site, "fallback", "the plan",
                           "the default-config plan", first_error)
        try:
            return run(alt)
        except Exception as e2:
            first_error = e2
    record_degradation(site, "fallback", "plan execution",
                       "stable sort reference", first_error)
    return reference()


def validate_check(check: str, name: str = "check") -> None:
    """Raise ValueError, naming ``name``, unless ``check`` is a valid
    checked-mode name."""
    if check not in CHECK_MODES:
        raise ValueError(f"{name} must be one of {CHECK_MODES}, got {check!r}")


# ----------------------------------------------------------------------
# Invariant checks (post-conditions on concrete outputs, on their device)
# ----------------------------------------------------------------------


def plan_site(plan) -> str:
    """Stable human-readable identity of a plan for error sites.  The
    port's plans hold no ``impl``: the local sort names the kernels."""
    return (f"SortPlan(rows={plan.rows}, length={plan.length}, "
            f"dtype={plan.dtype_name}, strategy={plan.root.strategy})")


def bucket_spine(plan) -> list:
    """The chain of bucket nodes the executor collects stats for, in
    stats order: the root's ``bucket_plan`` descent (sample recursions
    run without stats)."""
    nodes = []
    node = plan.root
    while node is not None and node.kind == "bucket":
        nodes.append(node)
        node = node.bucket_plan
    return nodes


def _node_site(plan, level: int, node) -> str:
    return (f"{plan_site(plan)}/level{level}:bucket(rows={node.rows}, "
            f"lp={node.lp}, s_round={node.s_round}, cap={node.cap})")


def check_bounds(plan, stats) -> None:
    """``check="bounds"``: the paper's capacity invariant on the measured
    bucket fills of every round (one stats entry per node of the plan's
    bucket spine):

    * the executor ran with the plan's capacity (``capacity == node.cap``);
    * ``max bucket fill <= cap``, the deterministic regular-sampling
      bound: a violation means relocation dropped elements;
    * each row's fills sum to the padded row length (conservation).

    Reads only the (rows, s_round) fills of each round.
    Raises :class:`SortRuntimeError` naming the plan node and invariant.
    """
    spine = bucket_spine(plan)
    if len(stats) != len(spine):
        raise SortRuntimeError(
            plan_site(plan), "len(stats) == len(bucket_spine)",
            f"executor reported {len(stats)} bucket rounds, plan has "
            f"{len(spine)}")
    for level, (node, st) in enumerate(zip(spine, stats)):
        site = _node_site(plan, level, node)
        cap = int(st["capacity"])
        if cap != node.cap:
            raise SortRuntimeError(
                site, "capacity == plan.cap",
                f"executor ran with capacity {cap}, plan says {node.cap}")
        totals = torch.as_tensor(st["totals"])
        if totals.numel() == 0:
            continue
        max_fill = int(totals.max())
        if max_fill > cap:
            raise SortRuntimeError(
                site, "bucket_fill <= cap",
                f"max bucket fill {max_fill} exceeds the deterministic "
                f"capacity {cap} (lp={int(st['level_len'])}, "
                f"s_round={int(st['s_round'])}): relocation dropped "
                f"elements / within >= cap")
        lp = int(st["level_len"])
        row_sums = totals.sum(1, dtype=torch.int64)
        bad = int((row_sums != lp).sum())
        if bad:
            raise SortRuntimeError(
                site, "sum(bucket_fills) == lp",
                f"{bad} row(s) have bucket fills summing to "
                f"{int(row_sums.min())}..{int(row_sums.max())}, expected "
                f"{lp}: elements lost or duplicated in relocation")


def _row_xor(v: torch.Tensor) -> torch.Tensor:
    """Per-row XOR of an (r, L) integer tensor as int64.  torch has no
    XOR reduction: the row is zero-padded to a power of two and folded
    in halves."""
    r, n = v.shape
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        v = torch.cat([v, v.new_zeros((r, width - n))], 1)
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] ^ v[:, half:]
    return v[:, 0].long()


def _row_checksums(kw, vals):
    """Per-row (sum, xor) of the payloads and per-word sums, all int64 on
    the tensors' device: order-invariant fingerprints for the
    permutation check.  The words are biased (``core/key_codec``), so
    ``2^31`` is added back per element: the sums equal those of the
    canonical uint32 words."""
    sums = vals.sum(1, dtype=torch.int64)
    xors = _row_xor(vals)
    wsums = tuple(w.sum(1, dtype=torch.int64) + w.shape[1] * 2**31 for w in kw)
    return sums, xors, wsums


def _inversions(words) -> int:
    """Adjacent lexicographic inversions in (r, L) biased key words, whose
    signed order is the canonical words' unsigned order."""
    if words[0].shape[1] < 2:
        return 0
    gt = torch.zeros((words[0].shape[0], words[0].shape[1] - 1),
                     dtype=torch.bool, device=words[0].device)
    eq = torch.ones_like(gt)
    for w in words:
        a, b = w[:, :-1], w[:, 1:]
        gt |= eq & (a > b)
        eq &= a == b
    return int(gt.sum())


def check_full(plan, in_kw, in_vals, out_kw, out_vals) -> None:
    """``check="full"``: output post-conditions, after :func:`check_bounds`.

    * permutation checksum: per-row sum and XOR of the int32 payloads
      and per-row sums of each key word match between input and output
      (catches dropped, duplicated or corrupted elements that conserve
      bucket counts);
    * sortedness: adjacent key words are lexicographically
      non-decreasing in every row.
    """
    site = f"{plan_site(plan)}/output"
    in_s, in_x, in_w = _row_checksums(in_kw, in_vals)
    out_s, out_x, out_w = _row_checksums(out_kw, out_vals)
    bad = int(((in_s != out_s) | (in_x != out_x)).sum())
    if bad:
        raise SortRuntimeError(
            site, "payload permutation checksum",
            f"{bad} row(s): output payloads are not a permutation of the "
            f"input payloads (elements dropped or duplicated)")
    for wi, (a, b) in enumerate(zip(in_w, out_w)):
        bad = int((a != b).sum())
        if bad:
            raise SortRuntimeError(
                site, "key-word permutation checksum",
                f"word {wi}: {bad} row(s) changed key content through the "
                f"sort")
    inv = _inversions(out_kw)
    if inv:
        raise SortRuntimeError(
            site, "output sortedness",
            f"{inv} adjacent inversion(s) in the canonical key words")


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width: gathered and compared
    bit for bit (torch's CPU gather of bfloat16 rewrites NaN bits)."""
    return t.view(_BITS[t.element_size()])


def check_topk(x, vals, idx, k: int, check: str, codec) -> None:
    """Checked-mode post-conditions for top-k (``core/partial_sort``).

    ``"bounds"``: indices lie in [0, n).  ``"full"`` adds: per-row index
    uniqueness, bitwise ``vals == x[idx]`` (on the raw bits, so NaN-safe),
    and descending order of ``vals`` under the dtype's total order (the
    descending key ``codec``'s words are non-decreasing).
    """
    xs = torch.as_tensor(x)
    if xs.dim() == 1:
        xs = xs[None, :]
    v = torch.as_tensor(vals).reshape(-1, k)
    ix = torch.as_tensor(idx).reshape(-1, k)
    rows, n = xs.shape
    site = f"topk(rows={rows}, n={n}, k={k})"
    if int(((ix < 0) | (ix >= n)).sum()):
        raise SortRuntimeError(
            site, "0 <= idx < n",
            f"indices outside [0, {n}): "
            f"min={int(ix.min())}, max={int(ix.max())}")
    if check != "full":
        return
    ixl = ix.long()
    seen = torch.zeros((rows, n), dtype=torch.bool, device=xs.device)
    seen.scatter_(1, ixl, True)
    if int((seen.sum(1) != k).sum()):
        raise SortRuntimeError(
            site, "idx unique per row", "duplicate indices returned")
    if not torch.equal(torch.gather(_raw_bits(xs), 1, ixl), _raw_bits(v)):
        raise SortRuntimeError(
            site, "vals == x[idx] (bitwise)",
            "returned values disagree with the gathered indices")
    inv = _inversions(codec.encode(v))
    if inv:
        raise SortRuntimeError(
            site, "vals descending",
            f"{inv} adjacent inversion(s) in top-k values")
