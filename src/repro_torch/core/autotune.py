"""Plan autotuner: a search over the sort-plan space pruned by the cost
model and measured on the caller's device, with a persistent plan store.

Port of the single-device half of the JAX package's
``core/autotune.py``.  The planner makes the schedule explicit data;
this module picks the best schedule for a signature.  Every candidate
of the space is scored by the analytic cost model
(``core/cost_model.estimate``), and only the ``measure_budget``
cheapest-predicted candidates are timed on real runs: the base config
(candidate 0) always among them, so the winner is never slower than the
default schedule up to timer noise.  Candidates the card cannot run
(cost ``inf``) are not timed.  ``measure_budget=None`` measures every
candidate.

Measurement runs on the device the caller names (None means "cuda"):
on CUDA tensors each candidate runs its kernels, timed on the host's
clock around work that ends in ``torch.cuda.synchronize()``; nothing is
measured on the CPU for a card, and no candidate falls back to PyTorch
code.  A candidate that fails its retries (a kernel error, running out
of device memory, an injected ``autotune.measure`` fault) is excluded,
warned about and denylisted for the signature.

The store: plans are kept under ``(rows, length, dtype, order, device,
cfg fingerprint)``, where the device is ``torch.cuda.get_device_name()``
for a card and ``"cpu"`` otherwise, so a plan tuned on the CPU is never
served on a card.  It lives at ``$REPRO_TORCH_SORT_PLAN_CACHE`` (default
``~/.cache/repro_torch_sort/plans.json``), apart from the JAX package's
store, with a schema and cost-model version of its own; writes are
atomic (tmp + ``os.replace``); a corrupt file is quarantined; a record
tuned under another cost-model version is a clean miss.  On a miss,
:func:`plan_for` seeds the measured set with the cached winner at the
nearest signature (same dtype, order and device) and measures at most
two candidates.

``SortConfig(plan="autotune")`` routes the sort entry points through
:func:`plan_for`; ``SortConfig(plan=<path>)`` reads a file written by
:func:`save_plan` (``bucket_sort.resolve_plan``).

The distributed half (:func:`shard_plan_for`, :func:`autotune_shard`)
tunes a :class:`~repro_torch.core.plan.ShardPlan` over the ranks of a
process group: every rank times every candidate (each one a run of the
distributed sort, so all ranks issue the same collectives), the times
are reduced (MAX) over the group, so every rank picks the same winner,
and a failed measurement is agreed on before anyone retries.  Rank 0
alone reads and writes the store and hands the others what it found.
Shard records share the store under ``shard|`` keys, which hold the
device and the group's backend: a plan tuned through gloo on one card
is never served to an NCCL group.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bucket_sort, cost_model, faults, guard
from repro_torch.core.key_codec import codec_for
from repro_torch.core.plan import (
    ShardPlan,
    SortPlan,
    build_plan,
    build_shard_plan,
    plan_from_dict,
    plan_to_dict,
    shard_plan_from_dict,
    shard_plan_to_dict,
)
from repro_torch.core.sort_config import SortConfig, next_pow2
from repro_torch.kernels import bitonic
from repro_torch.kernels.ops import resolve_device

_CACHE_ENV = "REPRO_TORCH_SORT_PLAN_CACHE"
_STORE_SCHEMA = "torch_sort_plan_cache/v1"

# Process-local memo, so a warm signature never reads the store again.
_MEMO: dict[str, SortPlan] = {}
# Plan files (SortConfig(plan=<path>)) by (path, mtime_ns): one stat()
# a call, and an updated file is read again.
_FILE_MEMO: dict[tuple, SortPlan] = {}


def cache_path() -> str:
    """The store's location: ``$REPRO_TORCH_SORT_PLAN_CACHE``, else
    ``~/.cache/repro_torch_sort/plans.json``."""
    env = os.environ.get(_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch_sort",
                        "plans.json")


def device_identity(device) -> str:
    """The device part of a store key: the card's name, or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def cache_key(plan: SortPlan, device) -> str:
    """The store key of a signature: (rows, length, dtype, descending,
    device, the requesting config's fingerprint)."""
    return "|".join(str(x) for x in (
        plan.rows, plan.length, plan.dtype_name, plan.descending,
        device_identity(device), plan.cfg_fingerprint))


def _fresh_store() -> dict:
    return {"schema": _STORE_SCHEMA, "plans": {}, "denylist": {}}


def _quarantine_store(path: str, err: Exception) -> None:
    """Move a corrupt store aside to ``<path>.corrupt-<pid>`` (never
    overwrite it in place: the bytes survive for inspection, and the
    next save writes a clean store), and warn."""
    qpath = f"{path}.corrupt-{os.getpid()}"
    try:
        os.replace(path, qpath)
    except OSError:
        qpath = "<rename failed; left in place>"
    warnings.warn(
        f"plan cache {path} is corrupt ({type(err).__name__}: {err}); "
        f"quarantined to {qpath} and rebuilding a clean store",
        guard.DegradationWarning,
        stacklevel=3,
    )


def _load_store(path: str) -> dict:
    """Read the JSON store; an empty store on any failure (a broken cache
    never breaks a sort).  Corrupt JSON is quarantined; an unreadable
    file (an I/O error, an injected ``cache.load`` fault) warns."""
    try:
        faults.check("cache.load")
        with open(path) as f:
            store = json.load(f)
    except FileNotFoundError:
        return _fresh_store()
    except json.JSONDecodeError as e:
        _quarantine_store(path, e)
        return _fresh_store()
    except (faults.FaultInjected, OSError) as e:
        warnings.warn(
            f"plan cache {path} unreadable ({type(e).__name__}: {e}); "
            f"continuing with an empty store",
            guard.DegradationWarning,
            stacklevel=2,
        )
        return _fresh_store()
    if not isinstance(store, dict) or store.get("schema") != _STORE_SCHEMA:
        return _fresh_store()
    store.setdefault("denylist", {})
    return store


def _write_json(path: str, payload: dict) -> None:
    """Write ``payload`` to ``path`` atomically (tmp + os.replace)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _save_store(path: str, store: dict) -> None:
    faults.check("cache.save")
    _write_json(path, store)


def _persist_store(path: str, store: dict) -> None:
    """Persist the store; a failed save (an I/O error, an injected
    ``cache.save`` fault) leaves the tuned plan in the process memo only,
    recorded as a degradation."""
    try:
        _save_store(path, store)
    except (faults.FaultInjected, OSError) as e:
        guard.record_degradation(
            "cache.save", "fallback", f"persist to {path}",
            "process-memo only (store not written)", e)


def save_plan(plan: SortPlan, path: str, *, meta: dict | None = None) -> None:
    """Write one plan to ``path`` as a plan file, the format
    ``SortConfig(plan=<path>)`` and :func:`load_plan` read."""
    payload = plan_to_dict(plan)
    if meta:
        payload["meta"] = meta
    _write_json(path, payload)


def load_plan(path: str, *, length: int | None = None, dtype=None,
              cfg: SortConfig | None = None, rows: int = 1) -> SortPlan:
    """Read a plan file written by :func:`save_plan`.

    With a call's signature (``length``, ``dtype``, ``rows``, as
    ``resolve_plan`` passes for ``SortConfig(plan=<path>)``) the file's
    plan must match it in shape, dtype and order.  The plan's tunables
    (tile, s, strategy, ...) override the requesting config's: that is
    what a tuned plan is for.

    Raises:
        ValueError: for a file that is not a plan record of the port, or
            a plan built for another signature.
    """
    fkey = (path, os.stat(path).st_mtime_ns)
    plan = _FILE_MEMO.get(fkey)
    if plan is None:
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict):
            raise ValueError(f"plan file {path} holds no plan record")
        d.pop("meta", None)
        plan = plan_from_dict(d)
        _FILE_MEMO[fkey] = plan
    if length is not None:
        want = (rows, length, codec_for(dtype).dtype_name,
                cfg.descending if cfg else plan.descending)
        got = (plan.rows, plan.length, plan.dtype_name, plan.descending)
        if want != got:
            raise ValueError(
                f"plan file {path} was built for (rows, length, dtype, "
                f"descending)={got}, call needs {want}"
            )
    return plan


# ----------------------------------------------------------------------
# Candidate space
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space (a whole SortConfig)."""

    cfg: SortConfig
    label: str


def _direct_max_for(tile: int) -> int:
    """The direct_max a tile above the config's own gets: twice the tile
    as in the JAX package, but no row wider than the row sorts take."""
    return min(2 * tile, bitonic.MAX_TILE)


def candidate_space(cfg: SortConfig, length: int, *,
                    max_trials: int = 16) -> list[Candidate]:
    """Deterministic, ordered candidates around ``cfg``, the JAX
    package's order and labels: the base config (candidate 0), the other
    strategies, tile, s, tile x s and the fusion pair, nearest first,
    deduplicated, truncated to ``max_trials``.

    The port's differences (ROADMAP.md Queue 3): no ``block_rows`` axis
    (the port has no such field), no ``relocation="scatter"`` candidate
    (not ported), a tile above ``cfg.direct_max`` grows it to
    ``min(2*tile, bitonic.MAX_TILE)`` so that no direct row is wider than
    a row-sort kernel takes (a tile that would need more is dropped), and
    the base is candidate 0 even when its tile exceeds the padded length
    (the JAX package's space then starts with another candidate, or is
    empty).
    At 2^26 around ``DEFAULT_CONFIG`` that leaves 11 candidates.
    """
    tiles = [cfg.tile, cfg.tile * 2, max(cfg.tile // 2, 128), cfg.tile * 4]
    svals = [cfg.s, cfg.s * 2, max(cfg.s // 2, 2), cfg.s * 4]
    fusions = [(True, True), (False, False)]
    if not cfg.fuse_sampling:
        fusions.reverse()

    seen: set[SortConfig] = set()
    out: list[Candidate] = []

    def _add(**kw):
        if len(out) >= max_trials:
            return
        t = kw.get("tile", cfg.tile)
        s = kw.get("s", cfg.s)
        # A tile past the padded length is no candidate, but the base
        # always is: the speedup is measured against it.
        if s > t or t % s != 0 or (kw and t > max(next_pow2(length), 128)):
            return
        # Grow direct_max only when a larger tile needs it: candidate 0
        # must be the requesting config itself.
        if t > cfg.direct_max:
            kw.setdefault("direct_max", _direct_max_for(t))
        kw.setdefault("plan", "default")
        try:
            cand = dataclasses.replace(cfg, **kw)
        except ValueError:
            return
        if cand in seen:
            return
        seen.add(cand)
        bits = ",".join(f"{k}={v}" for k, v in sorted(kw.items())
                        if k not in ("direct_max", "plan"))
        out.append(Candidate(cfg=cand, label=bits or "base"))

    _add()  # the base config: candidate 0, the speedup reference
    for st in ("bitonic", "radix", "merge"):
        if st != cfg.strategy:
            _add(strategy=st)
    for t in tiles:
        _add(tile=t)
    for s in svals:
        _add(s=s)
    for t in tiles[:2]:
        for s in svals[:2]:
            _add(tile=t, s=s)
    for fs, fr in fusions:
        _add(fuse_sampling=fs, fuse_ranking=fr)
    return out


# ----------------------------------------------------------------------
# Measurement
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrialResult:
    label: str
    us_per_call: float


@dataclasses.dataclass(frozen=True)
class CandidateScore:
    """Predicted (and, when measured, observed) cost of one candidate.

    Attributes:
        index: position in the candidate space (0 = base config).
        label: the candidate's config-delta label.
        predicted: ``cost_model.estimate(...).total`` (``inf`` for a plan
            the card cannot run or the planner refuses).
        us_per_call: median measured microseconds, or None when the
            candidate was not measured (pruned, unrunnable, or failed).
    """

    index: int
    label: str
    predicted: float
    us_per_call: float | None = None


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """Outcome of one tuning run.

    Attributes:
        best_plan / best_label: the measured-fastest candidate.
        best_us / default_us: median wall microseconds of the winner and
            of candidate 0 (the requesting config); ``speedup`` is their
            ratio.
        trials: every measured candidate, in candidate order.
        candidates: predicted against measured for every candidate.
        measure_budget: the budget of the run (None = every candidate).
        cost_model_version: the cost model the run pruned with.
        failed: (label, error) of every candidate that failed its
            retries; ``plan_for`` denylists them.
        skipped: labels excluded up front by the caller's denylist.
    """

    best_plan: SortPlan
    best_label: str
    best_us: float
    default_us: float
    trials: tuple[TrialResult, ...]
    candidates: tuple[CandidateScore, ...] = ()
    measure_budget: int | None = None
    cost_model_version: str = cost_model.COST_MODEL_VERSION
    failed: tuple[tuple[str, str], ...] = ()
    skipped: tuple[str, ...] = ()

    @property
    def speedup(self) -> float:
        return self.default_us / self.best_us if self.best_us else 1.0


def _validate_budget(measure_budget) -> None:
    if measure_budget is None:
        return
    if not isinstance(measure_budget, int) or isinstance(
        measure_budget, bool
    ) or measure_budget < 1:
        raise ValueError(
            f"measure_budget must be an int >= 1 (candidates to time) or "
            f"None for the exhaustive measured search, got "
            f"{measure_budget!r}"
        )


def _select_measured(predicted: list[float], measure_budget: int | None,
                     mandatory: list[int]) -> list[int]:
    """Indices to time: the mandatory set (base config, transfer seeds),
    then the cheapest predicted up to the budget; equal predictions go
    to the lower candidate index."""
    if measure_budget is None:
        return list(range(len(predicted)))
    chosen = list(dict.fromkeys(mandatory))
    ranked = sorted(range(len(predicted)), key=lambda i: (predicted[i], i))
    for i in ranked:
        if len(chosen) >= measure_budget:
            break
        if i not in chosen:
            chosen.append(i)
    return sorted(chosen)


def _measure(fn, x: torch.Tensor, *, repeats: int, warmup: int = 1) -> float:
    """Median wall microseconds of ``fn(x)`` after ``warmup`` calls; on a
    card each call ends in ``torch.cuda.synchronize()``.  Checks the
    ``autotune.measure`` fault site once."""
    faults.check("autotune.measure")
    return _time_calls(fn, x, repeats=repeats, warmup=warmup)


def _time_calls(fn, x: torch.Tensor, *, repeats: int, warmup: int) -> float:
    """Median wall microseconds of ``fn(x)`` after ``warmup`` calls."""

    def call():
        fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


# Retry policy of a candidate's measurement: _MEASURE_ATTEMPTS tries with
# exponential backoff from _MEASURE_BASE_DELAY seconds, then the
# candidate is excluded and denylisted.
_MEASURE_ATTEMPTS = 3
_MEASURE_BASE_DELAY = 0.02


def _measure_candidate(fn, x, label: str, *, repeats: int,
                       warmup: int = 1) -> tuple[float | None, str | None]:
    """One candidate's guarded measurement: bounded retries, then (None,
    error string) for the caller to denylist."""
    try:
        us = guard.with_retries(
            lambda: _measure(fn, x, repeats=repeats, warmup=warmup),
            site=f"autotune.measure[{label}]",
            attempts=_MEASURE_ATTEMPTS,
            base_delay=_MEASURE_BASE_DELAY,
        )
        return us, None
    except Exception as e:  # terminal after the retries: report, denylist
        err = f"{type(e).__name__}: {e}"
    if x.is_cuda:  # what a candidate that ran out of memory left cached
        torch.cuda.empty_cache()
    warnings.warn(
        f"autotune candidate {label!r} failed to measure after "
        f"{_MEASURE_ATTEMPTS} attempts ({err}); excluded from this run "
        f"and denylisted for the signature",
        guard.DegradationWarning,
        stacklevel=2,
    )
    return None, err


def _sample_input(length: int, dtype, rows: int, seed: int,
                  device="cpu") -> torch.Tensor:
    """Seeded uniform keys of ``dtype`` for measurement, drawn as the JAX
    package draws them, then moved to ``device``."""
    name = codec_for(dtype).dtype_name
    rng = np.random.default_rng(seed)
    shape = (length,) if rows == 1 else (rows, length)
    if name == "bfloat16":  # numpy has no bfloat16: draw as a float
        return torch.from_numpy(rng.standard_normal(shape)).to(
            device=device, dtype=torch.bfloat16)
    npdt = np.dtype(name)
    if npdt.kind == "f":
        x = rng.standard_normal(shape).astype(npdt)
    elif npdt.kind == "b":
        x = rng.integers(0, 2, shape).astype(npdt)
    elif npdt.kind == "u":
        x = rng.integers(0, np.iinfo(npdt).max, shape, dtype=np.uint64).astype(npdt)
    else:
        info = np.iinfo(npdt)
        x = rng.integers(info.min, info.max, shape, dtype=np.int64).astype(npdt)
    return torch.from_numpy(x).to(device)


def autotune(length: int, dtype, cfg: SortConfig, *, rows: int = 1,
             device=None, max_trials: int = 16, repeats: int = 3,
             warmup: int = 1, seed: int = 0, measure_budget: int | None = 5,
             priors: cost_model.Priors | None = None,
             seed_cfgs: tuple[SortConfig, ...] = (),
             denylist: frozenset[str] = frozenset()) -> AutotuneResult:
    """Score every candidate's plan with the cost model, time the
    ``measure_budget`` cheapest (the base config always among them) on
    seeded data on ``device``, and return the measured winner.

    Args:
        device: where to measure (None = "cuda"; "cpu" runs the plain
            versions).
        measure_budget: candidates to time (None = every candidate).
        priors: the cost model's distribution priors
            (``probe.priors_for``); None assumes random keys.
        seed_cfgs: extra configs appended to the space and always
            measured (:func:`plan_for`'s transfer from a nearby winner).
        denylist: candidate labels never to measure.

    Candidates the card cannot run (predicted ``inf``) are measured only
    when mandatory.  Raises :class:`guard.SortRuntimeError` when no
    candidate measures.
    """
    _validate_budget(measure_budget)
    dev = resolve_device(device)
    x = _sample_input(length, dtype, rows, seed, dev)

    cands = candidate_space(cfg, length, max_trials=max_trials)
    mandatory = [0]
    seen_cfgs = {c.cfg for c in cands}
    for sc in seed_cfgs:
        sc = dataclasses.replace(sc, plan="default")
        if sc in seen_cfgs:
            mandatory.append(next(i for i, c in enumerate(cands) if c.cfg == sc))
            continue
        seen_cfgs.add(sc)
        cands.append(Candidate(cfg=sc, label="transfer"))
        mandatory.append(len(cands) - 1)

    plans: list[SortPlan | None] = []
    predicted: list[float] = []
    for cand in cands:
        try:
            plan = build_plan(length, dtype, cand.cfg, rows=rows)
        except ValueError:  # a level that cannot shrink (ROADMAP.md D2)
            plans.append(None)
            predicted.append(math.inf)
            continue
        plans.append(plan)
        predicted.append(cost_model.estimate(plan, priors=priors).total)

    measured = set(_select_measured(predicted, measure_budget, mandatory))
    measured -= {i for i in measured if plans[i] is None or (
        math.isinf(predicted[i]) and i not in mandatory)}
    skipped = tuple(c.label for i, c in enumerate(cands)
                    if i in measured and c.label in denylist)
    measured -= {i for i, c in enumerate(cands) if c.label in denylist}
    trials: list[TrialResult] = []
    scores: list[CandidateScore] = []
    failed: list[tuple[str, str]] = []
    best_plan, best_label = None, ""
    best_us, default_us = math.inf, math.inf
    for i, cand in enumerate(cands):
        us = None
        if i in measured:
            us, err = _measure_candidate(
                lambda a, p=plans[i]: bucket_sort.sort_planned(a, p, device=a.device),
                x, cand.label, repeats=repeats, warmup=warmup)
            if err is not None:
                failed.append((cand.label, err))
        scores.append(CandidateScore(index=i, label=cand.label,
                                     predicted=predicted[i], us_per_call=us))
        if us is None:
            continue
        trials.append(TrialResult(label=cand.label, us_per_call=us))
        if i == 0:
            default_us = us
        if us < best_us:
            best_plan, best_label, best_us = plans[i], cand.label, us
    if best_plan is None:
        raise guard.SortRuntimeError(
            "autotune.measure", "at least one candidate measured",
            f"all {len(measured)} measured candidate(s) failed "
            f"({len(skipped)} denylisted) for length={length} rows={rows}")
    return AutotuneResult(
        best_plan=best_plan, best_label=best_label, best_us=best_us,
        default_us=default_us, trials=tuple(trials), candidates=tuple(scores),
        measure_budget=measure_budget, failed=tuple(failed), skipped=skipped,
    )


# ----------------------------------------------------------------------
# The cfg.plan == "autotune" entry: store or tune (with transfer)
# ----------------------------------------------------------------------


def _record_is_current(rec) -> bool:
    """A stored record counts only if it was tuned under the current
    cost-model version; any other is a clean miss that re-tunes."""
    return (isinstance(rec, dict)
            and rec.get("cost_model") == cost_model.COST_MODEL_VERSION)


def _cfg_from_winner_plan(plan: SortPlan, cfg: SortConfig) -> SortConfig | None:
    """The config of a stored winner's root level, over the requesting
    ``cfg`` (the transfer seed); None when no valid config expresses it."""
    node = plan.root
    kw: dict = dict(plan="default", strategy=node.strategy,
                    radix_bits=node.radix_bits, merge_run=node.merge_run)
    if node.kind == "bucket":
        kw.update(tile=node.tile, s=node.s, fuse_sampling=node.fuse_sampling,
                  fuse_ranking=node.fuse_ranking)
        if node.tile > cfg.direct_max:
            kw["direct_max"] = _direct_max_for(node.tile)
    try:
        return dataclasses.replace(cfg, **kw)
    except ValueError:
        return None


def _nearest_plan_record(store: dict, base: SortPlan, key: str,
                         device_id: str) -> tuple[SortPlan, str] | None:
    """The stored winner at the signature nearest ``base``: the same
    dtype, order and device, then the same config fingerprint first, the
    nearest log2 length, the nearest log2 rows (ties on the key)."""
    want = (base.dtype_name, str(base.descending), device_id)
    best = None
    for k, rec in store["plans"].items():
        if k == key or not _record_is_current(rec):
            continue
        parts = k.split("|")
        if len(parts) != 6 or tuple(parts[2:5]) != want:
            continue
        try:
            rows_k, length_k = int(parts[0]), int(parts[1])
            plan = plan_from_dict(rec["plan"])
        except (ValueError, TypeError, KeyError):
            continue
        dist = (
            0 if parts[5] == base.cfg_fingerprint else 1,
            abs(np.log2(max(length_k, 1)) - np.log2(max(base.length, 1))),
            abs(np.log2(max(rows_k, 1)) - np.log2(max(base.rows, 1))),
            k,
        )
        if best is None or dist < best[0]:
            best = (dist, plan, k)
    return (best[1], best[2]) if best else None


def plan_for(length: int, dtype, cfg: SortConfig, *, rows: int = 1,
             device=None, path: str | None = None, max_trials: int = 16,
             repeats: int = 3, measure_budget: int | None = 5,
             priors: cost_model.Priors | None = None,
             transfer: bool = True) -> SortPlan:
    """The stored or tuned plan of a signature (``plan="autotune"``).

    Lookup order: the process memo, the store at ``path`` (default
    :func:`cache_path`), then :func:`autotune` on ``device`` (None =
    "cuda") and persist the winner.  The device is part of the key.  A
    record reloaded from the store equals the one saved; a record of
    another cost-model version is a miss.  On a miss with ``transfer``
    the measured set is seeded with the nearest signature's winner and
    at most two candidates are measured.
    """
    dev = resolve_device(device)
    device_id = device_identity(dev)
    base = build_plan(length, dtype, cfg, rows=rows)
    key = cache_key(base, dev)
    if key in _MEMO:
        return _MEMO[key]
    path = path or cache_path()
    store = _load_store(path)
    rec = store["plans"].get(key)
    if _record_is_current(rec):
        try:
            plan = plan_from_dict(rec["plan"])
        except (ValueError, KeyError):
            pass  # an older plan schema: re-tune and overwrite
        else:
            _MEMO[key] = plan
            return plan

    seed_cfgs: tuple[SortConfig, ...] = ()
    budget = measure_budget
    transfer_from = None
    if transfer and measure_budget is not None:
        near = _nearest_plan_record(store, base, key, device_id)
        if near is not None:
            seed_cfg = _cfg_from_winner_plan(near[0], cfg)
            if seed_cfg is not None:
                seed_cfgs = (seed_cfg,)
                budget = min(measure_budget, 2)
                transfer_from = near[1]

    deny = store.get("denylist", {}).get(key, {})
    result = autotune(
        length, dtype, cfg, rows=rows, device=dev, max_trials=max_trials,
        repeats=repeats, measure_budget=budget, priors=priors,
        seed_cfgs=seed_cfgs, denylist=frozenset(deny))
    if result.failed:
        store.setdefault("denylist", {}).setdefault(key, {}).update(
            dict(result.failed))
    store["plans"][key] = dict(
        plan=plan_to_dict(result.best_plan),
        label=result.best_label,
        best_us=round(result.best_us, 1),
        default_us=round(result.default_us, 1),
        speedup=round(result.speedup, 3),
        cost_model=result.cost_model_version,
        measure_budget=result.measure_budget,
        measured=sum(1 for c in result.candidates if c.us_per_call is not None),
        candidates=len(result.candidates),
        **({"transfer_from": transfer_from} if transfer_from else {}),
    )
    _persist_store(path, store)
    _MEMO[key] = result.best_plan
    return result.best_plan


# ----------------------------------------------------------------------
# The distributed half: ShardPlans over the ranks of a process group
# ----------------------------------------------------------------------

# Process-local memo of tuned shard plans (the role of _MEMO).
_SHARD_MEMO: dict[str, ShardPlan] = {}


def shard_cache_key(plan: ShardPlan, device, backend: str) -> str:
    """The store key of a distributed signature: ``shard|`` and the plan's
    axis, d, n_local, dtype, order, oversample and pair_align, then the
    device (:func:`device_identity`), the group's backend and the config's
    fingerprint."""
    sig = plan.signature()
    return "shard|" + "|".join(str(x) for x in (
        *sig[:-1], device_identity(device), backend, sig[-1]))


@dataclasses.dataclass(frozen=True)
class ShardCandidate:
    """One point of the distributed search space."""

    cfg: SortConfig
    oversample: int
    pair_align: int
    label: str


def shard_candidate_space(cfg: SortConfig, *, oversample: int = 8,
                          pair_align: int = 8,
                          max_trials: int = 8) -> list[ShardCandidate]:
    """Deterministic, ordered distributed candidates, the JAX package's
    order and labels: the base (the requested config, oversample and
    pair_align) first, then the other local-sort strategies, oversample
    x2, /2, x4, then pair_align 128 and 256; deduplicated, truncated to
    ``max_trials``."""
    seen: set[tuple] = set()
    out: list[ShardCandidate] = []

    def _add(label: str, *, strategy=None, osamp=None, palign=None):
        if len(out) >= max_trials:
            return
        o = oversample if osamp is None else osamp
        pa = pair_align if palign is None else palign
        if o < 1 or o & (o - 1) or pa < 8 or pa & (pa - 1):
            return
        try:
            cand_cfg = dataclasses.replace(
                cfg, plan="default", **({"strategy": strategy} if strategy else {}))
        except ValueError:
            return
        key = (cand_cfg, o, pa)
        if key in seen:
            return
        seen.add(key)
        out.append(ShardCandidate(cfg=cand_cfg, oversample=o, pair_align=pa,
                                  label=label))

    _add("base")
    for st in ("bitonic", "radix", "merge"):
        if st != cfg.strategy:
            _add(f"strategy={st}", strategy=st)
    for o in (oversample * 2, max(oversample // 2, 1), oversample * 4):
        _add(f"oversample={o}", osamp=o)
    for pa in (128, 256):
        _add(f"pair_align={pa}", palign=pa)
    return out


def _measure_shard_candidate(run, x, label: str, comm, *, repeats: int,
                             warmup: int) -> tuple[float | None, str | None]:
    """One distributed candidate's measurement on every rank: the
    ``autotune.measure`` fault site agreed on before any run (so all ranks
    retry together), bounded retries, then the slowest rank's median, or
    (None, error) on every rank when a rank failed."""

    def attempt():
        err = None
        try:
            faults.check("autotune.measure")
        except faults.FaultInjected as e:
            err = e
        if comm.any_failed(err is not None):
            raise err or guard.SortRuntimeError(
                "autotune.measure", "every rank measures",
                "failed on another rank")
        return _time_calls(run, x, repeats=repeats, warmup=warmup)

    us, err = math.inf, None
    try:
        us = guard.with_retries(attempt, site=f"autotune.measure[{label}]",
                                attempts=_MEASURE_ATTEMPTS,
                                base_delay=_MEASURE_BASE_DELAY)
    except Exception as e:  # terminal after the retries: report, denylist
        err = f"{type(e).__name__}: {e}"
    us = comm.max(us)
    if math.isinf(us):
        err = err or "failed on another rank"
        warnings.warn(
            f"distributed autotune candidate {label!r} failed to measure "
            f"after {_MEASURE_ATTEMPTS} attempts ({err}); excluded from this "
            f"run and denylisted for the signature",
            guard.DegradationWarning, stacklevel=2)
        return None, err
    return us, None


def autotune_shard(group, axis, n_global: int, dtype, cfg: SortConfig, *,
                   device=None, oversample: int = 8, pair_align: int = 8,
                   max_trials: int = 8, repeats: int = 2, warmup: int = 1,
                   seed: int = 0, measure_budget: int | None = 5,
                   priors: cost_model.Priors | None = None,
                   seed_candidates: tuple[ShardCandidate, ...] = (),
                   denylist: frozenset[str] = frozenset()) -> AutotuneResult:
    """Score every distributed candidate's ShardPlan with the cost model
    (its collective bytes included), time the ``measure_budget`` cheapest
    (the base always among them) with the distributed sort over
    ``group`` on seeded data on ``device`` (None = "cuda"), and return the
    measured winner, the same on every rank.

    Every rank of the group must call it with the same arguments.  Each
    rank takes its shard of one seeded global array; a candidate's time
    is the slowest rank's median.

    Raises:
        guard.SortRuntimeError: when no candidate measures.
    """
    from repro_torch.core import distributed_sort

    _validate_budget(measure_budget)
    dev = resolve_device(device)
    axt = (axis,) if isinstance(axis, str) else tuple(axis)
    comm = distributed_sort._Comm(group, dev)
    d, me = comm.d, comm.me
    n_loc = n_global // d
    x = _sample_input(n_global, dtype, 1, seed)[me * n_loc:(me + 1) * n_loc].to(dev)

    space = shard_candidate_space(cfg, oversample=oversample,
                                  pair_align=pair_align, max_trials=max_trials)
    mandatory = [0]
    seen = {(c.cfg, c.oversample, c.pair_align) for c in space}
    for sc in seed_candidates:
        k = (sc.cfg, sc.oversample, sc.pair_align)
        if k in seen:
            mandatory.append(next(i for i, c in enumerate(space)
                                  if (c.cfg, c.oversample, c.pair_align) == k))
            continue
        seen.add(k)
        space.append(sc)
        mandatory.append(len(space) - 1)

    plans: list[ShardPlan | None] = []
    predicted: list[float] = []
    for cand in space:
        try:
            plan = build_shard_plan(axt, d, n_loc, dtype, cand.cfg,
                                    oversample=cand.oversample,
                                    pair_align=cand.pair_align)
        except ValueError:  # a sub-plan level that cannot shrink (D2)
            plans.append(None)
            predicted.append(math.inf)
            continue
        plans.append(plan)
        predicted.append(cost_model.estimate(plan, priors=priors).total)

    measured = set(_select_measured(predicted, measure_budget, mandatory))
    measured -= {i for i in measured if plans[i] is None or (
        math.isinf(predicted[i]) and i not in mandatory)}
    skipped = tuple(c.label for i, c in enumerate(space)
                    if i in measured and c.label in denylist)
    measured -= {i for i, c in enumerate(space) if c.label in denylist}
    trials: list[TrialResult] = []
    scores: list[CandidateScore] = []
    failed: list[tuple[str, str]] = []
    best_plan, best_label = None, ""
    best_us, default_us = math.inf, math.inf
    for i, cand in enumerate(space):
        us = None
        if i in measured:
            us, err = _measure_shard_candidate(
                distributed_sort.shard_runner(plans[i], group), x, cand.label,
                comm, repeats=repeats, warmup=warmup)
            if err is not None:
                failed.append((cand.label, err))
        scores.append(CandidateScore(index=i, label=cand.label,
                                     predicted=predicted[i], us_per_call=us))
        if us is None:
            continue
        trials.append(TrialResult(label=cand.label, us_per_call=us))
        if i == 0:
            default_us = us
        if us < best_us:
            best_plan, best_label, best_us = plans[i], cand.label, us
    if best_plan is None:
        raise guard.SortRuntimeError(
            "autotune.measure", "at least one candidate measured",
            f"all {len(measured)} measured distributed candidate(s) failed "
            f"({len(skipped)} denylisted) for n_global={n_global} D={d}")
    return AutotuneResult(
        best_plan=best_plan, best_label=best_label, best_us=best_us,
        default_us=default_us, trials=tuple(trials), candidates=tuple(scores),
        measure_budget=measure_budget, failed=tuple(failed), skipped=skipped,
    )


def _nearest_shard_record(store: dict, base: ShardPlan, key: str,
                          device_id: str,
                          backend: str) -> tuple[ShardPlan, str] | None:
    """The stored distributed winner nearest ``base``: the same dtype,
    order, device and backend, then the same config fingerprint first,
    the nearest log2 shard length, the nearest log2 d (ties on the key)."""
    want = (base.dtype_name, str(base.descending), device_id, backend)
    best = None
    for k, rec in store["plans"].items():
        if k == key or not k.startswith("shard|") or not _record_is_current(rec):
            continue
        parts = k.split("|")[1:]
        if len(parts) != 10 or (parts[3], parts[4], parts[7], parts[8]) != want:
            continue
        try:
            d_k, n_local_k = int(parts[1]), int(parts[2])
            plan = shard_plan_from_dict(rec["plan"])
        except (ValueError, TypeError, KeyError):
            continue
        dist_k = (
            0 if parts[9] == base.cfg_fingerprint else 1,
            abs(np.log2(max(n_local_k, 1)) - np.log2(max(base.n_local, 1))),
            abs(np.log2(max(d_k, 1)) - np.log2(max(base.d, 1))),
            k,
        )
        if best is None or dist_k < best[0]:
            best = (dist_k, plan, k)
    return (best[1], best[2]) if best else None


def _shard_seed_from_record(plan: ShardPlan,
                            cfg: SortConfig) -> ShardCandidate | None:
    """Transfer seed: a stored winner's oversample and pair_align and its
    run-phase local sort, over the requesting ``cfg``."""
    node = plan.run_plan.root
    try:
        seed_cfg = dataclasses.replace(
            cfg, plan="default", strategy=node.strategy,
            radix_bits=node.radix_bits, merge_run=node.merge_run)
    except ValueError:
        return None
    return ShardCandidate(cfg=seed_cfg, oversample=plan.oversample,
                          pair_align=plan.pair_align, label="transfer")


def _shard_lookup(key: str, base: ShardPlan, cfg: SortConfig, path: str,
                  transfer: bool, measure_budget: int | None, device_id: str,
                  backend: str) -> dict:
    """Rank 0's reading of the memo and the store: the plan on a hit,
    else what a tuning run needs (seeds, budget, denylist)."""
    if key in _SHARD_MEMO:
        return {"plan": _SHARD_MEMO[key]}
    store = _load_store(path)
    rec = store["plans"].get(key)
    if _record_is_current(rec):
        try:
            return {"plan": shard_plan_from_dict(rec["plan"])}
        except (ValueError, KeyError):
            pass  # an older plan schema: re-tune and overwrite
    miss = {"plan": None, "store": store, "seeds": (),
            "budget": measure_budget, "transfer_from": None,
            "deny": frozenset(store.get("denylist", {}).get(key, {}))}
    if transfer and measure_budget is not None:
        near = _nearest_shard_record(store, base, key, device_id, backend)
        if near is not None:
            seed = _shard_seed_from_record(near[0], cfg)
            if seed is not None:
                miss.update(seeds=(seed,), budget=min(measure_budget, 2),
                            transfer_from=near[1])
    return miss


def shard_plan_for(group, axis, n_global: int, dtype, cfg: SortConfig, *,
                   oversample: int = 8, pair_align: int = 8, device=None,
                   path: str | None = None, max_trials: int = 8,
                   repeats: int = 2, measure_budget: int | None = 5,
                   priors: cost_model.Priors | None = None,
                   transfer: bool = True) -> ShardPlan:
    """The stored or tuned distributed plan of a signature, the same on
    every rank of ``group`` (``make_sharded_sort``'s ``plan="autotune"``).

    Every rank must call it with the same arguments.  Rank 0 looks in its
    memo and the store at ``path`` (default :func:`cache_path`), keyed by
    :func:`shard_cache_key`, and broadcasts what it found.  On a miss
    every rank runs :func:`autotune_shard` on ``device`` (None = "cuda"),
    seeded from the nearest stored distributed winner (at most two
    measured) when ``transfer``; rank 0 persists the winner, then the
    group meets at a barrier, so a later lookup finds it.
    """
    dev = resolve_device(device)
    axt = (axis,) if isinstance(axis, str) else tuple(axis)
    d = dist.get_world_size(group)
    backend = dist.get_backend(group)
    base = build_shard_plan(axt, d, n_global // d, dtype, cfg,
                            oversample=oversample, pair_align=pair_align)
    key = shard_cache_key(base, dev, backend)
    first = dist.get_rank(group) == 0
    path = path or cache_path()
    found = [None]
    if first:
        found[0] = _shard_lookup(key, base, cfg, path, transfer,
                                 measure_budget, device_identity(dev), backend)
        store = found[0].pop("store", None)
    dist.broadcast_object_list(found, src=dist.get_global_rank(group, 0)
                               if group is not None else 0, group=group)
    state = found[0]
    if state["plan"] is not None:
        # Keep this rank's own object when it is rank 0's plan, so that a
        # warm call returns the same object on every rank.
        if _SHARD_MEMO.get(key) != state["plan"]:
            _SHARD_MEMO[key] = state["plan"]
        return _SHARD_MEMO[key]

    result = autotune_shard(
        group, axt, n_global, dtype, cfg, device=dev, oversample=oversample,
        pair_align=pair_align, max_trials=max_trials, repeats=repeats,
        measure_budget=state["budget"], priors=priors,
        seed_candidates=state["seeds"], denylist=state["deny"])
    if first:
        if result.failed:
            store.setdefault("denylist", {}).setdefault(key, {}).update(
                dict(result.failed))
        store["plans"][key] = dict(
            plan=shard_plan_to_dict(result.best_plan),
            label=result.best_label,
            best_us=round(result.best_us, 1),
            default_us=round(result.default_us, 1),
            speedup=round(result.speedup, 3),
            cost_model=result.cost_model_version,
            measure_budget=result.measure_budget,
            measured=sum(1 for c in result.candidates
                         if c.us_per_call is not None),
            candidates=len(result.candidates),
            **({"transfer_from": state["transfer_from"]}
               if state["transfer_from"] else {}),
        )
        _persist_store(path, store)
    dist.barrier(group)
    _SHARD_MEMO[key] = result.best_plan
    return result.best_plan


def save_shard_plan(plan: ShardPlan, path: str, *,
                    meta: dict | None = None) -> None:
    """Write one distributed plan to ``path``, the file
    ``SortConfig(plan=<path>)`` runs through ``make_sharded_sort``."""
    payload = shard_plan_to_dict(plan)
    if meta:
        payload["meta"] = meta
    _write_json(path, payload)


def load_shard_plan(path: str, *, axis=None, d: int | None = None,
                    n_local: int | None = None, dtype=None,
                    cfg: SortConfig | None = None) -> ShardPlan:
    """Read a distributed plan file written by :func:`save_shard_plan`.

    With a call's signature (``d`` given, as ``make_sharded_sort`` passes
    for ``SortConfig(plan=<path>)``) the file's plan must match its axis,
    d, shard length, dtype and order.

    Raises:
        ValueError: for a file that is not a shard-plan record of the port,
            or a plan built for another signature.
    """
    fkey = (path, os.stat(path).st_mtime_ns)
    plan = _FILE_MEMO.get(fkey)
    if not isinstance(plan, ShardPlan):
        with open(path) as f:
            rec = json.load(f)
        if not isinstance(rec, dict):
            raise ValueError(f"shard plan file {path} holds no plan record")
        rec.pop("meta", None)
        plan = shard_plan_from_dict(rec)
        _FILE_MEMO[fkey] = plan
    if d is not None:
        axt = (axis,) if isinstance(axis, str) else tuple(axis)
        want = (axt, d, n_local, codec_for(dtype).dtype_name,
                cfg.descending if cfg else plan.descending)
        got = (plan.axis, plan.d, plan.n_local, plan.dtype_name,
               plan.descending)
        if want != got:
            raise ValueError(
                f"shard plan file {path} was built for (axis, d, n_local, "
                f"dtype, descending)={got}, call needs {want}")
    return plan


def clear_memo() -> None:
    """Drop the process-local memos (tests use this to force the store)."""
    _MEMO.clear()
    _SHARD_MEMO.clear()
    _FILE_MEMO.clear()
