"""The port's autotuner and plan store against the JAX package's.

``candidate_space`` must be the reference's list (taken with
``max_trials=1000``) with the port's three rules applied: no
``block_rows`` candidates, no ``relocation="scatter"`` ones, and a tile
above ``direct_max`` growing it to ``min(2*tile, bitonic.MAX_TILE)``
(dropped when that is below the tile), then truncated again.
The base is candidate 0 even when its tile exceeds the length (the
reference's list then lacks it).  ``_select_measured`` must equal the
reference's.  The store keeps the
reference's semantics (round trip, stale version, quarantine, transfer,
denylist) with the device in the key.  ``SortConfig(plan="autotune")``
and ``plan=<path>`` must give results bit-equal to the JAX package's
``impl="xla"`` sorts.  Measurement runs on the CPU here (the plain
versions), at small sizes; every store lives in ``tmp_path``.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from test_torch_bucket_sort import reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import autotune as jax_autotune  # noqa: E402
from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    autotune,
    bucket_sort,
    cost_model,
    faults,
    guard,
    partial_sort,
)
from repro_torch.core.plan import build_plan, plan_to_dict  # noqa: E402
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig  # noqa: E402
from repro_torch.kernels import bitonic  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = dict(tile=256, s=16, direct_max=512)
CFG = SortConfig(**GEOMETRY)
N = 2000


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch, tmp_path):
    """A store of the test's own, empty memos and fault counters."""
    monkeypatch.setenv("REPRO_TORCH_SORT_PLAN_CACHE", str(tmp_path / "plans.json"))
    autotune.clear_memo()
    faults.reset()
    guard.clear_degradation_log()
    yield
    autotune.clear_memo()
    faults.reset()


def measured_labels(monkeypatch):
    """The label of every candidate measurement from here on."""
    labels = []
    real = autotune._measure_candidate

    def spy(fn, x, label, **kw):
        labels.append(label)
        return real(fn, x, label, **kw)
    monkeypatch.setattr(autotune, "_measure_candidate", spy)
    return labels


def tune(path, length=N, cfg=CFG, **kw):
    kw.setdefault("repeats", 1)
    return autotune.plan_for(length, "int32", cfg, device="cpu", path=str(path), **kw)


# ----------------------------------------------------------------------
# Candidate space and selection against the reference
# ----------------------------------------------------------------------

SPACE_CONFIGS = {
    "default": dict(tile=4096, s=64, direct_max=8192),
    "small": GEOMETRY,
    "tile16384": dict(tile=16384, s=64, direct_max=16384),
    "tile2048": dict(tile=2048, s=32, direct_max=2048),
    "radix": dict(tile=4096, s=64, direct_max=8192, strategy="radix"),
    "nofuse": dict(tile=4096, s=64, direct_max=8192, fuse_sampling=False,
                   fuse_ranking=False),
    "s4": dict(tile=8192, s=4, direct_max=16384),
}


def reference_space(kw, length, max_trials):
    """The reference's candidates with the port's rules applied: the
    three of the module docstring, and the base first whatever its tile."""
    cfg = JaxConfig(**kw, impl="xla")
    out = []
    for c in jax_autotune.candidate_space(cfg, length, max_trials=1000):
        if "block_rows" in c.label or "relocation" in c.label:
            continue
        t = c.cfg.tile
        direct_max = c.cfg.direct_max
        if t > cfg.direct_max:
            direct_max = min(2 * t, bitonic.MAX_TILE)
            if direct_max < t:
                continue
        out.append((c.label, t, c.cfg.s, direct_max, c.cfg.strategy,
                    c.cfg.fuse_sampling, c.cfg.fuse_ranking, c.cfg.radix_bits,
                    c.cfg.merge_run, c.cfg.plan))
    if not out or out[0][0] != "base":  # its tile exceeds the length
        out.insert(0, ("base", cfg.tile, cfg.s, cfg.direct_max, cfg.strategy,
                       cfg.fuse_sampling, cfg.fuse_ranking, cfg.radix_bits,
                       cfg.merge_run, "default"))
    return out[:max_trials]


@pytest.mark.parametrize("max_trials", [16, 5, 1000])
@pytest.mark.parametrize("length", [1 << 26, 1 << 14, 20_000, 300])
@pytest.mark.parametrize("name", list(SPACE_CONFIGS))
def test_candidate_space_is_the_references_filtered(name, length, max_trials):
    kw = SPACE_CONFIGS[name]
    got = [(c.label, c.cfg.tile, c.cfg.s, c.cfg.direct_max, c.cfg.strategy,
            c.cfg.fuse_sampling, c.cfg.fuse_ranking, c.cfg.radix_bits,
            c.cfg.merge_run, c.cfg.plan)
           for c in autotune.candidate_space(SortConfig(**kw), length,
                                             max_trials=max_trials)]
    assert got == reference_space(kw, length, max_trials)
    assert got[0][0] == "base"


def test_candidate_space_around_the_default_at_2_26():
    cands = autotune.candidate_space(DEFAULT_CONFIG, 1 << 26)
    assert [c.label for c in cands] == [
        "base", "strategy=radix", "strategy=merge", "tile=8192", "tile=2048",
        "tile=16384", "s=128", "s=32", "s=256", "s=128,tile=8192",
        "fuse_ranking=False,fuse_sampling=False"]
    assert cands[0].cfg == dataclasses.replace(DEFAULT_CONFIG, plan="default")
    assert {c.cfg.direct_max for c in cands if c.cfg.tile > 8192} == {16384}
    assert all(math.isfinite(cost_model.estimate(
        build_plan(1 << 26, "int32", c.cfg)).total) for c in cands)


@pytest.mark.parametrize("predicted,budget,mandatory", [
    ([3.0, 1.0, 1.0, 1.0, 2.0], 3, [0]),
    ([3.0, 1.0, 1.0, 1.0, 2.0], 2, [0, 4]),
    ([3.0, 1.0, 1.0, 1.0, 2.0], None, [0]),
    ([5.0, 4.0, math.inf, 1.0, 2.0, 3.0, 0.5], 5, [0]),
    ([1.0, math.inf, math.inf], 5, [0]),
    ([2.0, 1.0, 3.0, 1.0], 1, [0, 2]),
])
def test_select_measured_equals_the_reference(predicted, budget, mandatory):
    assert autotune._select_measured(predicted, budget, mandatory) == (
        jax_autotune._select_measured(predicted, budget, mandatory))


@pytest.mark.parametrize("bad", [0, -3, 1.5, "five", True])
def test_measure_budget_validation_names_the_field(bad):
    with pytest.raises(ValueError, match="measure_budget"):
        autotune.autotune(N, "int32", CFG, device="cpu", measure_budget=bad)


def test_base_config_always_measured_even_at_budget_one(monkeypatch):
    labels = measured_labels(monkeypatch)
    res = autotune.autotune(N, "int32", CFG, device="cpu", max_trials=6,
                            repeats=1, measure_budget=1)
    assert labels == ["base"] and res.best_label == "base"
    assert [c.index for c in res.candidates if c.us_per_call is not None] == [0]
    assert len(res.candidates) == len(autotune.candidate_space(CFG, N, max_trials=6))
    assert all(math.isfinite(c.predicted) for c in res.candidates)
    assert res.cost_model_version == cost_model.COST_MODEL_VERSION
    assert res.speedup == 1.0


def test_candidates_the_card_cannot_run_are_not_measured(monkeypatch):
    """A plan with rows past bitonic.MAX_TILE scores inf and is measured
    only as the base: here every candidate sorts 1000 keys in one direct
    row of 1024, past a MAX_TILE of 512."""
    monkeypatch.setattr(bitonic, "MAX_TILE", 512)
    labels = measured_labels(monkeypatch)
    res = autotune.autotune(1000, "int32", SortConfig(tile=256, s=16, direct_max=1024),
                            device="cpu", repeats=1, measure_budget=None)
    assert len(res.candidates) > 1
    assert all(math.isinf(c.predicted) for c in res.candidates)
    assert labels == ["base"] and res.best_label == "base"


def test_a_candidate_that_runs_out_of_memory_is_denylisted(monkeypatch, tmp_path):
    """A candidate whose run fails (here a device out-of-memory error on
    every radix plan) is excluded after its retries, warned about, and
    persisted to the signature's denylist; the tuner goes on."""
    real = bucket_sort.sort_planned

    def oom_on_radix(keys, plan, check="off", *, device=None):
        if plan.root.strategy == "radix":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(keys, plan, check, device=device)
    monkeypatch.setattr(bucket_sort, "sort_planned", oom_on_radix)
    labels = measured_labels(monkeypatch)
    with pytest.warns(guard.DegradationWarning, match="strategy=radix"):
        plan = tune(tmp_path / "plans.json", measure_budget=None)
    assert plan.root.strategy != "radix" and "strategy=radix" in labels
    store = json.load(open(tmp_path / "plans.json"))
    (deny,) = store["denylist"].values()
    assert list(deny) == ["strategy=radix"] and "OutOfMemoryError" in deny["strategy=radix"]
    autotune.clear_memo()
    labels.clear()
    with pytest.warns(guard.DegradationWarning):  # a fresh store: measured
        tune(tmp_path / "plans2.json", measure_budget=None)
    assert "strategy=radix" in labels


def test_every_candidate_failing_raises_at_the_site(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("no candidate runs")
    monkeypatch.setattr(bucket_sort, "sort_planned", fail)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        with pytest.raises(guard.SortRuntimeError) as ei:
            autotune.autotune(N, "int32", CFG, device="cpu", repeats=1,
                              max_trials=3)
    assert ei.value.site == "autotune.measure"


# ----------------------------------------------------------------------
# The store
# ----------------------------------------------------------------------


def test_store_round_trip_is_equal_and_warm_hits_measure_nothing(tmp_path):
    path = tmp_path / "plans.json"
    plan = tune(path)
    key = autotune.cache_key(build_plan(N, "int32", CFG), "cpu")
    assert key.split("|")[4] == "cpu"
    store = json.load(open(path))
    assert store["schema"] == "torch_sort_plan_cache/v1"
    rec = store["plans"][key]
    assert rec["cost_model"] == cost_model.COST_MODEL_VERSION
    assert rec["measured"] == 5 and rec["candidates"] == 11
    faults.reset()
    assert tune(path) is plan  # the memo: the same object
    autotune.clear_memo()
    assert tune(path) == plan  # the store: an equal plan
    assert faults.hits("autotune.measure") == 0
    assert faults.hits("cache.load") == 1


def test_a_stale_cost_model_version_is_a_clean_miss(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    tune(path)
    store = json.load(open(path))
    (key,) = store["plans"]
    store["plans"][key]["cost_model"] = "torch_cost_model/h100-v0"
    path.write_text(json.dumps(store))
    autotune.clear_memo()
    labels = measured_labels(monkeypatch)
    tune(path, transfer=False)
    assert len(labels) == 5
    assert json.load(open(path))["plans"][key]["cost_model"] == (
        cost_model.COST_MODEL_VERSION)


def test_a_corrupt_store_is_quarantined(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text("{not json")
    with pytest.warns(guard.DegradationWarning, match="quarantined"):
        plan = tune(path)
    assert (tmp_path / f"plans.json.corrupt-{os.getpid()}").read_text() == "{not json"
    assert json.load(open(path))["plans"]  # a clean store, rebuilt
    assert plan.length == N


def test_a_transfer_measures_at_most_two_candidates(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    tune(path)
    labels = measured_labels(monkeypatch)
    plan = tune(path, length=3000)
    assert len(labels) <= 2 and labels[0] == "base"
    assert plan.length == 3000
    rec = next(v for k, v in json.load(open(path))["plans"].items()
               if k.startswith("1|3000|"))
    assert rec["transfer_from"].split("|")[1] == str(N)
    assert rec["measured"] <= 2
    autotune.clear_memo()
    labels.clear()
    tune(path, length=4000, transfer=False, measure_budget=None)
    assert len(labels) == 11


def test_a_denylisted_candidate_is_skipped(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    key = autotune.cache_key(build_plan(N, "int32", CFG), "cpu")
    store = autotune._fresh_store()
    store["denylist"][key] = {"strategy=radix": "RuntimeError: earlier run"}
    path.write_text(json.dumps(store))
    labels = measured_labels(monkeypatch)
    tune(path, measure_budget=None)
    assert "strategy=radix" not in labels and len(labels) == 10
    res = autotune.autotune(N, "int32", CFG, device="cpu", repeats=1,
                            denylist=frozenset({"base"}))
    assert res.skipped == ("base",) and res.default_us == math.inf


def test_a_plan_tuned_for_another_device_is_never_served(tmp_path, monkeypatch):
    """A record under a card's name, for the same signature, is neither
    served to a CPU call nor used as its transfer seed."""
    path = tmp_path / "plans.json"
    base = build_plan(N, "int32", CFG)
    card_key = autotune.cache_key(base, "cpu").replace("|cpu|", "|NVIDIA H100 80GB HBM3|")
    radix_plan = build_plan(N, "int32", dataclasses.replace(CFG, strategy="radix"))
    store = autotune._fresh_store()
    store["plans"][card_key] = dict(plan=plan_to_dict(radix_plan),
                                    cost_model=cost_model.COST_MODEL_VERSION)
    path.write_text(json.dumps(store))
    labels = measured_labels(monkeypatch)
    tune(path)
    assert len(labels) == 5  # a full tune: no hit, no transfer
    rec = json.load(open(path))["plans"][autotune.cache_key(base, "cpu")]
    assert "transfer_from" not in rec


def test_plan_files_round_trip_and_refuse_other_signatures(tmp_path):
    plan = build_plan(N, "int32", dataclasses.replace(CFG, strategy="merge"))
    path = str(tmp_path / "plan.json")
    autotune.save_plan(plan, path, meta={"label": "strategy=merge"})
    assert autotune.load_plan(path) == plan
    assert autotune.load_plan(path, length=N, dtype=torch.int32, cfg=CFG) == plan
    for kw in (dict(length=N + 1, dtype="int32"), dict(length=N, dtype="float32"),
               dict(length=N, dtype="int32", rows=2),
               dict(length=N, dtype="int32", cfg=SortConfig(descending=True))):
        with pytest.raises(ValueError, match="was built for"):
            autotune.load_plan(path, **kw)
    with pytest.raises(ValueError, match="was built for"):
        bucket_sort.sort(torch.zeros(N + 1, dtype=torch.int32),
                         SortConfig(plan=path), device="cpu")
    other = tmp_path / "jax.json"
    other.write_text(json.dumps({"schema": "sort_plan/v2", "root": None}))
    with pytest.raises(ValueError, match="torch_sort_plan/v1"):
        autotune.load_plan(str(other))


# ----------------------------------------------------------------------
# The entry points against the JAX package
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int32", "float32", "int64"])
def test_autotuned_and_plan_file_sorts_match_reference(dtype, tmp_path):
    """plan="autotune" and plan=<path> through sort / argsort / sort_kv,
    the batched forms and the segmented sort: bit-equal to the JAX
    package's impl="xla" sorts."""
    rng = np.random.default_rng(["int32", "float32", "int64"].index(dtype))
    a = make_keys(dtype, 1500, rng)
    b = make_keys(dtype, 3 * 700, rng).reshape(3, 700)
    v = rng.standard_normal(1500).astype(np.float32)
    offsets = [0, 0, 1, 5, 600, 600, 900, 1200]
    jcfg = JaxConfig(**GEOMETRY, impl="xla")
    want = [
        reference(lambda x: jax_sort.sort(x, jcfg), a, dtype=dtype),
        reference(lambda x: jax_sort.argsort(x, jcfg), a, dtype=dtype),
        reference(lambda x, y: jax_sort.sort_kv(x, y, jcfg), a, v, dtype=dtype),
        reference(lambda x: jax_sort.sort_batched(x, jcfg), b, dtype=dtype),
        reference(lambda x: jax_sort.argsort_batched(x, jcfg), b, dtype=dtype),
        reference(lambda x: jax_sort.segment_sort(x, offsets, jcfg), a[:1200],
                  dtype=dtype),
        reference(lambda x: jax_sort.segment_argsort(x, offsets, jcfg), a[:1200],
                  dtype=dtype),
    ]

    def run(cfg):
        x, xb = to_torch(a), to_torch(b)
        return [
            bucket_sort.sort(x, cfg, device="cpu"),
            bucket_sort.argsort(x, cfg, device="cpu"),
            bucket_sort.sort_kv(x, torch.from_numpy(v), cfg, device="cpu"),
            bucket_sort.sort_batched(xb, cfg, device="cpu"),
            bucket_sort.argsort_batched(xb, cfg, device="cpu"),
            bucket_sort.segment_sort(x[:1200], offsets, cfg, device="cpu"),
            bucket_sort.segment_argsort(x[:1200], offsets, cfg, device="cpu"),
        ]

    tuned = dataclasses.replace(CFG, plan="autotune")
    for got in (run(tuned), run(tuned)):  # cold, then warm
        for g, w in zip(got, want):
            if isinstance(w, tuple):
                for gi, wi in zip(g, w):
                    np.testing.assert_array_equal(bits(gi), bits(wi))
            else:
                np.testing.assert_array_equal(bits(g), bits(w))
    assert guard.degradation_log() == ()
    # A plan file of the 1-D signature, a strategy the tuner may not pick.
    path = str(tmp_path / "merge.json")
    autotune.save_plan(build_plan(1500, dtype, dataclasses.replace(CFG, strategy="merge")),
                       path)
    got = bucket_sort.sort(to_torch(a), SortConfig(plan=path), device="cpu")
    np.testing.assert_array_equal(bits(got), bits(want[0]))


def test_resolve_plan_by_cfg_plan(tmp_path):
    assert bucket_sort.resolve_plan(N, "int32", CFG) is build_plan(N, "int32", CFG)
    tuned = bucket_sort.resolve_plan(N, "int32", dataclasses.replace(CFG, plan="autotune"),
                                     device="cpu")
    assert tuned.length == N and tuned.rows == 1
    path = str(tmp_path / "p.json")
    autotune.save_plan(tuned, path)
    assert bucket_sort.resolve_plan(N, "int32", SortConfig(plan=path)) == tuned


def test_nothing_is_tuned_for_what_is_not_sorted(tmp_path):
    """Entry points return before resolving a plan for rows of at most
    one key, and top-k ignores cfg.plan, as the JAX package's does."""
    cfg = dataclasses.replace(CFG, plan="autotune")
    bucket_sort.sort(torch.tensor([3], dtype=torch.int32), cfg, device="cpu")
    bucket_sort.sort_batched(torch.zeros((0, 9), dtype=torch.int32), cfg, device="cpu")
    x = torch.randn(3000)
    vals, idx = partial_sort.topk(x, 10, cfg, device="cpu")
    assert torch.equal(vals, torch.sort(x, descending=True, stable=True).values[:10])
    assert faults.hits("autotune.measure") == 0
    assert not (tmp_path / "plans.json").exists()


def test_sample_input_draws_as_the_reference():
    for dtype in ("int32", "float32", "uint8", "bool", "int16"):
        want = np.asarray(jax_autotune._sample_input(300, dtype, 1, 7))
        got = autotune._sample_input(300, dtype, 1, 7)
        np.testing.assert_array_equal(got.numpy(), want)
    assert autotune._sample_input(10, "int32", 3, 0).shape == (3, 10)


# ----------------------------------------------------------------------
# chip_smoke.py's calibration fit
# ----------------------------------------------------------------------


def test_the_calibration_fit_recovers_constants_on_its_grid():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    channels = [cost_model.estimate(build_plan(1 << 26, "int32", c.cfg)).as_dict()
                for c in autotune.candidate_space(DEFAULT_CONFIG, 1 << 26)]
    times = [2.5e-9 * (c["hbm_bytes"] + 3.0 * c["glue_bytes"] + 0.05 * c["op_units"]
                       + 1e6 * c["launches"]) for c in channels]
    fit = smoke.fit_cost_constants(channels, times)
    assert (fit["GLUE_FACTOR"], fit["OP_BYTE_EQUIV"], fit["LAUNCH_BYTE_EQUIV"]) == (
        3.0, 0.05, 1e6)
    assert fit["rms_log_error"] < 1e-9 and fit["rho"] == 1.0


# ----------------------------------------------------------------------
# The distributed half: shard candidates, the store's shard keys, plan
# files (the tuning runs themselves are in tests/test_torch_distributed.py)
# ----------------------------------------------------------------------

SHARD_SPACES = [  # (config knobs, oversample, pair_align, max_trials)
    (GEOMETRY, 8, 8, 8), (GEOMETRY, 8, 8, 1000), (GEOMETRY, 1, 8, 1000),
    (dict(GEOMETRY, strategy="radix"), 32, 256, 1000),
    (dict(GEOMETRY, strategy="merge"), 2, 128, 4),
    (dict(tile=4096, s=64, direct_max=8192), 8, 8, 8),
]


@pytest.mark.parametrize("kw,oversample,pair_align,max_trials", SHARD_SPACES)
def test_shard_candidate_space_is_the_references(kw, oversample, pair_align,
                                                 max_trials):
    def rows(space):
        return [(c.label, c.oversample, c.pair_align, c.cfg.strategy,
                 c.cfg.tile, c.cfg.s, c.cfg.plan) for c in space]

    got = autotune.shard_candidate_space(
        SortConfig(**kw, plan="autotune"), oversample=oversample,
        pair_align=pair_align, max_trials=max_trials)
    want = jax_autotune.shard_candidate_space(
        JaxConfig(**kw, impl="xla", plan="autotune"), oversample=oversample,
        pair_align=pair_align, max_trials=max_trials)
    assert rows(got) == rows(want)
    assert got[0].label == "base" and got[0].cfg.plan == "default"


def shard_base(d=2, n_local=2048, **kw):
    from repro_torch.core.plan import build_shard_plan

    return build_shard_plan("data", d, n_local, "int32", CFG, **kw)


def test_shard_keys_hold_the_device_and_the_backend():
    plan = shard_base()
    key = autotune.shard_cache_key(plan, "cpu", "gloo")
    parts = key.split("|")
    assert parts[0] == "shard" and len(parts) == 11
    assert parts[1:8] == ["data", "2", "2048", "int32", "False", "8", "8"]
    assert parts[8:] == ["cpu", "gloo", plan.cfg_fingerprint]
    assert key != autotune.shard_cache_key(plan, "cpu", "nccl")
    assert key != autotune.cache_key(plan.run_plan, "cpu")
    assert autotune.shard_cache_key(shard_base(pair_align=128), "cpu", "gloo") != key


def shard_record(plan, version=cost_model.COST_MODEL_VERSION):
    from repro_torch.core.plan import shard_plan_to_dict

    return dict(plan=shard_plan_to_dict(plan), cost_model=version)


def test_nearest_shard_record_needs_the_same_device_and_backend():
    base = shard_base(n_local=4096)
    key = autotune.shard_cache_key(base, "cpu", "gloo")
    near_plan = shard_base(n_local=2048, oversample=16)
    far_plan = shard_base(d=4, n_local=64)
    store = {"plans": {
        autotune.shard_cache_key(near_plan, "cpu", "nccl"): shard_record(near_plan),
        autotune.shard_cache_key(far_plan, "cpu", "gloo"): shard_record(far_plan),
        autotune.cache_key(base.run_plan, "cpu"): dict(
            plan=plan_to_dict(base.run_plan),
            cost_model=cost_model.COST_MODEL_VERSION),
    }}
    got = autotune._nearest_shard_record(store, base, key, "cpu", "gloo")
    assert got[0] == far_plan
    store["plans"][autotune.shard_cache_key(near_plan, "cpu", "gloo")] = \
        shard_record(near_plan)
    assert autotune._nearest_shard_record(store, base, key, "cpu", "gloo")[0] == near_plan
    seed = autotune._shard_seed_from_record(near_plan, CFG)
    assert (seed.label, seed.oversample, seed.pair_align) == ("transfer", 16, 8)
    assert autotune._nearest_shard_record(store, base, key, "cpu", "mpi") is None


def test_shard_lookup_hits_misses_and_transfers(tmp_path):
    path = str(tmp_path / "plans.json")
    base = shard_base()
    key = autotune.shard_cache_key(base, "cpu", "gloo")
    args = (key, base, CFG, path, True, 5, "cpu", "gloo")
    miss = autotune._shard_lookup(*args)
    assert miss["plan"] is None and miss["seeds"] == () and miss["budget"] == 5
    tuned = shard_base(oversample=16)
    store = autotune._fresh_store()
    store["plans"][key] = shard_record(tuned)
    store["denylist"][key] = {"strategy=merge": "boom"}
    other = shard_base(n_local=8192)
    store["plans"][autotune.shard_cache_key(other, "cpu", "gloo")] = shard_record(other)
    autotune._write_json(path, store)
    assert autotune._shard_lookup(*args) == {"plan": tuned}
    autotune._SHARD_MEMO[key] = tuned
    assert autotune._shard_lookup(*args)["plan"] is tuned
    autotune.clear_memo()
    store["plans"][key] = shard_record(tuned, "torch_cost_model/old")
    autotune._write_json(path, store)
    stale = autotune._shard_lookup(*args)
    assert stale["plan"] is None and stale["deny"] == {"strategy=merge"}
    assert stale["budget"] == 2 and stale["seeds"][0].label == "transfer"
    assert stale["transfer_from"] == autotune.shard_cache_key(other, "cpu", "gloo")


def test_shard_plan_files_round_trip_and_refuse_other_signatures(tmp_path):
    plan = shard_base(d=4, n_local=1024)
    path = str(tmp_path / "shard.json")
    autotune.save_shard_plan(plan, path, meta={"label": "base"})
    assert autotune.load_shard_plan(path) == plan
    assert autotune.load_shard_plan(path, axis="data", d=4, n_local=1024,
                                    dtype=torch.int32, cfg=CFG) == plan
    for kw in (dict(axis="model", d=4, n_local=1024, dtype="int32"),
               dict(axis="data", d=2, n_local=1024, dtype="int32"),
               dict(axis="data", d=4, n_local=1024, dtype="float32"),
               dict(axis="data", d=4, n_local=1024, dtype="int32",
                    cfg=SortConfig(descending=True))):
        with pytest.raises(ValueError, match="was built for"):
            autotune.load_shard_plan(path, **kw)
    other = tmp_path / "sort.json"
    autotune.save_plan(plan.run_plan, str(other))
    with pytest.raises(ValueError, match="torch_shard_plan/v1"):
        autotune.load_shard_plan(str(other))
