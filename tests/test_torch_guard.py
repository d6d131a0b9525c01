"""The port's guarded execution against the JAX package's.

Checked modes (``check="bounds"``, ``"full"``) must leave every result
as it is, bit for bit equal to the reference's checked result; the
invariant checks (``core/guard.py``) must raise ``SortRuntimeError`` on
each corruption that ``tests/test_guard.py`` makes, and their
checksums equal the reference's on the same data.  The JAX side runs
``impl="xla"`` and its degradation log must stay empty, as must the
port's on sound runs.  Tolerance zero throughout.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
from test_torch_bucket_sort import assert_stats_equal, reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core import guard as jax_guard  # noqa: E402
from repro.core import partial_sort as jax_partial  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import bucket_sort, guard, partial_sort  # noqa: E402
from repro_torch.core.key_codec import codec_for  # noqa: E402
from repro_torch.core.plan import build_plan, config_fingerprint  # noqa: E402
from repro_torch.core.sort_config import SortConfig  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
CFG = SortConfig(**GEOMETRY)


@pytest.fixture(autouse=True)
def _sound_runs_log_nothing():
    guard.clear_degradation_log()
    yield
    assert guard.degradation_log() == ()


def configs(check):
    return (JaxConfig(**GEOMETRY, impl="xla", check=check),
            SortConfig(**GEOMETRY, check=check))


# ----------------------------------------------------------------------
# The knob
# ----------------------------------------------------------------------


def test_check_knob_validated():
    with pytest.raises(ValueError, match="SortConfig.check"):
        SortConfig(check="bogus")
    assert guard.CHECK_MODES == jax_guard.CHECK_MODES
    for mode in guard.CHECK_MODES:
        SortConfig(check=mode)
    with pytest.raises(ValueError, match="check"):
        guard.validate_check("nope")


def test_fingerprint_ignores_check():
    """Checked and unchecked configs share their plans."""
    assert config_fingerprint(configs("off")[1]) == config_fingerprint(
        configs("full")[1]) == config_fingerprint(configs("bounds")[1])
    assert build_plan(3000, torch.int32, configs("full")[1]) == build_plan(
        3000, torch.int32, CFG)


def test_invalid_check_rejected_at_entry():
    x = torch.arange(10, dtype=torch.int32)
    cfg = dataclasses.replace(CFG)
    object.__setattr__(cfg, "check", "sideways")  # bypass __post_init__
    with pytest.raises(ValueError, match="check"):
        bucket_sort.sort(x, cfg, device="cpu")
    with pytest.raises(ValueError, match="check"):
        partial_sort.topk(x.float(), 3, cfg, device="cpu")
    with pytest.raises(ValueError, match="check"):
        bucket_sort.sort_planned(x, build_plan(10, torch.int32, CFG),
                                 check="sideways", device="cpu")


# ----------------------------------------------------------------------
# Checked modes leave results as they are, equal to the reference's
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint16", "int64"])
@pytest.mark.parametrize("check", ["bounds", "full"])
def test_checked_sort_matches_reference_and_unchecked(dtype, check):
    a = make_keys(dtype, 4000, np.random.default_rng(len(dtype)))
    jcfg, cfg = configs(check)
    want = reference(lambda x: jax_sort.sort_with_stats(x, jcfg), a,
                     dtype=dtype)
    got = bucket_sort.sort_with_stats(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])
    assert len(got[2]) >= 1
    np.testing.assert_array_equal(
        bits(got[0]), bits(bucket_sort.sort(to_torch(a), CFG, device="cpu")))


@pytest.mark.parametrize("check", ["bounds", "full"])
def test_checked_batched_and_segmented(check):
    rng = np.random.default_rng(5)
    xs = rng.integers(0, 10**6, (4, 1500)).astype(np.int32)
    jcfg, cfg = configs(check)
    want = reference(lambda x: jax_sort.argsort_batched(x, jcfg), xs)
    got = bucket_sort.argsort_batched(torch.from_numpy(xs), cfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bucket_sort.sort_batched(torch.from_numpy(xs), cfg, device="cpu").numpy(),
        np.sort(xs, axis=1))
    x = rng.integers(0, 10**6, 3000).astype(np.int32)
    offs = [0, 700, 700, 2048, 3000]
    want = reference(lambda k: jax_sort.segment_argsort(k, offs, jcfg), x)
    got = bucket_sort.segment_argsort(torch.from_numpy(x), offs, cfg,
                                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("check", ["bounds", "full"])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_checked_topk_matches_reference(check, dtype):
    rng = np.random.default_rng(11)
    jcfg, cfg = configs(check)
    x = make_keys(dtype, 3000, rng)
    want = reference(lambda a: jax_partial.topk(a, 17, jcfg), x, dtype=dtype)
    got = partial_sort.topk(to_torch(x), 17, cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    xb = make_keys(dtype, 3 * 2000, rng).reshape(3, 2000)
    want = reference(lambda a: jax_partial.topk_batched(a, 9, jcfg), xb,
                     dtype=dtype)
    got = partial_sort.topk_batched(to_torch(xb), 9, cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])


# ----------------------------------------------------------------------
# A doctored plan raises a structured error naming the plan node
# ----------------------------------------------------------------------


def doctored_plan(n):
    """A plan whose capacity is shrunk below the true bucket fills, with
    a child that runs on the shrunk rows (tests/test_guard.py)."""
    plan = build_plan(n, torch.int32, CFG)
    root = plan.root
    assert root.kind == "bucket" and root.cap > 128
    child = root.bucket_plan
    assert child.kind == "direct"
    bad_child = dataclasses.replace(child, length=128, lp=128)
    return dataclasses.replace(
        plan, root=dataclasses.replace(root, cap=128, bucket_plan=bad_child))


def test_doctored_plan_raises_structured_error():
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 10**9, 4096)
                         .astype(np.int32))
    bad = doctored_plan(4096)
    with pytest.raises(guard.SortRuntimeError) as ei:
        bucket_sort.sort_planned(x, bad, check="bounds", device="cpu")
    err = ei.value
    assert "bucket" in err.site and "cap=128" in err.site
    assert err.invariant == "bucket_fill <= cap"
    assert "128" in err.detail


def test_sort_planned_check_passes_on_healthy_plan():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 10**9, 4096)
                         .astype(np.int32))
    plan = build_plan(4096, torch.int32, CFG)
    out = bucket_sort.sort_planned(x, plan, check="full", device="cpu")
    assert torch.equal(out, torch.sort(x).values)


# ----------------------------------------------------------------------
# The checks on corrupt data (the corruptions of tests/test_guard.py)
# ----------------------------------------------------------------------


def test_check_bounds_detects_corruption():
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 10**6, 3000)
                         .astype(np.int32))
    plan = build_plan(3000, torch.int32, CFG)
    stats = bucket_sort.sort_with_stats(x, CFG, device="cpu")[2]
    guard.check_bounds(plan, stats)  # healthy: no raise
    bad = [dict(st) for st in stats]
    bad[0]["totals"] = bad[0]["totals"].clone()
    bad[0]["totals"][0, 0] = int(bad[0]["capacity"]) + 1
    with pytest.raises(guard.SortRuntimeError, match="bucket_fill"):
        guard.check_bounds(plan, bad)
    with pytest.raises(guard.SortRuntimeError, match="len\\(stats\\)"):
        guard.check_bounds(plan, stats[:-1] if len(stats) > 1 else stats * 2)
    bad2 = [dict(st) for st in stats]
    bad2[0]["capacity"] = int(bad2[0]["capacity"]) + 128
    with pytest.raises(guard.SortRuntimeError, match="capacity"):
        guard.check_bounds(plan, bad2)
    bad3 = [dict(st) for st in stats]
    bad3[0]["totals"] = bad3[0]["totals"].clone()
    bad3[0]["totals"][0, 0] -= 1  # a lost element: fills sum short of lp
    with pytest.raises(guard.SortRuntimeError, match="sum\\(bucket_fills\\)"):
        guard.check_bounds(plan, bad3)


def sorted_rows(n, seed):
    """(kw, vals, sorted kw, sorted vals) of one row of n int32 keys."""
    x = torch.from_numpy(np.random.default_rng(seed).integers(0, 10**6, n)
                         .astype(np.int32))
    kw = tuple(w[None, :] for w in codec_for(torch.int32).encode(x))
    vals = torch.arange(n, dtype=torch.int32)[None, :]
    order = torch.sort(x, stable=True).indices[None, :]
    return (kw, vals, tuple(torch.gather(w, 1, order) for w in kw),
            torch.gather(vals, 1, order))


def test_check_full_detects_corruption():
    kw, vals, skw, sv = sorted_rows(500, 5)
    plan = build_plan(500, torch.int32, CFG)
    guard.check_full(plan, kw, vals, skw, sv)  # healthy: no raise
    dup = sv.clone()
    dup[0, 0] = sv[0, 1]  # dropped / duplicated payload
    with pytest.raises(guard.SortRuntimeError, match="payload permutation"):
        guard.check_full(plan, kw, vals, skw, dup)
    bad_kw = tuple(w.clone() for w in skw)
    bad_kw[0][0, 0] += 1  # corrupted key content
    with pytest.raises(guard.SortRuntimeError, match="key-word permutation"):
        guard.check_full(plan, kw, vals, bad_kw, sv)
    swap = torch.tensor([499] + list(range(1, 499)) + [0])[None, :]
    ukw = tuple(torch.gather(w, 1, swap) for w in skw)  # same multiset
    with pytest.raises(guard.SortRuntimeError, match="sortedness"):
        guard.check_full(plan, kw, vals, ukw, torch.gather(sv, 1, swap))


@pytest.mark.parametrize("n", [1, 500, 4096])
def test_row_checksums_equal_the_reference(n):
    kw, vals, skw, sv = sorted_rows(n, n)
    uw = tuple(w.numpy().view(np.uint32) ^ np.uint32(0x80000000) for w in kw)
    want = jax_guard._row_checksums(uw, vals.numpy())
    got = guard._row_checksums(kw, vals)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)
    assert guard._inversions(skw) == 0
    assert guard._inversions(kw) == int((np.diff(uw[0].astype(np.int64)) < 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bool"])
def test_check_topk_detects_corruption(dtype):
    x = to_torch(make_keys(dtype, 200, np.random.default_rng(6)))
    codec = codec_for(x.dtype, descending=True)
    v, i = partial_sort.topk(x, 5, device="cpu")
    guard.check_topk(x, v, i, 5, "full", codec)  # healthy
    out = i.clone()
    out[0] = 999
    with pytest.raises(guard.SortRuntimeError, match="idx"):
        guard.check_topk(x, v, out, 5, "bounds", codec)
    dup = i.clone()
    dup[1] = i[0]
    with pytest.raises(guard.SortRuntimeError, match="unique"):
        guard.check_topk(x, v, dup, 5, "full", codec)
    other = v.clone()
    other.view(torch.uint8)[0] ^= 1  # one bit of the first value
    with pytest.raises(guard.SortRuntimeError, match="bitwise"):
        guard.check_topk(x, other, i, 5, "full", codec)
    if dtype != "bool":  # five bools may all be equal, hence sorted either way
        with pytest.raises(guard.SortRuntimeError, match="descending"):
            guard.check_topk(x, v.flip(0), i.flip(0), 5, "full", codec)


def test_check_topk_is_nan_safe():
    x = torch.tensor([float("nan"), 1.0, float("nan"), -0.0, 0.0])
    codec = codec_for(x.dtype, descending=True)
    v, i = partial_sort.topk(x, 5, SortConfig(check="full"), device="cpu")
    guard.check_topk(x, v, i, 5, "full", codec)
    assert i.tolist() == [0, 2, 1, 4, 3]


# ----------------------------------------------------------------------
# Degradation machinery
# ----------------------------------------------------------------------


def test_with_retries_backoff_then_raise():
    calls, delays = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        assert guard.with_retries(
            flaky, site="autotune.measure", attempts=3,
            base_delay=0.01, sleep=delays.append) == "ok"
    assert len(calls) == 3
    assert delays == [0.01, 0.02]  # exponential
    log = guard.degradation_log()
    assert len(log) == 2 and all(ev.action == "retry" for ev in log)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        with pytest.raises(OSError):
            guard.with_retries(
                lambda: (_ for _ in ()).throw(OSError("always")),
                site="autotune.measure", attempts=2,
                base_delay=0.0, sleep=lambda _: None)
    guard.clear_degradation_log()


def test_degradation_log_bounded_and_clearable():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        for i in range(guard._LOG_MAX + 10):
            guard.record_degradation("s", "retry", "a", "b", f"e{i}")
    log = guard.degradation_log()
    assert len(log) == guard._LOG_MAX == jax_guard._LOG_MAX
    assert log[-1].error == f"e{guard._LOG_MAX + 9}"  # oldest evicted
    assert log[-1] == guard.DegradationEvent("s", "retry", "a", "b",
                                             f"e{guard._LOG_MAX + 9}")
    guard.clear_degradation_log()
    assert guard.degradation_log() == ()
