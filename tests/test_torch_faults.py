"""The port's fault injection and its degradation chain against the JAX
package's.

The registry and rule semantics are those of ``tests/test_faults.py``,
held on ``repro_torch.core.faults``.  The port checks ``kernel.launch``
once per row-sort launch (the JAX package once per trace), so the
expected hits come from the plan.  Under an injected fault the CPU chain
must return the reference's result bit for bit and log the same actions
as the JAX package's chain; tolerance zero throughout.  The JAX side
runs ``impl="xla"`` on lengths no other test sorts, so its jitted sorts
trace (and hit the site) afresh.  The autotuner's sites (``cache.load``,
``cache.save``, ``autotune.measure``) must give the reference's
degradation events, warnings, errors and denylists under the same rule.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import json  # noqa: E402
import os  # noqa: E402
import warnings  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core import faults as jax_faults  # noqa: E402
from repro.core import guard as jax_guard  # noqa: E402
from repro.core import partial_sort as jax_partial  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import autotune, bucket_sort, faults, guard, partial_sort  # noqa: E402
from repro_torch.core.plan import build_plan, build_topk_plan  # noqa: E402
from repro_torch.core.sort_config import SortConfig  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
CFG = SortConfig(**GEOMETRY)
JCFG = JaxConfig(**GEOMETRY, impl="xla")


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (guard, jax_guard):
        mod.clear_degradation_log()
    yield
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (guard, jax_guard):
        mod.clear_degradation_log()


# ----------------------------------------------------------------------
# The injector itself (tests/test_faults.py, on the port's copy)
# ----------------------------------------------------------------------


def test_site_registry_is_closed_and_equal_to_the_reference():
    assert faults.SITES == jax_faults.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.check("kernel.lunch")
    with pytest.raises(ValueError, match="unknown fault site"):
        with faults.inject("no.such.site"):
            pass
    for site in faults.SITES:
        faults.check(site)  # unarmed: counts, never raises
        assert faults.hits(site) == 1


def test_inject_fires_exactly_on_configured_hits():
    with faults.inject("cache.load", on_hit=2, count=2) as rule:
        faults.check("cache.load")  # hit 1: passes
        for expect_hit in (2, 3):
            with pytest.raises(faults.FaultInjected) as ei:
                faults.check("cache.load")
            assert ei.value.site == "cache.load"
            assert ei.value.hit == expect_hit
        faults.check("cache.load")  # hit 4: passes again
    assert rule.fired == 2
    faults.check("cache.load")  # rule disarmed outside the block


def test_inject_resets_hit_counter_on_entry():
    for _ in range(5):
        faults.check("cache.save")
    with faults.inject("cache.save", on_hit=1):
        with pytest.raises(faults.FaultInjected) as ei:
            faults.check("cache.save")
        assert ei.value.hit == 1  # relative to the block, not the process


def test_env_var_rules(monkeypatch):
    monkeypatch.setenv("REPRO_SORT_FAULTS", "cache.load:2, cache.save:1:3")
    faults.reset()  # invalidate the parsed-env cache
    faults.check("cache.load")
    with pytest.raises(faults.FaultInjected):
        faults.check("cache.load")
    for _ in range(3):
        with pytest.raises(faults.FaultInjected):
            faults.check("cache.save")
    faults.check("cache.save")  # past the count window
    monkeypatch.setenv("REPRO_SORT_FAULTS", "cache.load:zap")
    faults.reset()
    with pytest.raises(ValueError, match="REPRO_SORT_FAULTS"):
        faults.check("cache.load")


@pytest.mark.parametrize("seed", [7, 8])
def test_seeded_probabilistic_mode_fires_as_the_reference(seed):
    def firing_pattern(mod):
        fired = []
        with mod.inject("autotune.measure", prob=0.5, seed=seed):
            for _ in range(50):
                try:
                    mod.check("autotune.measure")
                    fired.append(False)
                except mod.FaultInjected:
                    fired.append(True)
        return fired

    a = firing_pattern(faults)
    assert a == firing_pattern(faults), "same seed must fire on the same hits"
    assert any(a) and not all(a)
    assert a == firing_pattern(jax_faults)


def test_validation_of_rule_parameters():
    with pytest.raises(ValueError):
        faults._Rule("cache.load", on_hit=0)
    with pytest.raises(ValueError):
        faults._Rule("cache.load", count=0)
    with pytest.raises(ValueError):
        faults._Rule("cache.load", prob=1.5)


# ----------------------------------------------------------------------
# kernel.launch: one hit per row-sort launch of the plan
# ----------------------------------------------------------------------


def row_sort_launches(node) -> int:
    """Row-sort launches of a plan node's walk (chip_smoke.kernel_launches)."""
    if node.kind == "direct":
        return 1
    return (1 + row_sort_launches(node.sample_plan)
            + row_sort_launches(node.bucket_plan))


@pytest.mark.parametrize("n", [2, 500, 3000, 30_000])
def test_kernel_launch_hits_once_per_launch_of_the_plan(n):
    x = torch.from_numpy(np.random.default_rng(n).integers(0, 1000, n)
                         .astype(np.int32))
    bucket_sort.sort(x, CFG, device="cpu")
    assert faults.hits("kernel.launch") == row_sort_launches(
        build_plan(n, torch.int32, CFG).root)


@pytest.mark.parametrize("n,k", [(300, 5), (3000, 50)])
def test_kernel_launch_hits_of_a_top_k(n, k):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)
                         .astype(np.float32))
    partial_sort.topk(x, k, CFG, device="cpu")
    tplan = build_topk_plan(n, k, torch.float32, CFG)
    # The candidate rows (or the whole rows) and, past direct_max, the
    # tiles and the sample row: one launch each at these widths.
    assert tplan.sample_plan is None and tplan.final_plan is None
    assert faults.hits("kernel.launch") == (1 if n <= CFG.direct_max else 3)


# ----------------------------------------------------------------------
# The CPU chain against the reference's under an injected fault
# ----------------------------------------------------------------------


def actions(log):
    return [(ev.action, ev.site.split("(")[0]) for ev in log]


@pytest.mark.parametrize("check", ["off", "full"])
@pytest.mark.parametrize("case,on_hit,count", [
    (0, 1, 10**6), (1, 2, 10**6), (2, 3, 1), (3, 1, 1)])
def test_sort_chain_matches_reference_under_kernel_fault(case, on_hit, count,
                                                        check):
    # A length per case no other test sorts, so the JAX side traces.
    n = 3331 + 64 * case + 8 * (check == "full")
    x = np.random.default_rng(n).integers(-(10**9), 10**9, n).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jax_guard.DegradationWarning)
        with jax_faults.inject("kernel.launch", on_hit=on_hit, count=count):
            want = np.asarray(jax_sort.argsort(
                jnp.asarray(x), JaxConfig(**GEOMETRY, impl="xla", check=check)))
    want_log = actions(jax_guard.degradation_log())
    with pytest.warns(guard.DegradationWarning):
        with faults.inject("kernel.launch", on_hit=on_hit, count=count):
            got = bucket_sort.argsort(
                torch.from_numpy(x), SortConfig(**GEOMETRY, check=check),
                device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.argsort(x, kind="stable"))
    assert actions(guard.degradation_log()) == want_log
    assert all(ev.action == "fallback" for ev in guard.degradation_log())
    assert len(want_log) == (1 if count == 1 else 2)


@pytest.mark.parametrize("case,on_hit,count", [(0, 1, 10**6), (1, 1, 1)])
def test_topk_chain_matches_reference_under_kernel_fault(case, on_hit, count):
    n = 2989 + 16 * case
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jax_guard.DegradationWarning)
        with jax_faults.inject("kernel.launch", on_hit=on_hit, count=count):
            want = [np.asarray(a) for a in jax_partial.topk_batched(
                jnp.asarray(x), 9, JaxConfig(**GEOMETRY, impl="xla",
                                             check="full"))]
    want_log = actions(jax_guard.degradation_log())
    with pytest.warns(guard.DegradationWarning):
        with faults.inject("kernel.launch", on_hit=on_hit, count=count):
            got = partial_sort.topk_batched(
                torch.from_numpy(x), 9, SortConfig(**GEOMETRY, check="full"),
                device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert actions(guard.degradation_log()) == want_log
    assert len(want_log) == (1 if count == 1 else 2)


def test_explicit_plan_raises_naming_node_and_kernel():
    """sort_planned runs without degradation: the fault surfaces as a
    structured error at the node and kernel that failed, its cause the
    injected fault."""
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 10**6, 2944)
                         .astype(np.int32))
    plan = build_plan(2944, torch.int32, CFG)
    with faults.inject("kernel.launch", on_hit=2, count=10**6):
        with pytest.raises(guard.SortRuntimeError) as ei:
            bucket_sort.sort_planned(x, plan, device="cpu")
    err = ei.value
    assert "kernel.launch" in str(err)
    assert err.invariant == "kernel launch"
    assert err.site.startswith(guard.plan_site(plan) + "/top:bucket(")
    # The second launch is the sample row's direct sort.
    assert err.site.endswith("/sample:direct(rows=1, lp=256):tile_sort")
    assert isinstance(err.__cause__, faults.FaultInjected)
    assert guard.degradation_log() == ()


def test_retry_once_is_the_card_chain():
    """The chain on the card (ROADMAP.md D8): one logged retry of the same
    attempt, then a structured error whose cause is the first error."""
    calls = []

    def attempt(fail_times):
        def run():
            calls.append(1)
            if len(calls) <= fail_times:
                raise guard.SortRuntimeError("node:tile_sort", "kernel launch",
                                             f"call {len(calls)}")
            return "sorted"
        return run

    first = guard.SortRuntimeError("node:tile_sort", "kernel launch", "call 0")
    with pytest.warns(guard.DegradationWarning):
        assert guard.retry_once("plan", attempt(0), first) == "sorted"
    assert [ev.action for ev in guard.degradation_log()] == ["retry"]
    calls.clear()
    guard.clear_degradation_log()
    with pytest.warns(guard.DegradationWarning):
        with pytest.raises(guard.SortRuntimeError) as ei:
            guard.retry_once("plan", attempt(1), first)
    assert ei.value.site == "node:tile_sort"
    assert ei.value.__cause__ is first
    assert "retry" in ei.value.detail
    assert len(calls) == 1 and len(guard.degradation_log()) == 1


# ----------------------------------------------------------------------
# cache.load, cache.save, autotune.measure: the autotuner's sites
# ----------------------------------------------------------------------


def tuner_run(mod, autotune_mod, guard_mod, path, dtype, site, on_hit, count):
    """One plan_for under an injected fault: (the degradation events and
    warnings, the path written as <store>; the error raised, if any; the
    store's denylisted labels)."""
    autotune_mod.clear_memo()
    guard_mod.clear_degradation_log()
    err = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with mod.inject(site, on_hit=on_hit, count=count):
            kw = dict(path=str(path), max_trials=2, repeats=1, measure_budget=2)
            try:
                if autotune_mod is autotune:
                    autotune_mod.plan_for(2048, dtype, CFG, device="cpu", **kw)
                else:
                    autotune_mod.plan_for(2048, dtype, JCFG, **kw)
            except Exception as e:  # the outcome under comparison
                err = (type(e).__name__, getattr(e, "site", None),
                       getattr(e, "invariant", None))
    events = [(ev.site, ev.action, ev.frm.replace(str(path), "<store>"), ev.to,
               ev.error) for ev in guard_mod.degradation_log()]
    messages = [str(w.message).replace(str(path), "<store>")
                for w in caught if issubclass(w.category, UserWarning)]
    deny = []
    if os.path.exists(path):
        for labels in json.load(open(path)).get("denylist", {}).values():
            deny.extend(sorted(labels))
    autotune_mod.clear_memo()
    return events, messages, err, deny


@pytest.mark.parametrize("site,on_hit,count", [
    ("cache.load", 1, 10**6), ("cache.save", 1, 10**6),
    ("autotune.measure", 1, 1), ("autotune.measure", 2, 3),
    ("autotune.measure", 1, 10**6)])
def test_autotune_sites_degrade_as_the_reference(tmp_path, site, on_hit, count):
    """The same rule at a site of the tuner gives the JAX package's
    degradation events, warnings, error and denylist: an unreadable store
    warns and tunes on; an unwritable one records a cache.save fallback
    and serves the plan from memory; a failed measurement is retried,
    then denylisted; every candidate failing raises at autotune.measure."""
    from repro.core import autotune as jax_autotune

    want = tuner_run(jax_faults, jax_autotune, jax_guard, tmp_path / "jax.json",
                     jnp.int32, site, on_hit, count)
    got = tuner_run(faults, autotune, guard, tmp_path / "port.json",
                    torch.int32, site, on_hit, count)
    assert got == want
    assert got[0] or got[1]  # the fault was seen, not silently absorbed


# ----------------------------------------------------------------------
# collective.exchange: the distributed chain on two gloo CPU ranks
# ----------------------------------------------------------------------

# The JAX package's events at this site (core/distributed_sort.py, the
# chain of make_sharded_sort's run), for D = 2.
EXCHANGE_EVENTS = {
    1: [("collective.exchange[D=2]", "retry", "mesh execution",
         "mesh execution (retry)")],
    2: [("collective.exchange[D=2]", "retry", "mesh execution",
         "mesh execution (retry)"),
        ("collective.exchange[D=2]", "fallback", "mesh execution",
         "gather-to-host degraded sort")],
}


@pytest.fixture(scope="module")
def exchange_chain(tmp_path_factory):
    """collective.exchange armed on rank 1 of 2 only, failing 1 and then
    2 hits; each rank's events, outputs and hits."""
    import torch_ranks

    from repro_torch.launch import mesh

    x = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, 4096,
                                          dtype=np.int64).astype(np.int32)
    path = tmp_path_factory.mktemp("exchange") / "inputs.npz"
    np.savez(path, x=x)
    ranks = mesh.run_ranks(torch_ranks.fault_chain, 2, dict(
        data=str(path), cell="x", fault_rank=1, counts=[1, 2]),
        timeout_s=60, deadline_s=300)
    return x, ranks


@pytest.mark.parametrize("count", [1, 2])
def test_exchange_fault_on_one_rank_logs_the_references_events_on_every_rank(
        exchange_chain, count):
    x, ranks = exchange_chain
    for r in ranks:
        assert r[count]["events"] == EXCHANGE_EVENTS[count]
        assert r[count]["stats"] == {"degraded": count == 2, "retries": 1}
    assert ranks[1][count]["hits"] == 2  # one check per attempt
    keys = np.concatenate([r[count]["keys"][:r[count]["count"]] for r in ranks])
    vals = np.concatenate([r[count]["vals"][:r[count]["count"]] for r in ranks])
    np.testing.assert_array_equal(keys, np.sort(x, kind="stable"))
    np.testing.assert_array_equal(vals, np.argsort(x, kind="stable"))
    for r in ranks:
        assert r["healed"]["events"] == []
