"""The port's radix and merge local sorts (K5, K6), the unfused sampling
round and the distribution probe against the JAX package's, bit for bit.

K5's plain version (``radix_sort_rows`` with ``digit_rank``) and K6's
(``merge_sort_rows`` with ``_merge_level``) and the four xla stand-ins
are held against their JAX namesakes; the pipelines with
``strategy="radix"`` / ``"merge"`` and ``fuse_sampling`` on and off
against the JAX pipeline at ``impl="xla"`` (its Pallas path degrades on
this JAX, ROADMAP.md Queue 3 R1), stats included, with the degradation
log empty after every reference call; the probe's signals (to 1e-12) and
picks against ``repro.core.probe``; wide-row ``ops.topk`` against the
reference's ``ops.topk(impl="xla")``.  The three strategies must give
equal outputs everywhere in the pipeline, and the launches a CPU run
makes must be the plan's walk, which ``chip_smoke.py`` counts against.  Widths
are small (tile 256, s 16, direct_max 512).  The CUDA kernels run only
on the card (``tests/test_torch_chip.py``, ``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_bucket_sort import assert_stats_equal, reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core import partial_sort as jax_partial  # noqa: E402
from repro.core import probe as jax_probe  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro.kernels import merge as jax_merge  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import radix as jax_radix  # noqa: E402
from repro_torch.core import (  # noqa: E402
    bucket_sort,
    partial_sort,
    probe,
    probed_config,
    recommend_strategy,
)
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    SORTERS,
    build_plan,
    build_topk_plan,
    config_fingerprint,
    kernel_launches,
    topk_launches,
)
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig  # noqa: E402
from repro_torch.interop import words_from_numpy, words_to_numpy  # noqa: E402
from repro_torch.kernels import bitonic, merge, ops, radix  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
STRATEGIES = ["radix", "merge"]


@pytest.fixture(autouse=True)
def _no_degradation():
    """The port's CPU chain falls back to other plans on a failure; a
    sound run here must never take it."""
    port_guard.clear_degradation_log()
    yield
    assert port_guard.degradation_log() == ()


def configs(strategy, fuse_sampling=True, **knobs):
    return (JaxConfig(**GEOMETRY, impl="xla", strategy=strategy,
                      fuse_sampling=fuse_sampling, **knobs),
            SortConfig(**GEOMETRY, strategy=strategy,
                       fuse_sampling=fuse_sampling, **knobs))


def make_rows(m, t, nw, rng, distinct=4):
    """uint32 words with heavy duplicates (word 0 from ``distinct``
    values, spread over the top and bottom bits) and arange payloads."""
    w0 = rng.integers(0, distinct, (m, t)).astype(np.uint32)
    words = [(w0 << np.uint32(29)) | w0]
    words += [rng.integers(0, 2**32, (m, t), dtype=np.uint64).astype(np.uint32)
              for _ in range(nw - 1)]
    vals = np.tile(np.arange(t, dtype=np.int32), (m, 1))
    return tuple(words), vals


def assert_rows_equal(got, want):
    """(keys, vals[, sample keys, sample vals]) of the port and of JAX."""
    got = [x if isinstance(x, tuple) else (x,) for x in got]
    want = [x if isinstance(x, tuple) else (x,) for x in want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i % 2 == 0:  # key words
            for a, b in zip(words_to_numpy(g), w, strict=True):
                np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))


def jwords(words):
    return tuple(map(jnp.asarray, words))


def jitted(fn, **static):
    """A JAX reference function compiled once: its eager ops would each
    compile on first use, which costs more than one jit of the whole."""
    return jax.jit(functools.partial(fn, **static))


# ----------------------------------------------------------------------
# K5's and K6's plain versions and the stand-ins
# ----------------------------------------------------------------------


@pytest.mark.parametrize("num_digits", [2, 4, 16])
@pytest.mark.parametrize("t", [1, 8, 64])
def test_digit_rank_matches_reference(t, num_digits):
    rng = np.random.default_rng(t + num_digits)
    d = rng.integers(0, num_digits, (3, t)).astype(np.int32)
    d[0] = num_digits - 1  # one row of a single digit
    want = np.asarray(jitted(jax_radix.digit_rank, num_digits=num_digits)(
        jnp.asarray(d)))
    got = radix.digit_rank(torch.from_numpy(d), num_digits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.argsort(d, 1, kind="stable"))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("radix_bits", [1, 2, 4])
def test_radix_sort_rows_matches_reference(radix_bits, nw):
    rng = np.random.default_rng(radix_bits + 10 * nw)
    words, vals = make_rows(2, 32, nw, rng)
    want = jax_radix.radix_sort_rows(jwords(words), jnp.asarray(vals),
                                     radix_bits=radix_bits)
    got = radix.radix_sort_rows(words_from_numpy(words), torch.from_numpy(vals),
                                radix_bits=radix_bits)
    assert_rows_equal(got, want)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("run", [1, 4, 16])
def test_merge_level_matches_reference(run, nw):
    rng = np.random.default_rng(run + nw)
    words, vals = make_rows(3, 64, nw, rng)
    # Sorted runs of length `run` on (*words, payload), as the level expects.
    keys = (vals.reshape(-1, run),) + tuple(w.reshape(-1, run) for w in words[::-1])
    order = np.lexsort(keys, axis=-1)
    words = tuple(np.take_along_axis(w.reshape(-1, run), order, 1).reshape(3, 64)
                  for w in words)
    vals = np.take_along_axis(vals.reshape(-1, run), order, 1).reshape(3, 64)
    want = jitted(jax_merge._merge_level, run=run)(
        list(jwords(words)) + [jnp.asarray(vals)])
    got = merge._merge_level(list(words_from_numpy(words))
                             + [torch.from_numpy(vals)], run)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(words_to_numpy(g)[0], np.asarray(w))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("merge_run", [2, 16, 64, 512])  # below, at, above T
def test_merge_sort_rows_matches_reference(merge_run, nw):
    rng = np.random.default_rng(merge_run + nw)
    words, vals = make_rows(3, 64, nw, rng)
    want = jitted(jax_merge.merge_sort_rows, merge_run=merge_run)(
        jwords(words), jnp.asarray(vals))
    got = merge.merge_sort_rows(words_from_numpy(words), torch.from_numpy(vals),
                                merge_run=merge_run)
    assert_rows_equal(got, want)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,s", [(1, 0), (64, 8), (256, 16)])
def test_composite_stand_ins_match_reference(t, s, nw):
    rng = np.random.default_rng(t + nw)
    words, vals = make_rows(3, t, nw, rng)
    args = (words_from_numpy(words), torch.from_numpy(vals))
    if s:
        want = jax_radix.composite_sort_sample_rows(
            jwords(words), jnp.asarray(vals), num_samples=s)
        got = radix.composite_sort_sample_rows(*args, num_samples=s)
    else:
        want = jax_radix.composite_sort_rows(jwords(words), jnp.asarray(vals))
        got = radix.composite_sort_rows(*args)
    assert_rows_equal(got, want)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("merge_run,s", [(8, 0), (64, 8), (512, 16)])
def test_hybrid_stand_ins_match_reference(merge_run, s, nw):
    rng = np.random.default_rng(merge_run + nw)
    words, vals = make_rows(3, 256, nw, rng)
    args = (words_from_numpy(words), torch.from_numpy(vals))
    if s:
        want = jitted(jax_merge.hybrid_sort_sample_rows, num_samples=s,
                      merge_run=merge_run)(jwords(words), jnp.asarray(vals))
        got = merge.hybrid_sort_sample_rows(*args, num_samples=s,
                                            merge_run=merge_run)
    else:
        want = jitted(jax_merge.hybrid_sort_rows, merge_run=merge_run)(
            jwords(words), jnp.asarray(vals))
        got = merge.hybrid_sort_rows(*args, merge_run=merge_run)
    assert_rows_equal(got, want)


def test_plain_sorts_agree_with_each_other_on_any_payload():
    """Stable on the key words: the three plain row sorts agree wherever
    payloads increase within equal keys, and K5/K6 keep the given order
    of equal keys whatever the payloads are."""
    rng = np.random.default_rng(5)
    words, vals = make_rows(4, 128, 2, rng)
    kw, v = words_from_numpy(words), torch.from_numpy(vals)
    want = bitonic.bitonic_network_rows(kw, v)
    for got in (radix.radix_sort_rows(kw, v, radix_bits=2),
                merge.merge_sort_rows(kw, v, merge_run=8)):
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1])
    rv = torch.from_numpy(rng.integers(-5, 5, (4, 128)).astype(np.int32))
    order = np.lexsort((np.arange(128)[None].repeat(4, 0),) + words[::-1])
    got = radix.radix_sort_rows(kw, rv, radix_bits=4)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.take_along_axis(rv.numpy(), order, 1))


# ----------------------------------------------------------------------
# The pipelines with each strategy, fused and unfused sampling
# ----------------------------------------------------------------------


@pytest.mark.parametrize("fuse_sampling", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", ["int32", "float32", "int64"])
def test_strategy_sort_matches_reference(dtype, strategy, fuse_sampling):
    rng = np.random.default_rng(len(dtype) + fuse_sampling)
    a = make_keys(dtype, 6000, rng)
    if dtype == "int32":
        a = (a % 40).astype(np.int32)  # ties
    jcfg, cfg = configs(strategy, fuse_sampling)
    want = reference(lambda x: jax_sort.sort_with_stats(x, jcfg), a, dtype=dtype)
    got = bucket_sort.sort_with_stats(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])
    assert len(got[2]) == 2
    perm = bucket_sort.argsort(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(perm.numpy(), want[1])


@pytest.mark.parametrize("fuse_sampling", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_kv_and_batched_match_reference(strategy, fuse_sampling):
    rng = np.random.default_rng(7 + fuse_sampling)
    a = rng.integers(-30, 30, (3, 1500)).astype(np.int32)
    v = rng.standard_normal((3, 1500)).astype(np.float32)
    jcfg, cfg = configs(strategy, fuse_sampling, radix_bits=2, merge_run=64)
    x = torch.from_numpy(a)
    want = reference(lambda k: jax_sort.sort_batched_with_stats(k, jcfg), a)
    got = bucket_sort.sort_batched_with_stats(x, cfg, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])
    np.testing.assert_array_equal(
        bucket_sort.sort_batched(x, cfg, device="cpu").numpy(), want[0])
    want_kv = reference(lambda k, y: jax_sort.sort_kv(k, y, jcfg), a[0], v[0])
    got_kv = bucket_sort.sort_kv(x[0], torch.from_numpy(v[0]), cfg, device="cpu")
    np.testing.assert_array_equal(got_kv[0].numpy(), want_kv[0])
    np.testing.assert_array_equal(got_kv[1].numpy(), want_kv[1])


@pytest.mark.parametrize("fuse_sampling", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("rows,n,k", [(1, 300, 37), (3, 3000, 50), (2, 3000, 2999)])
def test_strategy_topk_batched_matches_reference(strategy, rows, n, k,
                                                 fuse_sampling):
    rng = np.random.default_rng(n + k)
    a = rng.standard_normal((rows, n)).astype(np.float32)
    a[:, : n // 3] = 1.5  # ties across tiles and samples
    geometry = dict(tile=128, s=8, direct_max=256, strategy=strategy,
                    fuse_sampling=fuse_sampling)
    jcfg = JaxConfig(**geometry, impl="xla")
    cfg = SortConfig(**geometry)
    want = reference(lambda x: jax_partial.topk_batched(x, k, jcfg), a)
    got = partial_sort.topk_batched(torch.from_numpy(a), k, cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_all_strategies_give_equal_outputs(monkeypatch, dtype):
    """The payload invariant: equal keys reach every local sort in
    increasing-payload order, so K5 and K6, stable on the key words,
    give K1's rows in every entry point, the wide-row route included."""
    rng = np.random.default_rng(11)
    a = make_keys(dtype, 6000, rng)
    a = a[rng.integers(0, 50, 6000)]  # fifty distinct values
    x = to_torch(a)
    xb = x.reshape(3, 2000)
    vals = torch.from_numpy(rng.standard_normal(6000).astype(np.float32))
    monkeypatch.setattr(bitonic, "MAX_TILE", 64)  # top-k's executor route

    def outputs(cfg):
        return (bucket_sort.sort(x, cfg, device="cpu"),
                bucket_sort.argsort(x, cfg, device="cpu"),
                *bucket_sort.sort_kv(x, vals, cfg, device="cpu"),
                bucket_sort.sort_batched(xb, cfg, device="cpu"),
                bucket_sort.argsort_batched(xb, cfg, device="cpu"),
                *partial_sort.topk_batched(xb, 700, cfg, device="cpu"),
                *partial_sort.topk(x, 40, cfg, device="cpu"))

    want = outputs(SortConfig(**GEOMETRY))
    for strategy in STRATEGIES:
        for fuse_sampling in (True, False):
            got = outputs(SortConfig(
                **GEOMETRY, strategy=strategy, fuse_sampling=fuse_sampling,
                radix_bits=1 if dtype == "int32" else 4, merge_run=4))
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(bits(g), bits(w))


# ----------------------------------------------------------------------
# The probe
# ----------------------------------------------------------------------


def probe_inputs():
    rng = np.random.default_rng(0)
    near = np.arange(1 << 20, dtype=np.int32)
    swap = rng.integers(0, (1 << 20) - 1, (1 << 20) // 100)
    near[swap], near[swap + 1] = near[swap + 1], near[swap]
    f = rng.standard_normal(5000).astype(np.float32)
    f[::7] = np.nan
    return {
        "sorted": np.arange(100_000, dtype=np.int32),
        "uniform 2^20": rng.integers(-(2**31), 2**31, 1 << 20, dtype=np.int32),
        "nearly sorted 2^20": near,
        "duplicates": rng.integers(0, 3, 1 << 20).astype(np.int32),
        "small": rng.integers(-9, 9, 3).astype(np.int32),
        "one": np.array([7], np.int32),
        "empty": np.zeros(0, np.float32),
        "float32 NaN": f,
        "int64": rng.integers(-(2**62), 2**62, 1 << 20),
        "reversed": np.arange(50_000, 0, -1).astype(np.int32),
    }


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("name", list(probe_inputs()))
def test_probe_matches_reference(name, descending):
    a = probe_inputs()[name]
    ctx = jax.enable_x64(True) if a.dtype == np.int64 else contextlib.nullcontext()
    cfg = SortConfig(descending=descending)
    jcfg = JaxConfig(descending=descending)
    with ctx:
        want = jax_probe.probe(a, descending=descending)
        want_pick = jax_probe.recommend_strategy(a, jcfg)
        want_cfg = jax_probe.probed_config(a, jcfg, sample_size=512)
    got = probe.probe(torch.from_numpy(a), descending=descending)
    assert got["n"] == want["n"] and got["num_words"] == want["num_words"]
    assert got["sortedness"] == pytest.approx(want["sortedness"], abs=1e-12)
    assert got["top_bits_entropy"] == pytest.approx(want["top_bits_entropy"],
                                                    abs=1e-12)
    assert recommend_strategy(a, cfg) == want_pick
    assert probed_config(a, cfg, sample_size=512).strategy == want_cfg.strategy


def test_probe_picks_radix_and_merge_where_chip_smoke_expects():
    inputs = probe_inputs()
    assert probe.recommend_strategy(inputs["uniform 2^20"]) == "radix"
    assert probe.recommend_strategy(inputs["nearly sorted 2^20"]) == "merge"
    assert probe.recommend_strategy(inputs["int64"]) == "bitonic"  # two words
    cfg = probe.probed_config(inputs["uniform 2^20"], SortConfig(s=32))
    assert (cfg.strategy, cfg.s) == ("radix", 32)


# ----------------------------------------------------------------------
# Config, plans, dispatch
# ----------------------------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("radix_bits", 3), ("radix_bits", 8), ("radix_bits", 0),
    ("merge_run", 1), ("merge_run", 48), ("merge_run", 0),
])
def test_config_errors_name_radix_bits_and_merge_run(field, value):
    with pytest.raises(ValueError, match=f"SortConfig.{field}"):
        dataclasses.replace(DEFAULT_CONFIG, **{field: value})
    with pytest.raises(ValueError, match=f"SortConfig.{field}"):
        JaxConfig(**{field: value})


def test_fingerprint_changes_with_each_strategy_knob():
    seen = {config_fingerprint(DEFAULT_CONFIG)}
    for knob in (dict(strategy="radix"), dict(strategy="merge"),
                 dict(radix_bits=2), dict(merge_run=64), dict(fuse_sampling=False)):
        seen.add(config_fingerprint(dataclasses.replace(DEFAULT_CONFIG, **knob)))
    assert len(seen) == 6


@pytest.mark.parametrize("strategy,knobs", [
    ("radix", dict(radix_bits=1)), ("merge", dict(merge_run=64)),
    ("bitonic", dict(fuse_sampling=False))])
def test_strategy_plan_trees_match_reference(strategy, knobs):
    from repro.core import plan as jax_plan
    from repro_torch.interop import plan_tree

    cfg = SortConfig(**GEOMETRY, strategy=strategy, **knobs)
    jcfg = JaxConfig(**GEOMETRY, impl="xla", strategy=strategy, **knobs)
    for length in (1, 300, 513, 20_000, 10**6):
        for rows in (1, 3):
            want = jax_plan.build_plan(length, "int32", jcfg, rows=rows)
            got = build_plan(length, "int32", cfg, rows=rows)
            assert plan_tree(got) == plan_tree(want), (length, rows)


def test_plans_carry_the_strategy_knobs_at_every_node():
    cfg = SortConfig(**GEOMETRY, strategy="merge", merge_run=32,
                     fuse_sampling=False)
    nodes = [build_plan(100_000, "int32", cfg).root]
    count = 0
    while nodes:
        node = nodes.pop()
        count += 1
        assert (node.strategy, node.radix_bits, node.merge_run) == ("merge", 4, 32)
        assert node.fuse_sampling is False
        nodes += [n for n in (node.sample_plan, node.bucket_plan) if n]
    assert count > 4
    tplan = build_topk_plan(3000, 5, "float32", dataclasses.replace(
        cfg, strategy="radix", radix_bits=1))
    assert (tplan.strategy, tplan.radix_bits) == ("radix", 1)


def test_dispatch_refuses_unknown_strategies_and_cpu_tensors_in_wrappers():
    w = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown local-sort strategy"):
        ops.sort_tiles(w, w, strategy="quantum")
    with pytest.raises(ValueError, match="unknown local-sort strategy"):
        ops.sort_tiles_sample(w, w, num_samples=4, strategy="quantum")
    for mod in (radix, merge):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            mod.sort_tiles_kv(w, w)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            mod.sort_tiles_sample_kv((w, w), w, num_samples=4)
    with pytest.raises(ValueError, match="radix_bits"):
        radix.sort_tiles_kv(w, w, radix_bits=3)
    with pytest.raises(ValueError, match="merge_run"):
        merge.sort_tiles_kv(w, w, merge_run=6)
    ops.reset_launch_counts()
    ops.sort_tiles(w, w, strategy="radix")
    ops.sort_tiles_sample(w, w, num_samples=4, strategy="merge")
    assert set(ops.launch_counts().values()) == {0}


def test_strategies_run_on_the_cpu_only_when_asked(monkeypatch):
    x = torch.randint(0, 9, (2000,), dtype=torch.int32)
    for strategy in STRATEGIES:
        cfg = SortConfig(**GEOMETRY, strategy=strategy)
        assert torch.equal(bucket_sort.sort(x, cfg, device="cpu"),
                           torch.sort(x, stable=True).values)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for strategy in STRATEGIES:
        cfg = SortConfig(**GEOMETRY, strategy=strategy)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bucket_sort.sort(x, cfg)


def test_row_sorts_share_one_row_load_store_and_sample_epilogue():
    """K1, K5 and K6 store and sample their rows from registers through
    csrc/tile_rows.cuh, which the library hash covers; K1 and K6 load
    through it too, K5 warp-striped for its ranking.  tile_rows.cuh has
    no shared-memory row load or store."""
    from repro_torch.kernels import _build

    for name, loads in (("tile_sort", True), ("radix_sort", False),
                        ("merge_sort", True)):
        text = (_build._CSRC / f"{name}.cu").read_text()
        assert '#include "tile_rows.cuh"' in text
        assert "repro::store_regs" in text
        assert ("repro::load_regs" in text) == loads
        assert "num_samples + 1" not in text and "% num_samples" not in text
    header = (_build._CSRC / "tile_rows.cuh").read_text()
    assert "load_rows" not in header and "store_rows" not in header
    assert {"radix_sort", "merge_sort"} <= set(_build.SOURCES)


@pytest.mark.parametrize("fuse_ranking", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("strategy,fuse_sampling", [
    ("radix", True), ("merge", True), ("merge", False), ("bitonic", False)])
def test_launches_on_the_cpu_equal_chip_smokes_plan_walk(
        monkeypatch, strategy, fuse_sampling, fuse_ranking):
    """A CPU rehearsal of chip_smoke's launch counts: each dispatcher call
    is one launch on the card; the calls a sort and a top-k make must be
    the plan's walk (``plan.kernel_launches`` / ``topk_launches``, which
    chip_smoke.py and the cost model count)."""
    calls = []

    def wrap(name, record):
        real = getattr(ops, name)

        def spy(*args, **kw):
            # The kernels take contiguous rows only (the plain versions
            # take any): what the card would be handed.
            tensors = [t for a in args[:2] for t in (a if isinstance(a, tuple) else (a,))]
            assert all(t.is_contiguous() for t in tensors), name
            calls.append(record(*args, **kw))
            return real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)

    def sorter(kw):
        return SORTERS[kw.get("strategy", "bitonic")]

    wrap("sort_tiles", lambda k, v, **kw: (sorter(kw), *v.shape, 0))
    wrap("sort_tiles_sample",
         lambda k, v, **kw: (sorter(kw), *v.shape, kw["num_samples"]))
    for name in ("splitter_partition", "splitter_ranks"):
        wrap(name, lambda k, v, sk, sv, _n=name: (_n, *v.shape, sv.shape[1]))
    cfg = SortConfig(**GEOMETRY, strategy=strategy, fuse_sampling=fuse_sampling,
                     fuse_ranking=fuse_ranking)
    # At 8192 keys a row's samples fill the direct level unpadded.
    for length in (8192, 20_000):
        x = torch.randint(-99, 99, (3, length), dtype=torch.int32)
        bucket_sort.sort_batched(x, cfg, device="cpu")
        plan = build_plan(length, torch.int32, cfg, rows=3)
        assert calls == kernel_launches(plan.root)
        assert {c[0] for c in calls} >= {SORTERS[strategy]}
        calls.clear()
    monkeypatch.setattr(bitonic, "MAX_TILE", 512)  # the wide-row route too
    partial_sort.topk_batched(x.float(), 50, cfg, device="cpu")
    tplan = build_topk_plan(20_000, 50, torch.float32, cfg, rows=3)
    assert tplan.sample_plan is not None
    assert calls == topk_launches(tplan)


# ----------------------------------------------------------------------
# ops.topk past one CTA's width (ROADMAP.md D4, repaired)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64"])
@pytest.mark.parametrize("shape,k", [((3, 100), 7), ((2, 65), 65), ((4, 3000), 50)])
def test_ops_topk_wide_rows_match_reference(monkeypatch, dtype, shape, k):
    rng = np.random.default_rng(sum(shape) + k)
    a = make_keys(dtype, shape[0] * shape[1], rng).reshape(shape)
    if dtype == "int32":
        a = (a % 5).astype(np.int32)  # ties
    ctx = jax.enable_x64(True) if dtype == "int64" else contextlib.nullcontext()
    with ctx:
        want = tuple(np.asarray(w) for w in jax_ops.topk(jnp.asarray(a), k,
                                                          impl="xla"))
    monkeypatch.setattr(bitonic, "MAX_TILE", 64)
    calls = []
    real = ops._wide_rows_topk
    monkeypatch.setattr(ops, "_wide_rows_topk",
                        lambda w, kk: calls.append(kk) or real(w, kk))
    got = ops.topk(to_torch(a), k, device="cpu")
    assert calls == [k]
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_ops_topk_takes_rows_wider_than_a_cta():
    """At the real MAX_TILE: 20,000 columns pad past 16,384, and the
    executor runs a bucket round on the rows."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 20_000)).astype(np.float32)
    a[:, ::3] = 0.5  # ties
    want = tuple(np.asarray(w) for w in jax_ops.topk(jnp.asarray(a), 9, impl="xla"))
    got = ops.topk(torch.from_numpy(a), 9, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert ops.topk(torch.zeros((0, 20_000)), 3, device="cpu")[1].shape == (0, 3)
