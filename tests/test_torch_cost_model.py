"""The port's cost model against the JAX package's.

``hbm_bytes`` must equal the JAX ``estimate`` of the ``impl="xla"`` plan
of the same signature, and ``op_units`` too on bitonic and merge plans,
for every config of the reference's property pool (``_KW_POOL`` of
``tests/test_cost_model.py``) but scatter relocation, which the port
does not run; tolerance zero (the channels are sums of integers and
quarters).  Radix op units count K5's four 8-bit passes a key word
(the reference's formula at ``radix_bits=8``).  ``launches`` must equal
the dispatcher calls a CPU run makes (one a launch on the card), and a
row wider than ``bitonic.MAX_TILE`` scores ``inf``.  ``priors_for``
must equal the JAX ``priors_for`` on seeded inputs.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cost_model as jax_cm  # noqa: E402
from repro.core import plan as jax_plan  # noqa: E402
from repro.core import probe as jax_probe  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import bucket_sort, cost_model, partial_sort, probe  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    build_plan,
    build_shard_plan,
    build_topk_plan,
    kernel_launches,
    shard_launches,
)
from repro_torch.core.sort_config import SortConfig  # noqa: E402
from repro_torch.kernels import bitonic, ops, radix  # noqa: E402

BASE = dict(tile=4096, s=64, direct_max=8192)
SMALL = dict(tile=256, s=16, direct_max=512)
# tests/test_cost_model.py's _KW_POOL without relocation="scatter".
KW_POOL = {
    "base": {}, "radix": dict(strategy="radix"), "merge": dict(strategy="merge"),
    "tile1024": dict(tile=1024), "s16": dict(s=16),
    "nofuse": dict(fuse_sampling=False, fuse_ranking=False),
}
SIGNATURES = [  # (geometry, length, rows, dtype)
    (BASE, 1 << 10, 1, "int32"), (BASE, 77_777, 1, "int32"),
    (BASE, 1 << 20, 1, "int32"), (BASE, 1 << 26, 1, "int32"),
    (BASE, 1 << 24, 1, "int64"), (BASE, 100_000, 3, "float32"),
    (SMALL, 20_000, 1, "int32"), (SMALL, 5000, 4, "int64"),
]


def plans(geometry, kw, length, rows, dtype):
    """The port's plan and the JAX package's impl="xla" plan."""
    cfg = {**geometry, **kw}
    cfg["direct_max"] = max(cfg["direct_max"], 2 * cfg["tile"])
    return (build_plan(length, dtype, SortConfig(**cfg), rows=rows),
            jax_plan.build_plan(length, dtype, JaxConfig(**cfg, impl="xla"),
                                rows=rows))


@pytest.mark.parametrize("sig", SIGNATURES, ids=lambda s: f"{s[0]['tile']}-{s[1]}-{s[2]}-{s[3]}")
@pytest.mark.parametrize("name", list(KW_POOL))
def test_channels_equal_the_reference(name, sig):
    geometry, length, rows, dtype = sig
    ours, theirs = plans(geometry, KW_POOL[name], length, rows, dtype)
    got, want = cost_model.estimate(ours), jax_cm.estimate(theirs)
    assert got.hbm_bytes == want.hbm_bytes
    if name != "radix":
        assert got.op_units == want.op_units
    assert got.glue_bytes < got.hbm_bytes or got.glue_bytes == 0
    assert math.isfinite(got.total) and got.total > 0


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("width", [2, 256, 4096, 16384])
def test_radix_op_units_count_the_kernels_four_passes_a_word(width, nw):
    """K5 ranks 8-bit digits whatever radix_bits says: the reference's
    formula at radix_bits=8, for any sortedness and entropy."""
    for pri in (cost_model.Priors(), cost_model.Priors(0.9, 1.5)):
        jpri = jax_cm.Priors(pri.sortedness, pri.top_bits_entropy)
        got = cost_model.local_sort_op_units(width, nw, "radix", 512, pri)
        assert got == jax_cm.local_sort_op_units(width, nw, "radix", 8, 512, jpri)
        assert got < jax_cm.local_sort_op_units(width, nw, "radix", 4, 512, jpri)
        for strategy in ("bitonic", "merge"):
            assert cost_model.local_sort_op_units(width, nw, strategy, 64, pri) == (
                jax_cm.local_sort_op_units(width, nw, strategy, 4, 64, jpri))


@pytest.mark.parametrize("length,k,rows", [(3000, 50, 2), (400, 10, 1),
                                           (20_000, 1024, 1), (151_936, 50, 4)])
def test_topk_hbm_bytes_equal_the_reference(length, k, rows):
    ours = build_topk_plan(length, k, "float32", SortConfig(**SMALL), rows=rows)
    theirs = jax_plan.build_topk_plan(length, k, "float32",
                                      JaxConfig(**SMALL, impl="xla"), rows=rows)
    got, want = cost_model.estimate(ours), jax_cm.estimate(theirs)
    assert got.hbm_bytes == want.hbm_bytes and got.op_units == want.op_units
    assert got.launches >= 1 and got.glue_bytes == 0


@pytest.mark.parametrize("log2n", [10, 14, 18, 20])
@pytest.mark.parametrize("name", list(KW_POOL))
def test_estimate_deterministic_positive_monotone(name, log2n):
    cfg = SortConfig(**{**BASE, **KW_POOL[name]})
    a = cost_model.estimate(build_plan(1 << log2n, "int32", cfg))
    b = cost_model.estimate(build_plan(1 << log2n, torch.int32, dataclasses.replace(cfg)))
    assert a == b
    assert a.total > 0 and a.hbm_bytes > 0 and a.op_units >= 0
    assert 0 < a.smem_peak_bytes <= cost_model.SMEM_BUDGET_BYTES
    bigger = cost_model.estimate(build_plan(1 << (log2n + 1), "int32", cfg))
    assert bigger.total > a.total


def test_rows_the_card_cannot_sort_score_inf(monkeypatch):
    """A direct row or a tile wider than bitonic.MAX_TILE has no kernel."""
    wide_direct = build_plan(30_000, "int32", SortConfig(tile=4096, direct_max=32768))
    wide_tile = build_plan(1 << 20, "int32", SortConfig(tile=32768, direct_max=32768))
    for plan in (wide_direct, wide_tile):
        b = cost_model.estimate(plan)
        assert b.total == math.inf and b.hbm_bytes > 0
    fits = build_plan(30_000, "int32", SortConfig(tile=4096, direct_max=16384))
    assert math.isfinite(cost_model.estimate(fits).total)
    monkeypatch.setattr(bitonic, "MAX_TILE", 2048)
    assert cost_model.estimate(fits).total == math.inf


@pytest.mark.parametrize("strategy,want", [
    ("bitonic", 4096 * 8), ("merge", (4096 + 4096 // 16) * 8),
    ("radix", radix.radix_geometry(1, 4096, 1).shared_bytes)])
def test_smem_peak_is_the_widest_row_sorts_cta(strategy, want):
    """At 2^26 int32 the widest rows are the 4096-wide tiles and direct
    rows: one CTA a row, 16 elements a thread, 8-byte packed keys; with
    two words every row sort's CTA is read from its launch geometry."""
    plan = build_plan(1 << 26, "int32", SortConfig(strategy=strategy))
    assert cost_model.estimate(plan).smem_peak_bytes == want
    plan = build_plan(1 << 25, "int64", SortConfig(strategy=strategy))
    smem = []
    for kernel, rows, width, _ in kernel_launches(plan.root):
        if kernel == "radix_sort":
            smem.append(radix.radix_geometry(rows, width, 2).shared_bytes)
        elif kernel in ("tile_sort", "merge_sort"):
            g = bitonic.row_sort_geometry(rows, width, 2)
            smem.append(g.shared_bytes if kernel == "tile_sort"
                        else g.merge_shared_bytes)
    assert cost_model.estimate(plan).smem_peak_bytes == max(smem)


def test_estimate_refuses_other_objects():
    with pytest.raises(TypeError, match="SortPlan or TopkPlan"):
        cost_model.estimate(object())
    d = cost_model.estimate(build_plan(10_000, "int32", SortConfig(**SMALL))).as_dict()
    assert set(d) == {"hbm_bytes", "op_units", "glue_bytes", "launches",
                      "smem_peak_bytes", "total"}


@pytest.mark.parametrize("strategy", ["bitonic", "radix", "merge"])
@pytest.mark.parametrize("fuse_ranking", [True, False], ids=["fused", "unfused"])
def test_launches_equal_the_dispatcher_calls(monkeypatch, strategy, fuse_ranking):
    """Each kernel dispatcher call of a CPU run is one launch on the card;
    a sort and a top-k make as many as the cost model counts."""
    calls = []
    for name in ("sort_tiles", "sort_tiles_sample", "splitter_partition",
                 "splitter_ranks"):
        def spy(*args, _real=getattr(ops, name), _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    cfg = SortConfig(**SMALL, strategy=strategy, fuse_ranking=fuse_ranking)
    x = torch.randint(-99, 99, (3, 20_000), dtype=torch.int32)
    bucket_sort.sort_batched(x, cfg, device="cpu")
    assert len(calls) == cost_model.estimate(
        build_plan(20_000, torch.int32, cfg, rows=3)).launches
    calls.clear()
    partial_sort.topk_batched(x.float(), 50, cfg, device="cpu")
    assert len(calls) == cost_model.estimate(
        build_topk_plan(20_000, 50, torch.float32, cfg, rows=3)).launches


def priors_inputs():
    rng = np.random.default_rng(0)
    f = rng.standard_normal(5000).astype(np.float32)
    f[::7] = np.nan
    return {
        "uniform": rng.integers(-(2**31), 2**31, 1 << 16, dtype=np.int32),
        "sorted": np.arange(100_000, dtype=np.int32),
        "duplicates": rng.integers(0, 3, 1 << 16).astype(np.int32),
        "float32 NaN": f,
        "int64": rng.integers(-(2**62), 2**62, 1 << 16),
        "small": rng.integers(-9, 9, 3).astype(np.int32),
    }


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("name", list(priors_inputs()))
def test_priors_for_equals_the_reference(name, descending):
    a = priors_inputs()[name]
    ctx = jax.enable_x64(True) if a.dtype == np.int64 else contextlib.nullcontext()
    with ctx:
        want = jax_probe.priors_for(a, JaxConfig(descending=descending))
    got = probe.priors_for(torch.from_numpy(a), SortConfig(descending=descending))
    assert isinstance(got, cost_model.Priors)
    assert (got.sortedness, got.top_bits_entropy) == (
        want.sortedness, want.top_bits_entropy)


def test_priors_shift_the_strategy_terms():
    merge = build_plan(1 << 18, "int32", SortConfig(strategy="merge"))
    rad = build_plan(1 << 18, "int32", SortConfig(strategy="radix"))
    sorted_pri = probe.priors_for(torch.arange(4096, dtype=torch.int32))
    assert sorted_pri.sortedness == 1.0
    assert cost_model.estimate(merge, sorted_pri).total < cost_model.estimate(merge).total
    skewed = cost_model.Priors(top_bits_entropy=0.0)
    assert cost_model.estimate(rad, skewed).total > cost_model.estimate(rad).total


@pytest.mark.parametrize("seed", range(4))
def test_spearman_is_the_rank_correlation(seed):
    """The reference test's formula: Pearson's r of the ranks when no
    value repeats; 1 for the same order, -1 for the reverse."""
    rng = np.random.default_rng(seed)
    a, b = rng.permutation(11).astype(float), rng.standard_normal(11)
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    assert cost_model.spearman(a, b) == pytest.approx(np.corrcoef(ra, rb)[0, 1],
                                                      abs=1e-12)
    assert cost_model.spearman(a, a * 3 + 1) == 1.0
    assert cost_model.spearman(a, -a) == -1.0


# ----------------------------------------------------------------------
# ShardPlans: the four sub-plans, and the collective channel
# ----------------------------------------------------------------------

SHARD_SIGNATURES = [  # (geometry, d, n_local, dtype, oversample, pair_align)
    (SMALL, 2, 2048, "int32", 8, 8), (SMALL, 4, 3000, "float64", 4, 128),
    (SMALL, 8, 512, "int32", 8, 8), (BASE, 4, 1 << 22, "int32", 8, 8),
    (BASE, 2, 1 << 24, "int64", 16, 256),
]


def shard_plans(geometry, kw, d, n_local, dtype, oversample, pair_align):
    """The port's ShardPlan and the JAX package's impl="xla" one."""
    knobs = dict(oversample=oversample, pair_align=pair_align)
    ctx = jax.enable_x64(True) if dtype in ("int64", "float64") \
        else contextlib.nullcontext()
    with ctx:
        theirs = jax_plan.build_shard_plan(
            "data", d, n_local, dtype, JaxConfig(**geometry, **kw, impl="xla"),
            **knobs)
    return (build_shard_plan("data", d, n_local, dtype,
                             SortConfig(**geometry, **kw), **knobs), theirs)


@pytest.mark.parametrize("sig", SHARD_SIGNATURES,
                         ids=lambda s: f"{s[0]['tile']}-d{s[1]}-{s[2]}-{s[3]}")
@pytest.mark.parametrize("name", ["base", "radix", "merge"])
def test_shard_channels_equal_the_reference(name, sig):
    ours, theirs = shard_plans(sig[0], KW_POOL[name], *sig[1:])
    got, want = cost_model.estimate(ours), jax_cm.estimate(theirs)
    assert got.hbm_bytes == want.hbm_bytes
    assert got.collective_bytes == want.collective_bytes > 0
    if name == "base":  # else the later phases sort bitonic here (D13)
        assert got.op_units == want.op_units
    assert got.launches == len(shard_launches(ours))
    assert got.total == (
        got.hbm_bytes + cost_model.GLUE_FACTOR * got.glue_bytes
        + cost_model.OP_BYTE_EQUIV * got.op_units
        + cost_model.LAUNCH_BYTE_EQUIV * got.launches
        + cost_model.COLLECTIVE_BYTE_WEIGHT * got.collective_bytes)
    assert "collective_bytes" in got.as_dict()


def test_collective_weight_is_hbm_over_one_nvlink_direction():
    assert cost_model.COLLECTIVE_BYTE_WEIGHT == pytest.approx(3.35e12 / 450e9)


@pytest.mark.parametrize("sig", SIGNATURES[:4] + SIGNATURES[6:],
                         ids=lambda s: f"{s[0]['tile']}-{s[1]}-{s[2]}-{s[3]}")
def test_single_device_totals_have_no_collective_term(sig):
    """A SortPlan's or TopkPlan's total is the fitted formula: no collective
    bytes, so the fitted constants still hold."""
    geometry, length, rows, dtype = sig
    ours, _ = plans(geometry, {}, length, rows, dtype)
    tk = build_topk_plan(length, min(50, length), "float32",
                         SortConfig(**geometry), rows=rows)
    for got in (cost_model.estimate(ours), cost_model.estimate(tk)):
        assert got.collective_bytes == 0
        assert "collective_bytes" not in got.as_dict()
        assert got.total == (
            got.hbm_bytes + cost_model.GLUE_FACTOR * got.glue_bytes
            + cost_model.OP_BYTE_EQUIV * got.op_units
            + cost_model.LAUNCH_BYTE_EQUIV * got.launches)
    assert cost_model.COST_MODEL_VERSION == "torch_cost_model/h100-v1"
