"""The port's config and planners against the JAX package's.

``plan_tree`` (kind, rows, length, lp, tile, s, m, s_round, cap,
fuse_ranking, fuse_sampling, the local-sort strategy and its knobs, and
the recursion tree) must be equal to the reference
plan's, bit for bit, across a sweep of (length, rows, words, config);
so must every algorithmic field of the top-k plan.  Where the reference
planner cannot finish (a level that never shrinks), the port refuses up
front with a ValueError naming ``s``.  Plan records (the autotuner's
store and plan files) round-trip exactly under the port's own schema
tag and refuse any other record.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import plan as jax_plan  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core.sort_config import (  # noqa: E402
    DEFAULT_CONFIG,
    PAPER_CONFIG,
    SortConfig,
)
from repro_torch.interop import plan_tree  # noqa: E402
from repro_torch.kernels import bitonic, splitter  # noqa: E402

GEOMETRIES = [  # (tile, s, direct_max)
    (4096, 64, 8192),
    (2048, 64, 4096),
    (256, 16, 512),
    (128, 8, 256),
    (1024, 32, 1024),
    (64, 4, 256),
    (16384, 64, 16384),
]
LENGTHS = [1, 2, 100, 512, 513, 4097, 8193, 77_777, 10**6, 1 << 26]


TOPK_FIELDS = ("rows", "length", "k", "lp", "m", "tile", "s", "cap", "ccap",
               "direct_max", "strategy", "radix_bits", "merge_run")


def jax_cfg(tile, s, direct_max, fuse_ranking=True):
    return JaxConfig(tile=tile, s=s, direct_max=direct_max,
                     fuse_ranking=fuse_ranking, impl="xla")


@pytest.mark.parametrize("fuse_ranking", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("rows", [1, 3, 256])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_plan_tree_matches_reference(geometry, rows, fuse_ranking):
    cfg = SortConfig(*geometry, fuse_ranking=fuse_ranking)
    jcfg = jax_cfg(*geometry, fuse_ranking)
    for length in LENGTHS:
        for dtype in ("int32", "int64"):
            want = jax_plan.build_plan(length, dtype, jcfg, rows=rows)
            got = plan_mod.build_plan(length, dtype, cfg, rows=rows)
            assert plan_tree(got) == plan_tree(want), (length, dtype)
            assert got.num_levels == want.num_levels
        for nw in (1, 2):
            want = jax_plan.build_words_plan(length, nw, jcfg, rows=rows)
            got = plan_mod.build_words_plan(length, nw, cfg, rows=rows)
            assert plan_tree(got) == plan_tree(want)
    if cfg.direct_max < LENGTHS[-1]:
        assert plan_mod.build_plan(LENGTHS[-1], "int32", cfg).root.fuse_ranking \
            == fuse_ranking


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
@pytest.mark.parametrize("rows", [1, 3, 256])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_topk_plan_matches_reference(geometry, rows, dtype):
    cfg = SortConfig(*geometry)
    for length in (1, 2, 100, 512, 513, 4097, 77_777, 151_936, 1 << 24):
        for k in sorted({1, 2, 50, 1024, length // 2, length - 1, length}):
            if not 1 <= k <= length:
                continue
            want = jax_plan.build_topk_plan(length, k, dtype, jax_cfg(*geometry),
                                            rows=rows)
            got = plan_mod.build_topk_plan(length, k, dtype, cfg, rows=rows)
            for field in TOPK_FIELDS:
                assert getattr(got, field) == getattr(want, field), (
                    field, length, k)
            assert got is plan_mod.build_topk_plan(length, k, dtype, cfg, rows=rows)


def test_topk_plan_refuses_k_out_of_range_and_bad_dtypes():
    for k in (0, 11, -1):
        with pytest.raises(ValueError, match="1 <= k <= length"):
            plan_mod.build_topk_plan(10, k, "float32", DEFAULT_CONFIG)
    with pytest.raises(TypeError, match="unsupported sort key dtype"):
        plan_mod.build_topk_plan(10, 1, "complex64", DEFAULT_CONFIG)
    for name in ("block_rows", "raw_block_rows", "impl", "interpret", "backend"):
        assert not hasattr(plan_mod.build_topk_plan(10, 1, "int32", DEFAULT_CONFIG),
                           name)
    # A row too wide for K1 relabels its pads length + column in int32.
    with pytest.raises(ValueError, match="overflow int32"):
        plan_mod.build_topk_plan(2**31 - 1000, 1024, "float32", DEFAULT_CONFIG)


@pytest.mark.parametrize("fuse_ranking", [True, False], ids=["fused", "unfused"])
def test_topk_plan_picks_k1_or_the_executor_per_row(monkeypatch, fuse_ranking):
    """The plan decides, from the shape, which rows K1 sorts (None) and
    which the bucket-sort executor sorts (the caller's config's plan)."""
    cfg = SortConfig(fuse_ranking=fuse_ranking)
    serve = plan_mod.build_topk_plan(151_936, 50, "float32", cfg, rows=256)
    assert serve.sample_plan is None and serve.final_plan is None
    column = plan_mod.build_topk_plan(1 << 24, 1024, "float64", cfg)
    for row, width in ((column.sample_plan, column.m * column.s),
                       (column.final_plan, column.ccap)):
        assert row is plan_mod.build_words_plan(width, 2, cfg, rows=1)
        assert row.root.fuse_ranking == fuse_ranking
    direct = plan_mod.build_topk_plan(100, 5, "int32", cfg, rows=3)
    assert direct.sample_plan is None and direct.final_plan is None
    monkeypatch.setattr(bitonic, "MAX_TILE", 64)
    narrow = plan_mod.build_topk_plan(100, 5, "int32", cfg, rows=3)
    assert narrow is not direct and narrow.sample_plan is None
    assert narrow.final_plan is plan_mod.build_words_plan(100, 1, cfg, rows=3)


def test_random_configs_plan_like_reference_or_refuse_up_front():
    """Seeded sweep of small geometries: where the reference plans, the
    port plans the same tree; where it runs away (R3), the port raises a
    ValueError naming s."""
    rng = np.random.default_rng(0)
    refused = 0
    for _ in range(300):
        tile = 2 ** int(rng.integers(1, 11))
        s = 2 ** int(rng.integers(1, int(np.log2(tile)) + 1))
        direct_max = tile * 2 ** int(rng.integers(0, 3))
        length = int(rng.integers(1, 50 * direct_max))
        rows = int(rng.integers(1, 6))
        try:
            want = jax_plan.build_plan(length, "int32", jax_cfg(tile, s, direct_max),
                                       rows=rows)
        except ValueError:
            want = None
        cfg = SortConfig(tile=tile, s=s, direct_max=direct_max)
        if want is None:
            refused += 1
            with pytest.raises(ValueError, match="SortConfig.s"):
                plan_mod.build_plan(length, "int32", cfg, rows=rows)
        else:
            got = plan_mod.build_plan(length, "int32", cfg, rows=rows)
            assert plan_tree(got) == plan_tree(want), (tile, s, direct_max, length)
    assert refused > 0


@pytest.mark.parametrize("tile,s,length", [(128, 2, 257), (64, 64, 1000), (8, 4, 16)])
def test_non_shrinking_level_is_refused_naming_s(tile, s, length):
    cfg = SortConfig(tile=tile, s=s, direct_max=tile)
    with pytest.raises(ValueError, match=rf"SortConfig.s={s} cannot shrink"):
        plan_mod.build_plan(length, "int32", cfg)


def test_kernel_geometry_is_rows_per_cta():
    """The kernel wrappers size their CTAs from the tile shape alone; the
    plan carries no TPU block field and SortConfig no block_rows."""
    p = plan_mod.build_plan(1 << 26, "int32", DEFAULT_CONFIG)
    top = p.root
    assert bitonic.effective_block_rows(top.rows * top.m, top.tile) == 1
    assert splitter.partition_block_rows(top.rows * top.m) == 4
    assert bitonic.effective_block_rows(1024, 64) == 32
    assert bitonic.effective_block_rows(1023, 64) == 1
    assert bitonic.effective_block_rows(8, 2) == 8
    assert splitter.partition_block_rows(3) == 3
    d = plan_mod.build_plan(100, "int32", SortConfig(), rows=64).root
    assert (d.kind, d.lp) == ("direct", 128)
    assert bitonic.effective_block_rows(d.rows, d.lp) == 16
    for name in ("block_rows", "part_block_rows"):
        assert not hasattr(top, name)
    assert not hasattr(DEFAULT_CONFIG, "block_rows")


@pytest.mark.parametrize("impl", [None, "cuda", "torch", "pallas", "xla"])
def test_plans_have_no_impl_and_run_on_the_tensors_device(impl):
    """The tensor's device is the only dispatch switch: SortConfig takes
    no impl, and a plan built without a device sorts any CPU tensor of
    its signature like stable torch.sort."""
    with pytest.raises(TypeError, match="impl"):
        SortConfig(impl=impl)
    from repro_torch.core.bucket_sort import sort_planned

    cfg = SortConfig(tile=64, s=8, direct_max=128)
    plan = plan_mod.build_plan(1000, torch.int32, cfg, rows=2)
    assert not hasattr(plan, "impl")
    rng = np.random.default_rng(len(str(impl)))
    x = torch.from_numpy(rng.integers(-50, 50, (2, 1000)).astype(np.int32))
    for keys in (x, x.t().contiguous().t()):
        assert torch.equal(sort_planned(keys, plan, device="cpu"),
                           torch.sort(keys, dim=1, stable=True).values)


def test_plan_is_memoized_and_describes_itself():
    a = plan_mod.build_plan(77_777, "float32", PAPER_CONFIG)
    b = plan_mod.build_plan(77_777, torch.float32, PAPER_CONFIG)
    assert a is b
    text = a.describe()
    assert "levels=1" in text and "s_round=64" in text and "direct" in text
    assert plan_mod.config_fingerprint(PAPER_CONFIG) != plan_mod.config_fingerprint(
        DEFAULT_CONFIG)
    assert plan_mod.config_fingerprint(SortConfig()) == plan_mod.config_fingerprint(
        DEFAULT_CONFIG)


@pytest.mark.parametrize("field,value,match", [
    ("tile", 100, "SortConfig.tile must be a power of two"),
    ("s", 3, "SortConfig.s must be a power of two"),
    ("s", 8192, r"SortConfig.s \(8192\) must not exceed"),
    ("direct_max", 1024, "SortConfig.direct_max"),
    ("tile", 0, "SortConfig.tile must be a power of two"),
    ("relocation", "bogus", "SortConfig.relocation"),
    ("strategy", "bogus", "SortConfig.strategy"),
    ("plan", "", "SortConfig.plan"),
    ("check", "bogus", "SortConfig.check"),
])
def test_config_errors_name_the_field(field, value, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(DEFAULT_CONFIG, **{field: value})


@pytest.mark.parametrize("field,value,item", [
    ("relocation", "scatter", "Queue 1 item 4"),
])
def test_unported_values_raise_naming_field_and_roadmap_item(field, value, item):
    with pytest.raises(NotImplementedError, match=rf"SortConfig.{field}=.*{item}"):
        dataclasses.replace(DEFAULT_CONFIG, **{field: value})


@pytest.mark.parametrize("plan", ["default", "autotune", "plans/winner.json"])
def test_plan_autotune_and_plan_files_are_accepted(plan):
    """Queue 1 item 9: SortConfig.plan takes "autotune" and a plan-file
    path (resolved when a sort runs), and the fingerprint ignores it."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, plan=plan)
    assert cfg.plan == plan
    assert plan_mod.config_fingerprint(cfg) == plan_mod.config_fingerprint(DEFAULT_CONFIG)


SERIALIZED = [  # (length, rows, dtype, config)
    (1, 1, "int32", DEFAULT_CONFIG), (77_777, 1, "float32", PAPER_CONFIG),
    (1 << 26, 1, "int32", DEFAULT_CONFIG), (20_000, 3, "int64",
                                           SortConfig(256, 16, 512, strategy="merge")),
    (5000, 256, "bfloat16", SortConfig(256, 16, 512, fuse_sampling=False,
                                       fuse_ranking=False, descending=True)),
    (1 << 20, 1, "uint32", SortConfig(strategy="radix", radix_bits=2)),
]


@pytest.mark.parametrize("sig", SERIALIZED, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_plan_serialization_round_trips_exactly(sig):
    length, rows, dtype, cfg = sig
    plan = plan_mod.build_plan(length, dtype, cfg, rows=rows)
    d = plan_mod.plan_to_dict(plan)
    assert d["schema"] == "torch_sort_plan/v1"
    assert plan_mod.plan_from_dict(json.loads(json.dumps(d))) == plan
    text = plan_mod.plan_json(plan)
    plan_mod._assemble_plan.cache_clear()  # an equal plan, built afresh
    again = plan_mod.build_plan(length, dtype, dataclasses.replace(cfg), rows=rows)
    assert again is not plan and again == plan
    assert plan_mod.plan_json(again) == text


def test_plan_from_dict_refuses_other_records():
    jax_record = jax_plan.plan_to_dict(jax_plan.build_plan(
        10_000, "int32", jax_cfg(256, 16, 512)))
    with pytest.raises(ValueError, match="not a torch_sort_plan/v1 record"):
        plan_mod.plan_from_dict(jax_record)
    d = plan_mod.plan_to_dict(plan_mod.build_plan(10_000, "int32", DEFAULT_CONFIG))
    for broken in ({k: v for k, v in d.items() if k != "schema"},
                   {**d, "schema": "torch_sort_plan/v0"},
                   {k: v for k, v in d.items() if k != "root"},
                   {**d, "block_rows": 8}):
        with pytest.raises(ValueError):
            plan_mod.plan_from_dict(broken)


@pytest.mark.parametrize("check", ["off", "bounds", "full"])
def test_every_check_mode_is_ported(check):
    """The checked modes run (Queue 1 item 7): a config takes each."""
    assert dataclasses.replace(DEFAULT_CONFIG, check=check).check == check


def test_named_configs_match_reference():
    from repro.core import sort_config as ref

    for ours, theirs in ((DEFAULT_CONFIG, ref.DEFAULT_CONFIG),
                         (PAPER_CONFIG, ref.PAPER_CONFIG)):
        assert (ours.tile, ours.s, ours.direct_max) == (
            theirs.tile, theirs.s, theirs.direct_max)
