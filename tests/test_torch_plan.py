"""The port's config and planner against the JAX package's.

``plan_tree`` (kind, rows, length, lp, tile, s, m, s_round, cap and the
recursion tree) must be equal to the reference plan's, bit for bit,
across a sweep of (length, rows, words, config).  Where the reference
planner cannot finish (a level that never shrinks), the port refuses up
front with a ValueError naming ``s``.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import dataclasses  # noqa: E402

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


def jax_cfg(tile, s, direct_max):
    return JaxConfig(tile=tile, s=s, direct_max=direct_max, impl="xla")


@pytest.mark.parametrize("rows", [1, 3, 256])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_plan_tree_matches_reference(geometry, rows):
    cfg = SortConfig(*geometry)
    for length in LENGTHS:
        for dtype in ("int32", "int64"):
            want = jax_plan.build_plan(length, dtype, jax_cfg(*geometry), rows=rows)
            got = plan_mod.build_plan(length, dtype, cfg, rows=rows, device="cpu")
            assert plan_tree(got) == plan_tree(want), (length, dtype)
            assert got.num_levels == want.num_levels
        for nw in (1, 2):
            want = jax_plan.build_words_plan(length, nw, jax_cfg(*geometry), rows=rows)
            got = plan_mod.build_words_plan(length, nw, cfg, rows=rows, device="cpu")
            assert plan_tree(got) == plan_tree(want)


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
                plan_mod.build_plan(length, "int32", cfg, rows=rows, device="cpu")
        else:
            got = plan_mod.build_plan(length, "int32", cfg, rows=rows, device="cpu")
            assert plan_tree(got) == plan_tree(want), (tile, s, direct_max, length)
    assert refused > 0


@pytest.mark.parametrize("tile,s,length", [(128, 2, 257), (64, 64, 1000), (8, 4, 16)])
def test_non_shrinking_level_is_refused_naming_s(tile, s, length):
    cfg = SortConfig(tile=tile, s=s, direct_max=tile)
    with pytest.raises(ValueError, match=rf"SortConfig.s={s} cannot shrink"):
        plan_mod.build_plan(length, "int32", cfg, device="cpu")


def test_kernel_geometry_is_rows_per_cta():
    """The kernel wrappers size their CTAs from the tile shape alone; the
    plan carries no TPU block field and SortConfig no block_rows."""
    p = plan_mod.build_plan(1 << 26, "int32", DEFAULT_CONFIG, device="cpu")
    top = p.root
    assert bitonic.effective_block_rows(top.rows * top.m, top.tile) == 1
    assert splitter.partition_block_rows(top.rows * top.m) == 4
    assert bitonic.effective_block_rows(1024, 64) == 32
    assert bitonic.effective_block_rows(1023, 64) == 1
    assert bitonic.effective_block_rows(8, 2) == 8
    assert splitter.partition_block_rows(3) == 3
    d = plan_mod.build_plan(100, "int32", SortConfig(), rows=64, device="cpu").root
    assert (d.kind, d.lp) == ("direct", 128)
    assert bitonic.effective_block_rows(d.rows, d.lp) == 16
    for name in ("block_rows", "part_block_rows"):
        assert not hasattr(top, name)
    assert not hasattr(DEFAULT_CONFIG, "block_rows")


def test_plan_impl_follows_device_and_rejects_a_mismatch():
    assert plan_mod.build_plan(10, "int32", SortConfig(), device="cpu").impl == "torch"
    assert plan_mod.build_plan(10, "int32", SortConfig()).impl == "cuda"
    assert plan_mod.build_plan(10, "int32", SortConfig(impl="torch"),
                               device="cpu").impl == "torch"
    with pytest.raises(ValueError, match="SortConfig.impl='cuda'"):
        plan_mod.build_plan(10, "int32", SortConfig(impl="cuda"), device="cpu")


def test_plan_is_memoized_and_describes_itself():
    a = plan_mod.build_plan(77_777, "float32", PAPER_CONFIG, device="cpu")
    b = plan_mod.build_plan(77_777, torch.float32, PAPER_CONFIG, device="cpu")
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
    ("impl", "pallas", "SortConfig.impl"),
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
    ("strategy", "radix", "Queue 1 item 6"),
    ("relocation", "scatter", "Queue 1 item 4"),
    ("fuse_ranking", False, "Queue 1 item 5"),
    ("fuse_sampling", False, "Queue 1 item 4"),
    ("plan", "autotune", "Queue 1 item 9"),
    ("check", "bounds", "Queue 1 item 7"),
])
def test_unported_values_raise_naming_field_and_roadmap_item(field, value, item):
    with pytest.raises(NotImplementedError, match=rf"SortConfig.{field}=.*{item}"):
        dataclasses.replace(DEFAULT_CONFIG, **{field: value})


def test_named_configs_match_reference():
    from repro.core import sort_config as ref

    for ours, theirs in ((DEFAULT_CONFIG, ref.DEFAULT_CONFIG),
                         (PAPER_CONFIG, ref.PAPER_CONFIG)):
        assert (ours.tile, ours.s, ours.direct_max) == (
            theirs.tile, theirs.s, theirs.direct_max)
