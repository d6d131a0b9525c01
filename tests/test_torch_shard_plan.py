"""The port's ShardPlan, shard geometry and the distributed sort's steps
that need no collective, against the JAX package's.

Everything here runs in one process with no group: ``shard_geometry``,
``build_shard_plan`` (every field and the four sub-plans' trees, over a
sweep of shard lengths, d, oversample, pair_align, dtypes and orders),
the validation messages, the plan's record and launch walk, and the
tensor steps of ``core/distributed_sort.py`` (padding, the deal's
layout, the sample and splitter positions, the chunk destinations with
max_within, the scatter into the exchange buffer, the valid count), each
held against the reference's jnp expression on the same inputs.  The
sweep keeps out the s = 2 region the reference's planner cannot build
(ROADMAP.md R3).
"""

import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distributed_sort as jax_dist  # noqa: E402
from repro.core import plan as jax_plan  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import distributed_sort as dsort  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    SHARD_SUBPLANS,
    build_shard_plan,
    kernel_launches,
    plan_launches,
    shard_geometry,
    shard_launches,
    shard_plan_from_dict,
    shard_plan_json,
    shard_plan_to_dict,
)
from repro_torch.core.sort_config import SortConfig  # noqa: E402

SMALL = dict(tile=256, s=16, direct_max=512)
BASE = dict(tile=4096, s=64, direct_max=8192)
MAXU = jnp.uint32(0xFFFFFFFF)


def x64(dtype: str):
    if dtype in ("int64", "uint64", "float64"):
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def reference_plan(axis, d, n_local, dtype, geometry, desc=False, **kw):
    with x64(dtype):
        return jax_plan.build_shard_plan(
            axis, d, n_local, dtype,
            JaxConfig(**geometry, impl="xla", descending=desc), **kw)


def port_plan(axis, d, n_local, dtype, geometry, desc=False, **kw):
    return build_shard_plan(axis, d, n_local, dtype,
                            SortConfig(**geometry, descending=desc), **kw)


def _sweep():
    rng = np.random.default_rng(3)
    cases = [("data", 2, 1, "int32", SMALL, False, 8, 8),
             (("data", "model"), 8, 512, "float64", SMALL, True, 8, 8),
             ("data", 4, 1 << 16, "int32", BASE, False, 8, 128),
             ("data", 2, 1 << 20, "uint32", BASE, True, 16, 256)]
    dtypes = ["int32", "uint32", "float32", "int64", "float64", "bfloat16",
              "bool", "int8"]
    for _ in range(36):
        cases.append((
            "data", int(rng.choice([2, 3, 4, 5, 8, 16])),
            int(rng.integers(1, 40_000)), str(rng.choice(dtypes)), SMALL,
            bool(rng.integers(0, 2)), int(2 ** rng.integers(0, 6)),
            int(2 ** rng.integers(3, 9)),
        ))
    return cases


@pytest.mark.parametrize("axis,d,n_local,dtype,geometry,desc,oversample,pair_align",
                         _sweep())
def test_shard_plan_equals_the_reference(axis, d, n_local, dtype, geometry, desc,
                                         oversample, pair_align):
    kw = dict(oversample=oversample, pair_align=pair_align)
    ref = reference_plan(axis, d, n_local, dtype, geometry, desc, **kw)
    got = port_plan(axis, d, n_local, dtype, geometry, desc, **kw)
    assert interop.shard_plan_tree(got) == interop.shard_plan_tree(ref)
    for prop in ("n_glob", "bytes_per_element", "exchange_elements",
                 "collective_elements"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    assert got.signature()[:7] == ref.signature()[:7]
    g, rg = shard_geometry(n_local, d, oversample, pair_align), \
        jax_plan.shard_geometry(n_local, d, oversample, pair_align)
    assert dataclasses.asdict(g) == dataclasses.asdict(rg)
    spec = dsort.DistSortSpec(axis, d, n_local, oversample, pair_align)
    rspec = jax_dist.DistSortSpec(axis, d, n_local, oversample, pair_align)
    for prop in ("axis_tuple", "s_loc", "n_pad", "b_t", "c_pair", "out_cap"):
        assert getattr(spec, prop) == getattr(rspec, prop), prop


@pytest.mark.parametrize("strategy,fuse", [("radix", True), ("merge", False)])
def test_only_the_shard_sort_takes_a_key_only_strategy(strategy, fuse):
    """The run plan is the reference's; the dealt, sample and bucket plans
    are the reference's for the bitonic strategy (ROADMAP.md R5, D13)."""
    geometry = dict(SMALL, strategy=strategy, fuse_ranking=fuse,
                    fuse_sampling=fuse)
    ref = reference_plan("data", 4, 3000, "int32", geometry)
    ref_bitonic = reference_plan("data", 4, 3000, "int32",
                                 dict(geometry, strategy="bitonic"))
    got = port_plan("data", 4, 3000, "int32", geometry)
    assert interop.plan_tree(got.run_plan) == interop.plan_tree(ref.run_plan)
    assert got.run_plan.root.strategy == strategy
    for name in SHARD_SUBPLANS[1:]:
        assert interop.plan_tree(getattr(got, name)) == interop.plan_tree(
            getattr(ref_bitonic, name)), name
    assert interop.shard_plan_tree(got)[:13] == interop.shard_plan_tree(ref)[:13]


def test_build_shard_plan_is_memoized_and_describes_itself():
    a = port_plan("data", 4, 2048, "int32", SMALL)
    assert port_plan(("data",), 4, 2048, "int32", SMALL) is a
    assert port_plan("data", 4, 2048, "int32", SMALL, oversample=4) != a
    text = a.describe()
    assert text.startswith("ShardPlan(axis=('data',), d=4, n_local=2048->2048")
    assert all(name in text for name in SHARD_SUBPLANS)


def _messages(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", [
    dict(n_local=0), dict(n_local=2.5), dict(d=1), dict(oversample=3),
    dict(oversample=0), dict(pair_align=4), dict(pair_align=12),
])
def test_shard_geometry_messages_equal_the_reference(kw):
    args = {**dict(n_local=1024, d=4, oversample=8, pair_align=8), **kw}
    got = _messages(lambda: shard_geometry(**args))
    assert got is not None
    assert got == _messages(lambda: jax_plan.shard_geometry(**args))


def test_build_shard_plan_messages_equal_the_reference():
    for kw in (dict(oversample=6), dict(pair_align=2)):
        got = _messages(lambda: port_plan("data", 4, 1024, "int32", SMALL, **kw))
        assert got is not None
        assert got == _messages(
            lambda: reference_plan("data", 4, 1024, "int32", SMALL, **kw))


# ----------------------------------------------------------------------
# The plan's record and launch walk
# ----------------------------------------------------------------------


def test_shard_plan_record_round_trips_exactly():
    p = port_plan(("data", "model"), 8, 5000, "float64", SMALL, True,
                  oversample=4, pair_align=128)
    assert shard_plan_from_dict(shard_plan_to_dict(p)) == p
    assert shard_plan_from_dict(json.loads(shard_plan_json(p))) == p
    assert shard_plan_json(p) == shard_plan_json(
        shard_plan_from_dict(json.loads(shard_plan_json(p))))


def test_shard_plan_record_refuses_other_records():
    p = port_plan("data", 4, 2048, "int32", SMALL)
    ref_rec = jax_plan.shard_plan_to_dict(reference_plan("data", 4, 2048,
                                                         "int32", SMALL))
    with pytest.raises(ValueError, match="torch_shard_plan/v1"):
        shard_plan_from_dict(ref_rec)
    rec = shard_plan_to_dict(p)
    del rec["c_pair"]
    with pytest.raises(ValueError, match="malformed"):
        shard_plan_from_dict(rec)
    rec = shard_plan_to_dict(p)
    rec["bucket_plan"]["schema"] = "sort_plan/v2"
    with pytest.raises(ValueError, match="torch_sort_plan/v1"):
        shard_plan_from_dict(rec)


@pytest.mark.parametrize("strategy", ["bitonic", "radix"])
def test_shard_launches_walk_the_four_sub_plans_and_k3(strategy):
    p = port_plan("data", 4, 3000, "int32", dict(SMALL, strategy=strategy))
    want = []
    for name in SHARD_SUBPLANS:
        if name == "bucket_plan":
            want.append(("splitter_ranks", 1, p.n_pad, 3))
        want += kernel_launches(getattr(p, name).root)
    assert shard_launches(p) == want
    counts = plan_launches(p)
    assert counts["splitter_ranks"] == 1
    assert sum(counts.values()) == len(want)


# ----------------------------------------------------------------------
# The steps without a collective, against the reference's jnp
# ----------------------------------------------------------------------


def biased(a: np.ndarray) -> torch.Tensor:
    return interop.words_from_numpy(a)[0]


@pytest.mark.parametrize("n0,n_pad,me", [(1000, 1024, 0), (1000, 1024, 3),
                                         (1024, 1024, 1), (1, 32, 1)])
def test_pad_shard_equals_the_reference(n0, n_pad, me):
    rng = np.random.default_rng(n0 + me)
    w = rng.integers(0, 2**32, n0, dtype=np.uint64).astype(np.uint32)
    v = rng.permutation(n0).astype(np.int32)
    n_glob, pad_n = 4 * n_pad, n_pad - n0
    want_w, want_v = w, v
    if pad_n:
        want_w = np.concatenate([w, np.full(pad_n, 0xFFFFFFFF, np.uint32)])
        want_v = np.asarray(jnp.concatenate([
            jnp.asarray(v),
            n_glob + me * pad_n + jnp.arange(pad_n, dtype=jnp.int32)]))
    kw, vals = dsort.pad_shard((biased(w),), torch.from_numpy(v), n_pad,
                               n_glob, me)
    np.testing.assert_array_equal(interop.words_to_numpy(kw)[0], want_w)
    np.testing.assert_array_equal(vals.numpy(), want_v)


@pytest.mark.parametrize("n_pad,d", [(64, 2), (96, 3), (1024, 8)])
def test_deal_layout_is_the_references_transpose(n_pad, d):
    x = np.arange(n_pad, dtype=np.int32) * 7 - 5
    want = np.asarray(jnp.swapaxes(jnp.asarray(x).reshape(n_pad // d, d), 0, 1))
    np.testing.assert_array_equal(dsort.deal_layout(torch.from_numpy(x), d).numpy(),
                                  want)
    stacked = dsort.deal_layout(torch.from_numpy(np.stack([x, -x])), d)
    np.testing.assert_array_equal(stacked[:, 0].numpy(), want)
    np.testing.assert_array_equal(stacked[:, 1].numpy(), -want)


@pytest.mark.parametrize("n_pad,d,oversample", [(1024, 4, 8), (96, 3, 2),
                                                (4096, 8, 1), (64, 2, 32)])
def test_sample_and_splitter_positions_equal_the_reference(n_pad, d, oversample):
    s_loc = oversample * d
    want_s = (jnp.arange(1, s_loc + 1, dtype=jnp.int32) * (n_pad // s_loc)) - 1
    want_p = (jnp.arange(1, d, dtype=jnp.int32) * (d * s_loc)) // d
    np.testing.assert_array_equal(dsort.sample_index(n_pad, s_loc).numpy(),
                                  np.asarray(want_s))
    np.testing.assert_array_equal(dsort.splitter_index(d, s_loc).numpy(),
                                  np.asarray(want_p))


def reference_chunks(ranks, n_pad, c_pair, d):
    """The reference's step 6 geometry (core/distributed_sort.py)."""
    ranks = jnp.asarray(ranks)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), ranks])
    ends = jnp.concatenate([ranks, jnp.full((1,), n_pad, jnp.int32)])
    counts = ends - starts
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    ind = jnp.zeros((n_pad + 1,), jnp.int32).at[ranks].add(1)
    chunk_id = jnp.cumsum(ind, dtype=jnp.int32)[:n_pad]
    within = pos - jnp.take(starts, chunk_id)
    max_within = jnp.max(within)
    dest = chunk_id * c_pair + within
    dest = jnp.where(within < c_pair, dest, d * c_pair)
    return dest, counts, max_within


def chunk_cases():
    rng = np.random.default_rng(11)
    out = []
    for d, n_pad, c_pair in [(2, 64, 40), (4, 1024, 296), (8, 512, 80),
                             (4, 1024, 64), (3, 96, 8)]:
        for kind in ("random", "equal", "ends"):
            if kind == "random":
                ranks = np.sort(rng.integers(0, n_pad + 1, d - 1))
            elif kind == "equal":
                ranks = np.full(d - 1, n_pad // 2)
            else:
                ranks = np.array([0] * (d // 2) + [n_pad] * (d - 1 - d // 2))
            out.append((ranks.astype(np.int32), n_pad, c_pair, d))
    return out


@pytest.mark.parametrize("ranks,n_pad,c_pair,d", chunk_cases())
def test_chunk_destinations_and_scatter_equal_the_reference(ranks, n_pad, c_pair, d):
    dest, counts, mw = dsort.chunk_destinations(torch.from_numpy(ranks), n_pad,
                                                c_pair, d)
    rdest, rcounts, rmw = reference_chunks(ranks, n_pad, c_pair, d)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert int(mw) == int(rmw) and mw.dtype == torch.int32

    rng = np.random.default_rng(n_pad)
    w = rng.integers(0, 2**32, n_pad, dtype=np.uint64).astype(np.uint32)
    v = rng.permutation(n_pad).astype(np.int32)
    pad_base = 10 * n_pad
    bkw, bv = dsort.scatter_buckets((biased(w),), torch.from_numpy(v), dest,
                                    d, c_pair, pad_base)
    want_w = jnp.full((d * c_pair,), MAXU, jnp.uint32).at[rdest].set(
        jnp.asarray(w), mode="drop")
    want_v = (jnp.int32(pad_base) + jnp.arange(d * c_pair, dtype=jnp.int32)
              ).at[rdest].set(jnp.asarray(v), mode="drop")
    np.testing.assert_array_equal(interop.words_to_numpy(bkw)[0],
                                  np.asarray(want_w))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("d,n_pad,out_cap", [(2, 1024, 1152), (4, 256, 320)])
def test_valid_count_equals_the_reference(d, n_pad, out_cap):
    rng = np.random.default_rng(d)
    n_glob = d * n_pad
    fv = rng.integers(0, n_glob + 2 * d * n_pad, 2 * out_cap).astype(np.int32)
    recv = rng.integers(0, n_pad, d).astype(np.int32)
    want = jnp.sum(jnp.asarray(recv), dtype=jnp.int32) - jnp.sum(
        (jnp.asarray(fv)[:out_cap] >= n_glob)
        & (jnp.asarray(fv)[:out_cap] < n_glob + d * n_pad), dtype=jnp.int32)
    got = dsort.valid_count(torch.from_numpy(recv), torch.from_numpy(fv),
                            out_cap, n_glob, d, n_pad)
    assert int(got) == int(want)

