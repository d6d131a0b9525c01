"""The port's whole main path against the JAX package's, bit for bit.

Seeded numpy inputs go through ``repro.core.bucket_sort`` with
``impl="xla"`` (the pure-jnp path; its Pallas path degrades on this JAX,
ROADMAP.md Queue 3 R1) and through ``repro_torch.core.bucket_sort`` with
``device="cpu"``.  Sorted keys, permutations and per-round stats must be
equal exactly; after every reference call its degradation log must be
empty.  The config is small (tile=256, s=16, direct_max=512) so sizes
cross tile and direct_max and plans have one to three bucket levels.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import contextlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core import clear_degradation_log, degradation_log  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import bucket_sort  # noqa: E402
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.core.plan import build_plan  # noqa: E402
from repro_torch.core.sort_config import SortConfig  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
DTYPES = ["int32", "uint32", "float32", "bfloat16", "int64", "float64"]


@pytest.fixture(autouse=True)
def _no_degradation():
    """The port's CPU chain falls back to other plans on a failure; a
    sound run here must never take it."""
    port_guard.clear_degradation_log()
    yield
    assert port_guard.degradation_log() == ()


def configs(order="asc", fuse_ranking=True):
    desc = order == "desc"
    return (JaxConfig(**GEOMETRY, impl="xla", descending=desc,
                      fuse_ranking=fuse_ranking),
            SortConfig(**GEOMETRY, descending=desc, fuse_ranking=fuse_ranking))


def reference(fn, *args, dtype="int32"):
    """Run a JAX entry point (x64 for 64-bit keys); numpy results."""
    ctx = jax.enable_x64(True) if dtype in ("int64", "uint64", "float64") \
        else contextlib.nullcontext()
    clear_degradation_log()
    with ctx:
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args))
        out = jax.tree_util.tree_map(np.asarray, out)
    assert degradation_log() == ()
    return out


def assert_stats_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("level_len", "rows", "s_round", "capacity"):
            assert g[key] == w[key], key
        np.testing.assert_array_equal(g["totals"].numpy(), w["totals"])
        assert int(g["max_within"]) == int(w["max_within"])


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_and_argsort_match_reference(dtype, order):
    rng = np.random.default_rng(DTYPES.index(dtype))
    a = make_keys(dtype, 1500, rng)
    jcfg, cfg = configs(order)
    want = reference(lambda x: jax_sort.sort(x, jcfg), a, dtype=dtype)
    want_perm = reference(lambda x: jax_sort.argsort(x, jcfg), a, dtype=dtype)
    got = bucket_sort.sort(to_torch(a), cfg, device="cpu")
    perm = bucket_sort.argsort(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got), bits(want))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want_perm)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16", "int64", "float64"])
def test_unfused_ranking_matches_reference(dtype):
    """fuse_ranking=False: K3 ranks and counts from the ranks, against the
    JAX pipeline with the same config, stats included."""
    rng = np.random.default_rng(100 + DTYPES.index(dtype))
    a = make_keys(dtype, 20_000, rng)
    jcfg, cfg = configs("desc" if dtype == "float32" else "asc", fuse_ranking=False)
    want = reference(lambda x: jax_sort.sort_with_stats(x, jcfg), a, dtype=dtype)
    got = bucket_sort.sort_with_stats(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])
    assert len(got[2]) == 2
    np.testing.assert_array_equal(
        bits(bucket_sort.sort(to_torch(a), cfg, device="cpu")), bits(want[0]))


@pytest.mark.parametrize("fuse_ranking", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("n", [1, 5, 256, 512, 513, 4097, 77_777])
def test_sizes_and_stats_match_reference(n, fuse_ranking):
    rng = np.random.default_rng(n)
    a = rng.integers(-40, 40, n).astype(np.int32)  # many ties: stability
    jcfg, cfg = configs(fuse_ranking=fuse_ranking)
    want = reference(lambda x: jax_sort.sort_with_stats(x, jcfg), a)
    got = bucket_sort.sort_with_stats(torch.from_numpy(a), cfg, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[1].numpy(), np.argsort(a, kind="stable"))
    assert_stats_equal(got[2], want[2])
    assert (len(got[2]) > 0) == (n > GEOMETRY["direct_max"])


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sort_kv_matches_reference(dtype):
    rng = np.random.default_rng(42)
    a = make_keys(dtype, 2000, rng)
    v = rng.standard_normal((2000, 3)).astype(np.float32)
    jcfg, cfg = configs()
    want = reference(lambda x, y: jax_sort.sort_kv(x, y, jcfg), a, v, dtype=dtype)
    got = bucket_sort.sort_kv(torch.from_numpy(a), torch.from_numpy(v), cfg,
                              device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("dtype,shape", [("float32", (3, 1000)), ("int64", (2, 700)),
                                         ("int32", (5, 77))])
def test_batched_entry_points_match_reference(dtype, shape):
    rng = np.random.default_rng(7)
    a = make_keys(dtype, shape[0] * shape[1], rng).reshape(shape)
    v = rng.standard_normal(shape + (2,)).astype(np.float32)
    jcfg, cfg = configs()
    x = to_torch(a)
    want = reference(lambda k: jax_sort.sort_batched_with_stats(k, jcfg), a,
                     dtype=dtype)
    got = bucket_sort.sort_batched_with_stats(x, cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])
    np.testing.assert_array_equal(
        bits(bucket_sort.sort_batched(x, cfg, device="cpu")), bits(want[0]))
    np.testing.assert_array_equal(
        bucket_sort.argsort_batched(x, cfg, device="cpu").numpy(), want[1])
    want_kv = reference(lambda k, y: jax_sort.sort_kv_batched(k, y, jcfg), a, v,
                        dtype=dtype)
    got_kv = bucket_sort.sort_kv_batched(x, torch.from_numpy(v), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got_kv[0]), bits(want_kv[0]))
    np.testing.assert_array_equal(got_kv[1].numpy(), want_kv[1])


@pytest.mark.parametrize("chunk", [100, 3000])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_glue_in_chunks_matches_reference(monkeypatch, dtype, chunk):
    """Relocation and compaction filled a few rows (or one row) at a
    time, as they are at sizes above ``_GLUE_CHUNK``."""
    monkeypatch.setattr(bucket_sort, "_GLUE_CHUNK", chunk)
    rng = np.random.default_rng(chunk)
    a = make_keys(dtype, 20_000, rng)
    jcfg, cfg = configs()
    want = reference(lambda x: jax_sort.sort_with_stats(x, jcfg), a, dtype=dtype)
    got = bucket_sort.sort_with_stats(torch.from_numpy(a), cfg, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert_stats_equal(got[2], want[2])


def test_default_config_bucket_level_matches_reference():
    """DEFAULT_CONFIG geometry at a length with a bucket level."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(20_000).astype(np.float32)
    want = reference(lambda x: jax_sort.argsort(x, JaxConfig(impl="xla")), a)
    got = bucket_sort.argsort(torch.from_numpy(a), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_planned_runs_an_explicit_plan():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(0, 100, (4, 600)).astype(np.int32))
    _, cfg = configs()
    plan = build_plan(600, torch.int32, cfg, rows=4)
    got = bucket_sort.sort_planned(a, plan, device="cpu")
    assert torch.equal(got, torch.sort(a, dim=1, stable=True).values)
    one = build_plan(600, torch.int32, cfg)
    assert torch.equal(bucket_sort.sort_planned(a[0].numpy(), one, device="cpu"),
                       got[0])
    with pytest.raises(ValueError, match="do not match plan"):
        bucket_sort.sort_planned(a[:, :500], plan, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(10, dtype=torch.int32)
    for fn in (bucket_sort.sort, bucket_sort.argsort, bucket_sort.sort_with_stats):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bucket_sort.sort_batched(x.reshape(2, 5))
    # A plan holds no device: sort_planned of a CPU tensor (or an array)
    # runs on the CPU only when asked to.
    plan = build_plan(10, torch.int32, SortConfig())
    for keys in (x, x.numpy(), x.tolist()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bucket_sort.sort_planned(keys, plan)
    assert torch.equal(bucket_sort.sort_planned(x.flip(0), plan, device="cpu"), x)


def test_trivial_shapes():
    _, cfg = configs()
    e = torch.zeros(0, dtype=torch.float32)
    assert bucket_sort.sort(e, cfg, device="cpu").shape == (0,)
    assert bucket_sort.argsort(torch.tensor([3.0]), cfg, device="cpu").tolist() == [0]
    assert bucket_sort.sort_with_stats(e, cfg, device="cpu")[2] == []
    b = torch.zeros((0, 7), dtype=torch.int32)
    assert bucket_sort.sort_batched(b, cfg, device="cpu").shape == (0, 7)
    assert bucket_sort.argsort_batched(torch.zeros((3, 1)), cfg,
                                       device="cpu").tolist() == [[0], [0], [0]]
    with pytest.raises(ValueError, match="1-D keys"):
        bucket_sort.sort(b, cfg, device="cpu")
    with pytest.raises(ValueError, match="do not match keys"):
        bucket_sort.sort_kv(torch.arange(4), torch.arange(5), cfg, device="cpu")
