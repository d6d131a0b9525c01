"""The port's partial sort (top-k) against the JAX package's, bit for bit.

Seeded numpy scores go through ``repro.core.partial_sort`` with
``impl="xla"`` (its Pallas path degrades on this JAX, ROADMAP.md Queue 3
R1; its degradation log must stay empty, so no call took the
``jax.lax.top_k`` fallback) and through ``repro_torch.core.partial_sort``
with ``device="cpu"``.  Values (as raw bits) and indices must be equal.
The geometry is small (tile 128, s 8, direct_max 256) so lengths cross
the tile and direct_max and the candidate buffer holds a few tiles.
64-bit dtypes run the JAX side under ``jax.enable_x64(True)``.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from test_torch_bucket_sort import reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import partial_sort as jax_partial  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import partial_sort  # noqa: E402
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.core.plan import build_words_plan  # noqa: E402
from repro_torch.core.sort_config import SortConfig  # noqa: E402
from repro_torch.kernels import bitonic, ops  # noqa: E402

GEOMETRY = dict(tile=128, s=8, direct_max=256)
JCFG = JaxConfig(**GEOMETRY, impl="xla")
CFG = SortConfig(**GEOMETRY)
# (n, k): both sides of direct_max, k from 1 to n.  float32 (NaN, +-inf,
# -0.0) takes every case; the other 32-bit dtypes a case on each side of
# direct_max and one of many tiles; the 64-bit ones (x64 on the JAX
# side) only cases past direct_max.
CASES = [(1, 1), (100, 37), (256, 256), (257, 1), (1000, 7), (1000, 1000),
         (3000, 50), (3000, 2999)]
TOPK_CASES = (
    [("float32", n, k) for n, k in CASES]
    + [(d, n, k) for d in ("bfloat16", "int8", "uint32")
       for n, k in ((100, 37), (257, 1), (3000, 50))]
    + [(d, n, k) for d in ("int64", "float64") for n, k in ((1000, 7), (3000, 2999))]
)
BATCHED_CASES = (
    [("float32", rows, n, k) for rows in (1, 3)
     for n, k in ((100, 37), (257, 1), (1000, 7), (3000, 50), (3000, 2999))]
    + [(d, 3, n, k) for d in ("bfloat16", "int8", "uint32")
       for n, k in ((257, 1), (3000, 50))]
    + [(d, 3, 3000, 50) for d in ("int64", "float64")]
)


@pytest.fixture(autouse=True)
def _no_degradation():
    """The port's CPU chain falls back to other plans on a failure; a
    sound run here must never take it."""
    port_guard.clear_degradation_log()
    yield
    assert port_guard.degradation_log() == ()


def scores(dtype, shape, seed):
    """make_keys with heavy ties: ints from a few values."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    a = make_keys(dtype, n, rng)
    if dtype in ("int8", "uint32", "int64"):
        a = a[rng.integers(0, min(6, n), n)]  # six distinct values
    return a.reshape(shape)


def assert_topk_equal(got, want):
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("dtype,n,k", TOPK_CASES)
def test_topk_matches_reference(dtype, n, k):
    a = scores(dtype, (n,), n + k)
    want = reference(lambda x: jax_partial.topk(x, k, JCFG), a, dtype=dtype)
    got = partial_sort.topk(to_torch(a), k, CFG, device="cpu")
    assert got[0].dtype == to_torch(a).dtype
    assert_topk_equal(got, want)


@pytest.mark.parametrize("dtype,rows,n,k", BATCHED_CASES)
def test_topk_batched_matches_reference(dtype, rows, n, k):
    a = scores(dtype, (rows, n), rows * n + k)
    want = reference(lambda x: jax_partial.topk_batched(x, k, JCFG), a, dtype=dtype)
    got = partial_sort.topk_batched(to_torch(a), k, CFG, device="cpu")
    assert got[0].shape == (rows, k)
    assert_topk_equal(got, want)


def test_default_config_matches_reference():
    a = scores("float32", (2, 20_000), 5)
    cfg = JaxConfig(impl="xla")
    want = reference(lambda x: jax_partial.topk(x, 10, cfg), a[0])
    assert_topk_equal(partial_sort.topk(torch.from_numpy(a[0]), 10, device="cpu"),
                      want)
    want = reference(lambda x: jax_partial.topk_batched(x, 300, cfg), a)
    assert_topk_equal(
        partial_sort.topk_batched(torch.from_numpy(a), 300, device="cpu"), want)


@pytest.mark.parametrize("entry", ["topk", "topk_batched"])
@pytest.mark.parametrize("n,k", [(200, 150), (5000, 3), (5000, 4000)],
                         ids=lambda c: str(c))
def test_wide_rows_go_through_the_executor(monkeypatch, entry, n, k):
    """Rows wider than K1 takes (here MAX_TILE = 64) are sorted by the
    bucket-sort executor: the sample rows (m*s > 64), the candidate rows
    (ccap > 64) and the direct path (n > 64).  The result is the same."""
    monkeypatch.setattr(bitonic, "MAX_TILE", 64)
    wide = []
    real = partial_sort._sort_wide_rows

    def spy(kw, v, plan, base):
        wide.append(v.shape)
        return real(kw, v, plan, base)

    monkeypatch.setattr(partial_sort, "_sort_wide_rows", spy)
    rows = 1 if entry == "topk" else 3
    a = scores("float32", (rows, n), n + k)
    a[:, : n // 3] = 1.5  # ties across tiles and samples
    if entry == "topk":
        a = a[0]
    want = reference(lambda x: getattr(jax_partial, entry)(x, k, JCFG), a)
    got = getattr(partial_sort, entry)(torch.from_numpy(a), k, CFG, device="cpu")
    assert_topk_equal(got, want)
    assert wide and all(shape[1] > 64 for shape in wide)
    if n > GEOMETRY["direct_max"]:
        assert len(wide) == 2  # samples, then candidates


def test_wide_rows_follow_the_callers_config(monkeypatch):
    """The executor sorts a wide row with the caller's config: with
    fuse_ranking=False it ranks with K3 and never partitions with K2."""
    monkeypatch.setattr(bitonic, "MAX_TILE", 64)
    calls = []
    for name in ("splitter_partition", "splitter_ranks"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    a = scores("float32", (3, 5000), 11)
    jcfg = JaxConfig(**GEOMETRY, impl="xla", fuse_ranking=False)
    want = reference(lambda x: jax_partial.topk_batched(x, 300, jcfg), a)
    cfg = SortConfig(**GEOMETRY, fuse_ranking=False)
    got = partial_sort.topk_batched(torch.from_numpy(a), 300, cfg, device="cpu")
    assert_topk_equal(got, want)
    assert "splitter_partition" not in calls
    assert calls.count("splitter_ranks") > 1  # the round's, then the executor's


def test_wide_rows_restore_the_pads():
    """The executor route returns exactly what padding and one K1 sort
    give, pads (pad word, INT_MAX) included."""
    rng = np.random.default_rng(4)
    plan = build_words_plan(300, 1, CFG, rows=2)
    kw = (torch.from_numpy(rng.integers(-5, 5, (2, 300)).astype(np.int32)),)
    v = torch.from_numpy(np.argsort(rng.random((2, 300)), 1).astype(np.int32))
    kw[0][:, 200:] = partial_sort._PAD
    v[:, 250:] = partial_sort._INT_MAX
    got = partial_sort._sort_wide_rows(kw, v, plan, 5000)
    want = ops.sort_tiles(*partial_sort._pad_pow2(kw, v))
    assert torch.equal(got[0][0], want[0][0][:, :300])
    assert torch.equal(got[1], want[1][:, :300])


def test_entry_points_refuse_bad_input(monkeypatch):
    x = torch.arange(10, dtype=torch.float32)
    for k in (0, 11):
        with pytest.raises(ValueError, match="1 <= k <= length"):
            partial_sort.topk(x, k, device="cpu")
        with pytest.raises(ValueError, match="1 <= k <= length"):
            partial_sort.topk_batched(x.reshape(2, 5), k + 5 * (k > 0), device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        partial_sort.topk(x.reshape(2, 5), 1, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        partial_sort.topk_batched(x, 1, device="cpu")
    v, i = partial_sort.topk_batched(torch.zeros((0, 7), dtype=torch.int8), 3,
                                     device="cpu")
    assert v.shape == (0, 3) and v.dtype == torch.int8 and i.dtype == torch.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, arg in ((partial_sort.topk, x), (partial_sort.topk_batched, x[None])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(arg, 2)


def test_cpu_top_k_launches_nothing():
    ops.reset_launch_counts()
    x = torch.from_numpy(scores("float32", (2, 3000), 1))
    partial_sort.topk_batched(x, 9, CFG, device="cpu")
    assert set(ops.launch_counts().values()) == {0}
