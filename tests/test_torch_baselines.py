"""The port's baselines against the JAX package's, bit for bit.

* The randomized sample sort's round (``_randomized_canonical``) gets the
  sample positions that ``jax.random.randint(key, (8*s,), 0, lp)`` drew
  for the reference, and must give its words, permutation, largest
  bucket fill and overflow count exactly, overflowing
  (``capacity_factor`` 1.0 or 0.5) or not.  The retry and exhaustion paths of
  ``tests/test_faults.py`` run with a ``torch.Generator``.
* ``merge_sort`` and ``torch_sort`` / ``torch_sort_batched`` against
  ``merge_sort`` and ``xla_sort`` / ``xla_sort_batched``.

The JAX side runs ``impl="xla"`` (64-bit keys under
``jax.enable_x64(True)``); tolerance zero: raw bits and exact
permutations.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import contextlib  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_bucket_sort import reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import guard as jax_guard  # noqa: E402
from repro.core.key_codec import codec_for as jax_codec_for  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import baselines, bucket_sort, guard  # noqa: E402
from repro_torch.core.key_codec import codec_for  # noqa: E402
from repro_torch.core.sort_config import SortConfig, round_up  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
CFG = SortConfig(**GEOMETRY)
JCFG = JaxConfig(**GEOMETRY, impl="xla")


@pytest.fixture(autouse=True)
def _clean_log():
    guard.clear_degradation_log()
    jax_guard.clear_degradation_log()
    yield
    guard.clear_degradation_log()
    jax_guard.clear_degradation_log()


def x64(dtype):
    return (jax.enable_x64(True) if dtype in ("int64", "float64")
            else contextlib.nullcontext())


@pytest.mark.parametrize("dtype,n,factor,desc", [
    ("int32", 5000, 4.0, False),
    ("int32", 4096, 1.0, False),      # overflows: dropped elements
    ("float32", 3001, 2.0, True),
    ("int64", 2500, 0.5, False),      # overflows
    ("uint32", 7000, 8.0, False),
])
def test_randomized_round_matches_reference_given_its_samples(dtype, n, factor,
                                                              desc):
    a = make_keys(dtype, n, np.random.default_rng(n))
    if dtype == "int32":
        a = a % 1000  # ties
    jcfg = JaxConfig(**GEOMETRY, impl="xla", descending=desc)
    cfg = SortConfig(**GEOMETRY, descending=desc)
    key = jax.random.PRNGKey(n)
    lp = round_up(n, cfg.tile)
    with x64(dtype):
        jc = jax_codec_for(a.dtype, desc)
        skw, sv, (mf, ovf) = jax_baselines._randomized_canonical(
            jc.encode(jnp.asarray(a)), key, jcfg, factor, True)
        want = (np.asarray(jc.decode(skw)), np.asarray(sv), int(mf), int(ovf))
        idx = np.asarray(jax.random.randint(
            key, (baselines.OVERSAMPLE * cfg.s,), 0, lp))
    c = codec_for(to_torch(a).dtype, desc)
    gkw, gv, (gmf, govf) = baselines._randomized_canonical(
        c.encode(to_torch(a)), torch.from_numpy(idx.copy()), cfg, factor, True)
    np.testing.assert_array_equal(bits(c.decode(gkw)), bits(want[0]))
    np.testing.assert_array_equal(gv.numpy(), want[1])
    assert (int(gmf), int(govf)) == want[2:]
    assert gmf.dtype == govf.dtype == torch.int32
    assert (want[3] > 0) == (factor <= 1.0)


def test_randomized_sample_sort_uniform():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -(10**9), 10**9, 40_000).astype(np.int32))
    srt, perm, (maxfill, ovf) = baselines.randomized_sample_sort(
        x, torch.Generator().manual_seed(0), CFG, capacity_factor=4.0,
        with_stats=True, device="cpu")
    assert int(ovf) == 0 and int(maxfill) <= round_up(4 * 40_192 // 16, 128)
    assert torch.equal(srt, torch.sort(x).values)
    assert torch.equal(perm.long(), torch.sort(x, stable=True).indices)
    assert guard.degradation_log() == ()


def test_randomized_baseline_retries_on_adversarial_input():
    """Factor 1.0 on all-equal keys overflows; the loop doubles its way
    out or raises the structured error, while the deterministic sort
    needs no retry on the same keys (tests/test_faults.py)."""
    x = torch.full((20_000,), 42, dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        try:
            srt, perm, (mf, ovf) = baselines.randomized_sample_sort(
                x, torch.Generator().manual_seed(0), CFG, capacity_factor=1.0,
                with_stats=True, max_attempts=6, device="cpu")
        except guard.SortRuntimeError as e:
            assert e.site.startswith("baselines.randomized_sample_sort")
            return
    assert torch.equal(srt, x) and int(ovf) == 0
    assert torch.equal(perm, torch.arange(20_000, dtype=torch.int32))
    retries = [ev for ev in guard.degradation_log() if ev.action == "retry"]
    assert retries, "factor 1.0 on all-duplicates must overflow at least once"
    assert retries[0].frm == "capacity_factor=1"
    # Raw single-shot mode keeps the overflow observable and never raises.
    _, _, (_, ovf1) = baselines.randomized_sample_sort(
        x, torch.Generator().manual_seed(0), CFG, capacity_factor=1.0,
        with_stats=True, max_attempts=1, device="cpu")
    assert int(ovf1) > 0
    guard.clear_degradation_log()
    assert torch.equal(bucket_sort.sort(x, CFG, device="cpu"), x)
    assert guard.degradation_log() == ()


def test_randomized_baseline_exhaustion_raises_as_the_reference():
    n = 20_000
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jax_guard.DegradationWarning)
        with pytest.raises(jax_guard.SortRuntimeError) as want:
            jax_baselines.randomized_sample_sort(
                jnp.asarray(np.full(n, 7, np.int32)), jax.random.PRNGKey(0),
                JCFG, capacity_factor=0.125, max_attempts=2)
    with pytest.warns(guard.DegradationWarning):
        with pytest.raises(guard.SortRuntimeError) as got:
            baselines.randomized_sample_sort(
                torch.full((n,), 7, dtype=torch.int32),
                torch.Generator().manual_seed(0), CFG, capacity_factor=0.125,
                max_attempts=2, device="cpu")
    assert "overflow persisted" in got.value.detail
    assert got.value.site == want.value.site
    assert got.value.invariant == want.value.invariant
    assert [(ev.action, ev.frm, ev.to) for ev in guard.degradation_log()] == [
        (ev.action, ev.frm, ev.to) for ev in jax_guard.degradation_log()]
    with pytest.raises(ValueError, match="max_attempts"):
        baselines.randomized_sample_sort(torch.arange(4), None, max_attempts=0,
                                         device="cpu")


@pytest.mark.parametrize("dtype,n,desc", [
    ("int32", 6000, False),     # 24 tiles: rows padded to 32
    ("int32", 3000, True),
    ("float32", 257, False),
    ("int64", 1024, False),
    ("float64", 1500, True),
    ("bfloat16", 700, False),
    ("int32", 0, False),
])
def test_merge_sort_matches_reference(dtype, n, desc):
    rng = np.random.default_rng(n + 1)
    a = make_keys(dtype, n, rng)
    if dtype == "int32":
        a = a % 5  # ties: stability
    jcfg = JaxConfig(**GEOMETRY, impl="xla", descending=desc)
    cfg = SortConfig(**GEOMETRY, descending=desc)
    want = reference(lambda x: jax_baselines.merge_sort(x, jcfg), a, dtype=dtype)
    got = baselines.merge_sort(to_torch(a), cfg, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "bfloat16",
                                   "int64", "float64"])
def test_torch_sort_matches_xla_sort(dtype, desc):
    rng = np.random.default_rng(7)
    a = make_keys(dtype, 3000, rng)
    want = reference(lambda x: jax_baselines.xla_sort(x, desc), a, dtype=dtype)
    got = baselines.torch_sort(to_torch(a), desc, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    b = make_keys(dtype, 3 * 500, rng).reshape(3, 500)
    want = reference(lambda x: jax_baselines.xla_sort_batched(x, desc), b,
                     dtype=dtype)
    got = baselines.torch_sort_batched(to_torch(b), desc, device="cpu")
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_baselines_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(8, dtype=torch.int32)
    for fn in (baselines.merge_sort, baselines.torch_sort):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baselines.randomized_sample_sort(x, torch.Generator())
