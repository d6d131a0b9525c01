"""The port's segmented sort against the JAX package's, bit for bit.

``segment_sort`` / ``segment_argsort`` run on the cases of
``tests/test_conformance.py`` (empty, single-element and
longer-than-``direct_max`` segments) over six dtypes and both orders,
against ``repro.core.bucket_sort`` with ``impl="xla"`` (64-bit keys
under ``jax.enable_x64(True)``, the reference's degradation log empty).
Tolerance zero: raw bits of the keys, exact permutations.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from test_torch_bucket_sort import reference  # noqa: E402
from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.core import bucket_sort as jax_sort  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch.core import bucket_sort, guard  # noqa: E402
from repro_torch.core.sort_config import SortConfig  # noqa: E402

GEOMETRY = dict(tile=256, s=16, direct_max=512)
DTYPES = ["int32", "uint32", "float32", "bfloat16", "int64", "float64"]
# Empty, single-element and > direct_max segments (test_conformance.py).
OFFSETS = [0, 0, 1, 5, 600, 600, 900, 1200]


@pytest.fixture(autouse=True)
def _sound_runs_log_nothing():
    guard.clear_degradation_log()
    yield
    assert guard.degradation_log() == ()


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_matches_reference(dtype, order):
    desc = order == "desc"
    a = make_keys(dtype, OFFSETS[-1], np.random.default_rng(DTYPES.index(dtype)))
    jcfg = JaxConfig(**GEOMETRY, impl="xla", descending=desc)
    cfg = SortConfig(**GEOMETRY, descending=desc)
    want = reference(lambda x: jax_sort.segment_sort(x, OFFSETS, jcfg), a,
                     dtype=dtype)
    wantp = reference(lambda x: jax_sort.segment_argsort(x, OFFSETS, jcfg), a,
                      dtype=dtype)
    got = bucket_sort.segment_sort(to_torch(a), OFFSETS, cfg, device="cpu")
    gotp = bucket_sort.segment_argsort(to_torch(a), OFFSETS, cfg, device="cpu")
    np.testing.assert_array_equal(bits(got), bits(want))
    assert gotp.dtype == torch.int32
    np.testing.assert_array_equal(gotp.numpy(), wantp)
    # No index crosses a segment boundary.
    for lo, hi in zip(OFFSETS, OFFSETS[1:]):
        assert sorted(gotp.numpy()[lo:hi]) == list(range(lo, hi))


@pytest.mark.parametrize("offsets", [
    [0, 1200],
    [0, 300, 300, 300, 1200],
    [0] * 5 + [1200],
    list(range(0, 1201, 100)),
])
def test_offsets_of_every_shape_match_reference(offsets):
    a = make_keys("int32", 1200, np.random.default_rng(len(offsets)))
    a = a % 50  # ties: stability within each segment
    jcfg = JaxConfig(**GEOMETRY, impl="xla")
    cfg = SortConfig(**GEOMETRY)
    wantp = reference(lambda x: jax_sort.segment_argsort(x, offsets, jcfg), a)
    x = torch.from_numpy(a)
    for off in (offsets, np.asarray(offsets), torch.tensor(offsets)):
        np.testing.assert_array_equal(
            bucket_sort.segment_argsort(x, off, cfg, device="cpu").numpy(),
            wantp)
    np.testing.assert_array_equal(
        bucket_sort.segment_sort(x, offsets, cfg, device="cpu").numpy(),
        a[wantp])


def test_segments_of_at_most_one_key():
    x = torch.tensor([5, 3, 9], dtype=torch.int32)
    for off in ([0, 1, 2, 3], [0, 0, 1, 1, 2, 3, 3]):
        assert torch.equal(bucket_sort.segment_sort(x, off, device="cpu"), x)
        assert bucket_sort.segment_argsort(x, off, device="cpu").tolist() == [0, 1, 2]


def test_empty_keys_still_validate_offsets():
    e = torch.zeros(0, dtype=torch.float32)
    assert bucket_sort.segment_sort(e, [0], device="cpu").shape == (0,)
    assert bucket_sort.segment_argsort(e, [0, 0, 0], device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="segment_offsets"):
        bucket_sort.segment_sort(e, [0, 1], device="cpu")
    with pytest.raises(ValueError, match="segment_offsets"):
        bucket_sort.segment_argsort(e, [], device="cpu")


def test_bad_offsets_and_offsets_on_a_device_are_refused():
    x = torch.arange(10, dtype=torch.int32)
    for bad in ([1, 10], [0, 9], [0, 6, 4, 10], [[0, 10]]):
        with pytest.raises(ValueError, match="segment_offsets"):
            bucket_sort.segment_sort(x, bad, device="cpu")
    # Offsets on a device (here the meta device; on the card, CUDA).
    with pytest.raises(ValueError, match="host data"):
        bucket_sort.segment_argsort(x, torch.empty(3, device="meta"),
                                    device="cpu")
    with pytest.raises(ValueError, match="1-D keys"):
        bucket_sort.segment_sort(x.reshape(2, 5), [0, 10], device="cpu")


def test_segment_entries_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bucket_sort.segment_sort, bucket_sort.segment_argsort):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(torch.arange(4), [0, 2, 4])
