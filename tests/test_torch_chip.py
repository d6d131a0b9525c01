"""Card-only tests of the CUDA kernels and the main path on them.

Marked ``gpu``; each takes the ``cuda`` fixture, which skips when no
card is present (decided when the test runs, never at import).  On a
machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_chip.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.Generator(device="cuda").manual_seed(0)


def tiles(gen, m, t, nw):
    words = tuple(
        torch.randint(-8, 8, (m, t), generator=gen, device="cuda",
                      dtype=torch.int32) for _ in range(nw)
    )
    vals = torch.argsort(torch.rand((m, t), generator=gen, device="cuda"),
                         dim=1).to(torch.int32)
    return words, vals


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,s", [(2, 0), (64, 8), (4096, 64), (8192, 64), (16384, 0)])
def test_tile_sort_kernel_equals_plain_version(cuda, t, s, nw):
    from repro_torch.kernels import bitonic

    words, vals = tiles(cuda, max(1, (1 << 20) // t), t, nw)
    before = bitonic.LAUNCHES.count
    if s:
        got = bitonic.sort_tiles_sample_kv(words, vals, num_samples=s)
    else:
        got = bitonic.sort_tiles_kv(words, vals)
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES.count == before + 1
    pw, pv = bitonic.bitonic_network_rows(words, vals)
    assert len(got[0]) == nw
    assert all(torch.equal(a, b) for a, b in zip(got[0], pw))
    assert torch.equal(got[1], pv)
    if s:
        assert torch.equal(got[3], bitonic.take_samples(pv, s))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,num_splitters", [(4096, 63), (4096, 7), (64, 3)])
def test_splitter_partition_kernel_equals_plain_version(cuda, t, num_splitters, nw):
    from repro_torch.kernels import bitonic, ref, splitter

    m = max(1, (1 << 20) // t)
    sk, sv = bitonic.sort_tiles_kv(*tiles(cuda, m, t, nw))
    pick = torch.sort(torch.randint(0, t, (m, num_splitters), generator=cuda,
                                    device="cuda"), dim=1).values
    sp = tuple(torch.gather(w, 1, pick) for w in sk)
    spv = torch.gather(sv, 1, pick)
    got = splitter.splitter_partition_cuda(sk, sv, sp, spv)
    torch.cuda.synchronize()
    want = splitter.splitter_partition(sk, sv, sp, spv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ref.splitter_partition(sk, sv, sp, spv)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_main_path_equals_stable_torch_sort(cuda, dtype):
    from repro_torch.core import bucket_sort
    from repro_torch.kernels import ops

    x = torch.randint(-1000, 1000, (300_000,), generator=cuda, device="cuda").to(dtype)
    ops.reset_launch_counts()
    perm = bucket_sort.argsort(x)
    torch.cuda.synchronize()
    assert all(c > 0 for c in ops.launch_counts().values())
    assert torch.equal(perm.long(), torch.sort(x, stable=True).indices)
    assert torch.equal(bucket_sort.sort(x), torch.sort(x, stable=True).values)


def test_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import ops

    words, vals = tiles(cuda, 1, 32768, 1)
    with pytest.raises(ValueError, match="power of two"):
        ops.sort_tiles(words, vals)
    words, vals = tiles(cuda, 64, 64, 1)
    with pytest.raises(ValueError, match="contiguous int32"):
        ops.sort_tiles(words[0].t().contiguous().t(), vals)
    with pytest.raises(ValueError, match="contiguous int32"):
        ops.sort_tiles(words[0].long(), vals)
