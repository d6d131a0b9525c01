"""The port's plain kernel versions and oracles against the JAX package's.

K1's plain version (``bitonic_network_rows``) and the CPU dispatch of
``ops.sort_tiles_sample`` are held bit for bit against the JAX package's
pure-jnp network and its ``kernels/ref`` oracle; K2's plain
``splitter_partition`` against ``kernels/ref.splitter_partition``.  The
CUDA kernels themselves run only on the card: ``tests/test_torch_chip.py``
and ``chip_smoke.py`` hold them against these plain versions there.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import bitonic as jax_bitonic  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.interop import words_from_numpy, words_to_numpy  # noqa: E402
from repro_torch.kernels import _build, bitonic, ops, ref, splitter  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def make_tiles(m, t, nw, rng, *, distinct=8):
    """uint32 words with many ties (word 0 from ``distinct`` values) and
    a per-row payload permutation, as numpy."""
    words = [rng.integers(0, distinct, (m, t)).astype(np.uint32) * np.uint32(0x1F000000)]
    words += [rng.integers(0, 2**32, (m, t), dtype=np.uint64).astype(np.uint32)
              for _ in range(nw - 1)]
    vals = np.argsort(rng.random((m, t)), axis=1).astype(np.int32)
    return tuple(words), vals


def assert_words_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(words_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t", [2, 16, 256])
def test_plain_bitonic_matches_reference_network(t, nw):
    rng = np.random.default_rng(t + nw)
    words, vals = make_tiles(max(1, 4096 // t), t, nw, rng)
    want_w, want_v = jax.jit(jax_bitonic.bitonic_network_rows)(
        tuple(map(jnp.asarray, words)), jnp.asarray(vals))
    got_w, got_v = bitonic.bitonic_network_rows(
        words_from_numpy(words), torch.from_numpy(vals))
    assert_words_equal(got_w, want_w)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,s", [(64, 8), (256, 16), (512, 512)])
def test_cpu_sort_tiles_sample_matches_reference_oracle(t, s, nw):
    rng = np.random.default_rng(7 * t + nw)
    words, vals = make_tiles(6, t, nw, rng)
    want = jax_ref.sort_tiles_sample_kv(
        tuple(map(jnp.asarray, words)), jnp.asarray(vals), num_samples=s)
    got = ops.sort_tiles_sample(words_from_numpy(words), torch.from_numpy(vals),
                                num_samples=s)
    assert_words_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_words_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # The port's own oracle agrees too.
    mine = ref.sort_tiles_sample_kv(words_from_numpy(words), torch.from_numpy(vals),
                                    num_samples=s)
    for a, b in zip(mine[0] + (mine[1],) + mine[2] + (mine[3],),
                    got[0] + (got[1],) + got[2] + (got[3],)):
        assert torch.equal(a, b)


def test_cpu_sort_tiles_one_word_bare_tensor_keeps_structure():
    rng = np.random.default_rng(3)
    (w,), v = make_tiles(4, 128, 1, rng)
    sk, sv = ops.sort_tiles(words_from_numpy(w)[0], torch.from_numpy(v))
    assert isinstance(sk, torch.Tensor)
    want = jax_ref.sort_tiles_kv(jnp.asarray(w), jnp.asarray(v))
    np.testing.assert_array_equal(words_to_numpy(sk)[0], np.asarray(want[0]))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("sorted_tiles", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("t,s", [(64, 3), (256, 15), (1024, 63)])
def test_plain_splitter_partition_matches_reference(t, s, sorted_tiles, nw):
    rng = np.random.default_rng(t + s + nw)
    m = 5
    words, vals = make_tiles(m, t, nw, rng)
    if sorted_tiles:
        out = jax_ref.sort_tiles_kv(tuple(map(jnp.asarray, words)), jnp.asarray(vals))
        words, vals = tuple(np.array(w) for w in out[0]), np.array(out[1])
    # Real-looking splitters: sorted elements of the tiles themselves,
    # plus some values between and beyond them.
    pick = np.sort(rng.integers(0, t, (m, s)), axis=1)
    sp_words = tuple(np.take_along_axis(w, pick, 1) for w in words)
    sp_vals = np.take_along_axis(vals, pick, 1) + rng.integers(-1, 2, (m, s)).astype(
        np.int32)
    want = jax_ref.splitter_partition(
        tuple(map(jnp.asarray, words)), jnp.asarray(vals),
        tuple(map(jnp.asarray, sp_words)), jnp.asarray(sp_vals))
    args = (words_from_numpy(words), torch.from_numpy(vals),
            words_from_numpy(sp_words), torch.from_numpy(sp_vals))
    for got in (splitter.splitter_partition(*args), ops.splitter_partition(*args),
                ref.splitter_partition(*args)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[1].sum(1) == t).all()


def test_plain_splitter_partition_chunks_rows(monkeypatch):
    """The plain version walks the tiles in chunks; chunking is invisible."""
    rng = np.random.default_rng(11)
    words, vals = make_tiles(9, 64, 1, rng)
    sp = tuple(np.sort(w[:, :7], axis=1) for w in words)
    args = (words_from_numpy(words), torch.from_numpy(vals),
            words_from_numpy(sp), torch.from_numpy(vals[:, :7]))
    whole = splitter.splitter_partition(*args)
    monkeypatch.setattr(splitter, "_PLAIN_CHUNK", 64 * 7 * 2)
    chunked = splitter.splitter_partition(*args)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


def test_kernel_wrappers_take_cuda_tensors_only():
    w = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bitonic.sort_tiles_kv(w, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bitonic.sort_tiles_sample_kv((w, w), w, num_samples=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        splitter.splitter_partition_cuda(w, w, w[:, :3], w[:, :3])
    with pytest.raises(ValueError, match="1 or 2 key words"):
        bitonic.sort_tiles_kv((w, w, w), w)


def test_dispatch_refuses_other_devices():
    w = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.sort_tiles(w, w)


def test_cpu_dispatch_launches_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    words, vals = make_tiles(2, 64, 1, rng)
    ops.sort_tiles_sample(words_from_numpy(words), torch.from_numpy(vals),
                          num_samples=4)
    assert ops.launch_counts() == {"tile_sort": 0, "splitter_partition": 0}


def test_build_needs_nvcc_and_keys_libraries_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["tile_sort"])
    a = _build.library_path("tile_sort")
    assert a.parent == tmp_path and a.name.startswith("tile_sort-")
    assert a != _build.library_path("splitter_partition")
    assert _build.word_ptrs([]) == [None, None, None]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
