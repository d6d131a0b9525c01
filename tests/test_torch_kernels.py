"""The port's plain kernel versions and oracles against the JAX package's.

K1's plain version (``bitonic_network_rows``) and the CPU dispatch of
``ops.sort_tiles_sample`` are held bit for bit against the JAX package's
pure-jnp network and its ``kernels/ref`` oracle; K2's plain
``splitter_partition`` against ``kernels/ref.splitter_partition``; K3's
plain ``splitter_ranks`` against ``kernels/ref.splitter_ranks`` and the
reference's ``_lt_matrix`` sum, on sorted and unsorted tiles; K4's plain
``topk_desc`` against the reference's Pallas ``topk_desc`` in interpret
mode (it sets no TPU compiler parameters, so it runs on this JAX) and
its ``ref.topk_desc``; ``ops.topk`` against the reference's
``ops.topk(impl="xla")``.  The CUDA kernels themselves run only on the
card: ``tests/test_torch_chip.py`` and ``chip_smoke.py`` hold them
against these plain versions there.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import ast  # noqa: E402
import contextlib  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_codec import bits, make_keys, to_torch  # noqa: E402

from repro.kernels import bitonic as jax_bitonic  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import splitter as jax_splitter  # noqa: E402
from repro.kernels import topk as jax_topk  # noqa: E402
from repro_torch.interop import words_from_numpy, words_to_numpy  # noqa: E402
from repro_torch.kernels import _build, bitonic, merge, ops, radix, ref, splitter, topk  # noqa: E402

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


def x64(nw: int):
    return jax.enable_x64(True) if nw == 2 else contextlib.nullcontext()


def real_and_stray_splitters(words, vals, s, rng, *, sort_splitters):
    """(m, s) splitters per tile: elements of the tile itself (ties with
    tile elements), some with their payload moved by one, and values
    outside the tile's range; sorted along each row or not."""
    m, t = vals.shape
    pick = rng.integers(0, t, (m, s))
    if sort_splitters:
        pick = np.sort(pick, axis=1)
    sp_words = tuple(np.take_along_axis(w, pick, 1) for w in words)
    sp_vals = np.take_along_axis(vals, pick, 1) + rng.integers(-1, 2, (m, s)).astype(
        np.int32)
    sp_words[0][:, 0] = np.uint32(0)
    sp_words[0][:, -1] = np.uint32(0xFFFFFFFF)
    return sp_words, sp_vals


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("t,s", [(64, 3), (256, 15), (4096, 63)])
def test_plain_splitter_ranks_matches_reference(t, s, order, nw):
    """K3 counts, so it holds on unsorted tiles and unsorted splitters."""
    rng = np.random.default_rng(3 * t + s + nw)
    m = 3
    words, vals = make_tiles(m, t, nw, rng, distinct=4)
    if order == "sorted":
        out = jax_ref.sort_tiles_kv(tuple(map(jnp.asarray, words)), jnp.asarray(vals))
        words, vals = tuple(np.array(w) for w in out[0]), np.array(out[1])
    sp_words, sp_vals = real_and_stray_splitters(
        words, vals, s, rng, sort_splitters=order == "sorted")
    jargs = (tuple(map(jnp.asarray, words)), jnp.asarray(vals),
             tuple(map(jnp.asarray, sp_words)), jnp.asarray(sp_vals))
    with x64(nw):
        want = np.asarray(jax_ref.splitter_ranks(*jargs))
        lt = np.asarray(jax_splitter._lt_matrix(*jargs).sum(axis=1, dtype=jnp.int32))
    np.testing.assert_array_equal(lt, want)
    args = (words_from_numpy(words), torch.from_numpy(vals),
            words_from_numpy(sp_words), torch.from_numpy(sp_vals))
    for got in (splitter.splitter_ranks(*args), ops.splitter_ranks(*args),
                ref.splitter_ranks(*args)):
        assert got.dtype == torch.int32 and got.shape == (m, s)
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(splitter.splitter_partition(*args)[0],
                       splitter.splitter_ranks(*args))


def test_plain_splitter_ranks_chunks_rows(monkeypatch):
    rng = np.random.default_rng(12)
    words, vals = make_tiles(9, 64, 2, rng)
    sp_words, sp_vals = real_and_stray_splitters(words, vals, 5, rng,
                                                 sort_splitters=False)
    args = (words_from_numpy(words), torch.from_numpy(vals),
            words_from_numpy(sp_words), torch.from_numpy(sp_vals))
    whole = splitter.splitter_ranks(*args)
    monkeypatch.setattr(splitter, "_PLAIN_CHUNK", 64 * 5 * 2)
    assert torch.equal(splitter.splitter_ranks(*args), whole)
    empty = splitter.splitter_ranks(*(a[:0] if isinstance(a, torch.Tensor)
                                      else tuple(w[:0] for w in a) for a in args))
    assert empty.shape == (0, 5) and empty.dtype == torch.int32


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 6, 8])
@pytest.mark.parametrize("c", [16, 64, 128])
def test_plain_topk_desc_matches_reference(c, k, nw):
    """Heavy ties (word 0 from four values): the column breaks them."""
    rng = np.random.default_rng(c + 10 * k + nw)
    words, _ = make_tiles(8, c, nw, rng, distinct=4)
    jwords = tuple(map(jnp.asarray, words))
    with x64(nw):
        want = jax_topk.topk_desc(jwords, k=k, block_rows=8, interpret=True)
        want_ref = jax_ref.topk_desc(jwords, k=k)
        want = (tuple(np.asarray(w) for w in want[0]), np.asarray(want[1]))
    for a, b in zip(want[0] + (want[1],), want_ref[0] + (want_ref[1],)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for fn in (topk.topk_desc, ref.topk_desc):
        got_w, got_i = fn(words_from_numpy(words), k)
        assert_words_equal(got_w, want[0])
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), want[1])
    if nw == 1:  # a bare tensor keeps its structure
        got_w, got_i = topk.topk_desc(words_from_numpy(words)[0], k)
        assert isinstance(got_w, torch.Tensor)
        np.testing.assert_array_equal(words_to_numpy(got_w)[0], want[0][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int64"])
@pytest.mark.parametrize("shape,k", [((6, 100), 7), ((5, 16), 16), ((3, 1), 1)])
def test_ops_topk_matches_reference(dtype, shape, k):
    rng = np.random.default_rng(sum(shape) + k)
    a = make_keys(dtype, shape[0] * shape[1], rng).reshape(shape)
    if dtype == "int32":
        a = (a % 5).astype(np.int32)  # ties
    with x64(2 if dtype == "int64" else 1):
        want = jax_ops.topk(jnp.asarray(a), k, impl="xla")
        want = tuple(np.asarray(w) for w in want)
    got = ops.topk(to_torch(a), k, device="cpu")
    assert got[0].dtype == to_torch(a).dtype and got[1].dtype == torch.int32
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_ops_topk_refuses_what_it_does_not_take(monkeypatch):
    x = torch.zeros((2, 100))
    for k in (0, 101):
        with pytest.raises(ValueError, match="1 <= k"):
            ops.topk(x, k, device="cpu")
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        ops.topk(torch.zeros(100), 2, device="cpu")
    assert ops.topk(torch.zeros((1, 16384)), 2, device="cpu")[1].tolist() == [[0, 1]]
    # An entry point: None means "cuda", for a CPU tensor or an array too.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scores in (x, x.numpy()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ops.topk(scores, 2)
    assert ops.topk(x.numpy()[:, :8], 2, device="cpu")[1].tolist() == [[0, 1]] * 2


def test_topk_rows_per_cta():
    assert topk.rows_per_cta(65536, 128) == 16
    assert topk.rows_per_cta(65536, 64) == 32
    assert topk.rows_per_cta(3, 16) == 4
    assert topk.rows_per_cta(1, 16) == 1
    assert topk.rows_per_cta(100, 16384) == 1


@pytest.mark.parametrize("m,t", [
    (1, 1 << 22), (9728, 4096), (16384, 4096), (1, 4096), (3, 8192),
    (100, 1 << 16), (527, 1 << 20), (528, 1 << 20), (1024, 256), (5, 64),
    (7, 2), (1, 1), (2, 100), (1, (1 << 22) + 12),
])
def test_ranks_geometry_covers_every_element_once(m, t):
    """K3's launch: a tile is split only when its tiles are too few CTAs
    for the card; parts and threads cover each element exactly once, at
    the alignment the kernel's int4 loads need."""
    split, part_len, threads = splitter.ranks_geometry(m, t)
    assert split >= 1 and (split == 1 or m < splitter._FILL_CTAS)
    assert m * split < 2**31
    assert part_len % 16 == 0
    assert 32 <= threads <= 256 and threads & (threads - 1) == 0
    # The kernel's ranges: part p, slab k, thread x ->
    # [p * part_len + k * threads * 16 + 16 x, + 16) within the part.
    parts = np.arange(split)
    part_end = np.minimum(t, (parts + 1) * part_len)
    assert (parts * part_len < t).all(), "every part holds an element"
    slabs = -(-part_len // (threads * 16))
    start = (parts[:, None, None] * part_len
             + np.arange(slabs)[None, :, None] * threads * 16
             + np.arange(threads)[None, None, :] * 16)
    end = np.minimum(part_end[:, None, None], start + 16)
    assert np.maximum(end - start, 0).sum() == t
    nonempty = (end > start).ravel()
    bounds = np.stack([start.ravel()[nonempty], end.ravel()[nonempty]], 1)
    bounds = bounds[np.argsort(bounds[:, 0])]
    assert bounds[0, 0] == 0 and bounds[-1, 1] == t
    assert (bounds[1:, 0] == bounds[:-1, 1]).all(), "no gap, no overlap"
    if m >= splitter._FILL_CTAS or t < 2 * 256 * 16:
        assert split == 1


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("m,t,s", [
    (16384, 4096, 63), (9728, 4096, 63), (3, 2, 1), (1000, 32, 7),
    (5, 64, 3), (4096, 16384, 63), (1, 16384, 1100), (2, 100, 33),
    (1, 64, 12288), (8, 8, 5),
])
def test_partition_geometry_fits_shared_memory(m, t, s, nw):
    """K2's launch: tiles per CTA, warps per tile, window and coarse
    index within the CTA's 256 threads and 227 KB of shared memory."""
    tiles, warps, window, groups, smem = splitter.partition_geometry(m, t, s, nw)
    assert 1 <= tiles <= min(4, m) and 1 <= warps <= 8
    assert warps * 8 >= min(s, 64) and 32 * warps * tiles <= 256
    assert window == min(32, t)
    assert (groups - 1) * window < t <= groups * window, "windows cover the tile"
    assert smem == tiles * ((8 + 4 * (nw == 2)) * groups + 4 * s)
    assert smem <= 232_448
    assert splitter.partition_block_rows(m) >= tiles


def test_partition_geometry_refuses_more_than_shared_memory_holds():
    splitter.partition_geometry(1, 16384, 56_000, 2)
    with pytest.raises(ValueError, match="shared memory"):
        splitter.partition_geometry(1, 16384, 58_000, 1)
    with pytest.raises(ValueError, match="shared memory"):
        splitter.partition_geometry(1, 1 << 23, 1, 1)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("m", [1, 77, 1 << 17], ids=["one", "odd", "large"])
@pytest.mark.parametrize("t", [1 << k for k in range(1, 15)])
def test_row_sort_geometry_fits_the_cta(t, m, nw):
    """K1's and K6's launch: threads of ``items`` registers hold the CTA's
    rows exactly, within 1024 threads and 227 KB of shared memory; K1
    exchanges through shared memory only rows wider than a warp holds."""
    g = bitonic.row_sort_geometry(m, t, nw)
    assert g.rows == bitonic.effective_block_rows(m, t) and m % g.rows == 0
    assert g.threads * g.items == g.rows * t <= bitonic.MAX_TILE
    assert g.items in (2, 4, 8, 16, 32) and g.threads & (g.threads - 1) == 0
    assert 1 <= g.threads <= 1024
    assert g.items == min(16, g.rows * t) or (t == bitonic.MAX_TILE and g.items == 32)
    key = 8 if nw == 1 else 12
    assert g.shared_bytes == (g.rows * t * key if t > 32 * g.items else 0)
    assert g.merge_shared_bytes == (g.rows * t + g.threads) * key
    assert max(g.shared_bytes, g.merge_shared_bytes) <= 232_448
    assert bitonic._k1_geometry(m, t, nw) == (g.threads, g.items, g.shared_bytes)
    assert merge._k6_geometry(m, t, nw) == (g.threads, g.items,
                                            g.merge_shared_bytes)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("m", [1, 77, 1 << 17], ids=["one", "odd", "large"])
@pytest.mark.parametrize("t", [1 << k for k in range(1, 15)])
def test_radix_geometry_fits_the_cta(t, m, nw):
    """K5's launch: K1's threads and items hold the CTA's rows exactly;
    the digit width divides a key word, so the passes are whole; the
    exchange, counters and sums fit 227 KB of shared memory; rows share
    a CTA only at the instances the kernel has (at most 16 items)."""
    g = radix.radix_geometry(m, t, nw)
    assert g.rows == bitonic.effective_block_rows(m, t) and m % g.rows == 0
    assert g.threads * g.items == g.rows * t
    assert (g.threads, g.items) == bitonic.register_launch(g.rows * t, t, nw)[:2]
    assert g.items in (2, 4, 8, 16, 32) and g.threads & (g.threads - 1) == 0
    assert 1 <= g.threads <= 512
    assert 32 % g.digit_bits == 0
    key_passes = nw * 32 // g.digit_bits
    assert key_passes * g.digit_bits == nw * 32
    row_bits = (g.rows - 1).bit_length()
    row_passes = -(-row_bits // g.digit_bits)
    assert row_passes * g.digit_bits >= row_bits and row_passes <= 2
    if g.rows > 1:
        assert g.rows * t <= 2048 and g.items <= 16
    warps = -(-g.threads // 32)
    entry = 8 + 4 * (nw == 2) + 4 * (g.rows > 1)
    assert g.shared_bytes == (max(g.rows * t, 32) * entry
                              + 4 * warps * (2**g.digit_bits + 1))
    assert g.shared_bytes <= 232_448
    assert radix._k5_geometry(m, t, nw) == (g.threads, g.items, g.digit_bits,
                                            g.shared_bytes)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("r", [1, 3, 65537], ids=["one", "three", "router"])
@pytest.mark.parametrize("c", [1 << k for k in range(15)])
def test_topk_geometry_fits_the_cta(c, r, nw):
    """K4's launch: K1's register layout over ``rows_per_cta`` rows;
    threads of ``items`` registers hold the CTA's rows exactly, the CTAs
    cover every row (the last one's extra rows masked), and only rows
    wider than one warp's registers take a shared exchange."""
    g = topk.topk_geometry(r, c, nw)
    assert g.rows == topk.rows_per_cta(r, c)
    assert g.threads * g.items == g.rows * c <= max(2048, c)
    assert g.items in (1, 2, 4, 8, 16, 32) and g.threads & (g.threads - 1) == 0
    assert 1 <= g.threads <= 512
    ctas = -(-r // g.rows)
    assert (ctas - 1) * g.rows < r <= ctas * g.rows
    assert g.rows == 1 or g.rows // 2 < r, "no CTA is all masked rows"
    key = 8 if nw == 1 else 12
    assert g.shared_bytes == (g.rows * c * key if c > 32 * g.items else 0)
    assert g.shared_bytes <= 232_448


def test_kernel_wrappers_take_cuda_tensors_only():
    w = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bitonic.sort_tiles_kv(w, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bitonic.sort_tiles_sample_kv((w, w), w, num_samples=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        splitter.splitter_partition_cuda(w, w, w[:, :3], w[:, :3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        splitter.splitter_ranks_cuda(w, w, w[:, :3], w[:, :3])
    with pytest.raises(ValueError, match="1 or 2 key words"):
        splitter.splitter_ranks_cuda((w, w, w), w, (w, w, w), w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk.topk_desc_cuda(w, 2)
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
    ops.splitter_ranks(words_from_numpy(words), torch.from_numpy(vals),
                       words_from_numpy(words)[0][:, :3].contiguous(),
                       torch.from_numpy(vals[:, :3].copy()))
    ops.topk(torch.zeros((3, 5)), 2, device="cpu")
    assert ops.launch_counts() == {"tile_sort": 0, "splitter_partition": 0,
                                   "splitter_ranks": 0, "topk": 0,
                                   "radix_sort": 0, "merge_sort": 0}


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
    assert set(_build.SOURCES) == {"tile_sort", "splitter_partition",
                                   "splitter_ranks", "topk", "radix_sort",
                                   "merge_sort"}
    assert all((_build._CSRC / f"{n}.cu").exists() for n in _build.SOURCES)


def test_library_key_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit of the network header rebuilds K1 and K4."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(csrc / "bitonic_network.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before["tile_sort"] != after["tile_sort"]
    assert before["topk"] != after["topk"]
    for name in ("tile_sort", "topk"):  # the network loop is in the header only
        text = (csrc / f"{name}.cu").read_text()
        assert '#include "bitonic_network.cuh"' in text and "d >>= 1" not in text


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "scripts").glob("*.py"))
    assert len(files) >= 17
    assert ROOT / "src" / "repro_torch" / "core" / "partial_sort.py" in files
    assert ROOT / "src" / "repro_torch" / "kernels" / "topk.py" in files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
