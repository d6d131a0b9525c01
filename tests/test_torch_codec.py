"""The port's key codec against the JAX package's, bit for bit.

Inputs are made from a seed with numpy and go through
``repro.core.key_codec`` (uint32 words) and ``repro_torch.core.key_codec``
(biased int32 words); the words are compared through numpy after
un-biasing, and both decodes must give back the input's exact bits.
64-bit dtypes run the JAX side under ``jax.enable_x64(True)``.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import contextlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import key_codec as jax_codec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import key_codec  # noqa: E402

SPECIALS = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, -1e-40, 1.5, 1.5, -1.5]


def x64(dtype: str):
    if dtype in key_codec.TWO_WORD_DTYPES:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def make_keys(dtype: str, n: int, rng) -> np.ndarray:
    """Full-range ints, or normal floats spiked with NaN/+-inf/-0.0."""
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(bool)
    if dtype in ("float16", "bfloat16", "float32", "float64"):
        a = rng.standard_normal(n) * 1e3
        a[rng.integers(0, n, len(SPECIALS))] = SPECIALS
        return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def bits(x) -> np.ndarray:
    """The raw bytes of a tensor or array, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("dtype", key_codec.SUPPORTED_DTYPES)
def test_codec_matches_reference_and_round_trips(dtype, order):
    rng = np.random.default_rng(0)
    a = make_keys(dtype, 3000, rng)
    desc = order == "desc"
    with x64(dtype):
        ref_words = jax_codec.codec_for(dtype, desc).encode(jnp.asarray(a))
        ref_words = tuple(np.asarray(w) for w in ref_words)
        ref_back = np.asarray(
            jax_codec.codec_for(dtype, desc).decode(tuple(map(jnp.asarray, ref_words)))
        )
    codec = key_codec.codec_for(dtype, desc)
    words = codec.encode(to_torch(a))
    assert codec.num_words == len(ref_words)
    assert all(w.dtype == torch.int32 for w in words)
    for got, want in zip(interop.words_to_numpy(words), ref_words):
        np.testing.assert_array_equal(got, want)
    back = codec.decode(interop.words_from_numpy(ref_words))
    assert back.dtype == to_torch(a).dtype
    np.testing.assert_array_equal(bits(back), bits(a))
    np.testing.assert_array_equal(bits(ref_back), bits(a))


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "float64"])
def test_biased_words_order_like_the_keys(dtype):
    """Signed order of the biased words is the dtype's total order."""
    rng = np.random.default_rng(1)
    a = make_keys(dtype, 2000, rng)
    a = a[~np.isnan(a)] if a.dtype.kind == "f" else a
    words = key_codec.codec_for(dtype).encode(torch.from_numpy(a))
    order = np.lexsort(tuple(w.numpy() for w in reversed(words)))
    s = a[order]
    assert (s[1:] >= s[:-1]).all()


def test_codec_rejects_unsupported_dtype_and_mismatch():
    with pytest.raises(TypeError, match="unsupported sort key dtype"):
        key_codec.codec_for(torch.complex64)
    with pytest.raises(TypeError, match="int32"):
        key_codec.codec_for("int32").encode(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="2 words"):
        key_codec.codec_for("int64").decode((torch.zeros(3, dtype=torch.int32),))
