"""Order-preserving key codecs: any supported dtype -> sortable int32 words.

The sort engine works on tuples of canonical 32-bit key words, most
significant first, compared lexicographically with the int32 payload
as the last word.  The JAX package carries the canonical words as
uint32.  PyTorch covers few uint32 ops (``>``, ``sort``, ``gather`` and
``searchsorted`` raise for it on the CPU), so the port carries each
word **biased**: the int32 ``w ^ 0x80000000``.  Signed order of the
biased word equals unsigned order of the canonical word, and the
canonical pad word ``0xFFFFFFFF`` becomes ``0x7FFFFFFF`` (int32 max).

Transforms, written directly on the biased words (``i`` is the int32
bit pattern of the key, ``SIGN`` = ``0x80000000``):

  ==========  =====  =================================================
  dtype       words  biased word(s)
  ==========  =====  =================================================
  int32       1      ``i`` (the bias cancels the sign flip)
  uint32      1      ``i ^ SIGN``
  float32     1      ``i ^ 0x7FFFFFFF`` if ``i < 0`` else ``i``
  int64       2      ``(hi, lo ^ SIGN)``
  uint64      2      ``(hi ^ SIGN, lo ^ SIGN)`` (through its int64 bits)
  float64     2      negative: ``(hi ^ 0x7FFFFFFF, lo ^ 0x7FFFFFFF)``;
                     else ``(hi, lo ^ SIGN)``
  bool, u8,   1      widen to int32 (values >= 0), then as uint32
  u16
  int8, i16   1      widen to int32
  bf16, f16   1      upcast to float32 (exact), then as float32
  ==========  =====  =================================================

64-bit keys split into words through ``.view(torch.int32)``: index 0
of each pair is the low word (little-endian), as in the JAX codec.
The float transforms give the IEEE total order
``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN``.
``descending=True`` complements every biased word (``~b`` is the bias
of ``~w``), an order-reversing bijection; payloads are not complemented,
so descending sorts stay stable.
"""

from __future__ import annotations

import dataclasses

import torch

_SIGN = -(2**31)  # int32 0x80000000
_LOW31 = 2**31 - 1  # int32 0x7FFFFFFF

ONE_WORD_DTYPES = (
    "uint32", "int32", "float32",
    "bfloat16", "float16",
    "int16", "int8", "uint16", "uint8", "bool",
)
TWO_WORD_DTYPES = ("uint64", "int64", "float64")
SUPPORTED_DTYPES = ONE_WORD_DTYPES + TWO_WORD_DTYPES


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's names)."""
    return str(dtype).removeprefix("torch.")


def _split64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 words of a 64-bit tensor (index 0 is the low word)."""
    w = x.contiguous().view(torch.int32).reshape(*x.shape, 2)
    return w[..., 1], w[..., 0]


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 tensor from its (hi, lo) int32 words."""
    w = torch.stack([lo, hi], dim=-1).contiguous()
    return w.view(torch.int64).reshape(hi.shape)


def _flip_f32(i: torch.Tensor) -> torch.Tensor:
    """Biased word of a float32 bit pattern; its own inverse."""
    return torch.where(i < 0, i ^ _LOW31, i)


@dataclasses.dataclass(frozen=True)
class KeyCodec:
    """Order-preserving bijection between a dtype and biased int32 words.

    Attributes:
        dtype_name: e.g. ``"float64"``.
        num_words: words per key (1 for <= 32-bit, 2 for 64-bit).
        descending: complement every word (descending user order).
    """

    dtype_name: str
    num_words: int
    descending: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Map ``x`` (any shape, ``self.dtype``) to ``num_words`` int32
        tensors of x's shape, most significant first."""
        if x.dtype != self.dtype:
            raise TypeError(f"codec for {self.dtype_name} got {x.dtype}")
        name = self.dtype_name
        if name in ("bfloat16", "float16"):
            x, name = x.float(), "float32"
        elif name in ("int8", "int16"):
            x, name = x.to(torch.int32), "int32"
        elif name in ("uint8", "uint16", "bool"):
            x, name = x.to(torch.int32), "uint32"  # values >= 0
        if name == "int32":
            words = (x.clone(),)
        elif name == "uint32":
            words = (x.view(torch.int32) ^ _SIGN,)
        elif name == "float32":
            words = (_flip_f32(x.view(torch.int32)),)
        elif name == "int64":
            hi, lo = _split64(x)
            words = (hi.clone(), lo ^ _SIGN)
        elif name == "uint64":
            hi, lo = _split64(x.view(torch.int64))
            words = (hi ^ _SIGN, lo ^ _SIGN)
        elif name == "float64":
            hi, lo = _split64(x.view(torch.int64))
            neg = hi < 0
            words = (
                torch.where(neg, hi ^ _LOW31, hi),
                torch.where(neg, lo ^ _LOW31, lo ^ _SIGN),
            )
        if self.descending:
            words = tuple(~w for w in words)
        return tuple(w.contiguous() for w in words)

    def decode(self, words: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Exact inverse of :meth:`encode`."""
        if len(words) != self.num_words:
            raise ValueError(
                f"{self.dtype_name} decodes from {self.num_words} words, "
                f"got {len(words)}"
            )
        if self.descending:
            words = tuple(~w for w in words)
        name = self.dtype_name
        if name == "bfloat16":
            # The top half of the float32 bits, exact for every pattern:
            # torch's float32 -> bfloat16 cast rewrites NaN payloads.
            hi16 = _flip_f32(words[0]) >> 16
            return hi16.to(torch.int16).view(torch.bfloat16)
        if name in ("float16", "float32"):
            return _flip_f32(words[0]).view(torch.float32).to(self.dtype)
        if name in ("int8", "int16", "int32"):
            return words[0].to(self.dtype)
        if name == "uint32":
            return (words[0] ^ _SIGN).view(torch.uint32)
        if name in ("uint8", "uint16"):
            return (words[0] ^ _SIGN).to(self.dtype)
        if name == "bool":
            return words[0] != _SIGN
        hi, lo = words
        if name == "int64":
            return _join64(hi, lo ^ _SIGN)
        if name == "uint64":
            return _join64(hi ^ _SIGN, lo ^ _SIGN).view(torch.uint64)
        neg = hi < 0  # float64: biased msw < 0 <=> original sign bit set
        return _join64(
            torch.where(neg, hi ^ _LOW31, hi),
            torch.where(neg, lo ^ _LOW31, lo ^ _SIGN),
        ).view(torch.float64)


def codec_for(dtype, descending: bool = False) -> KeyCodec:
    """The :class:`KeyCodec` of a torch dtype (or its name).

    Raises:
        TypeError: for dtypes without a codec.
    """
    name = dtype if isinstance(dtype, str) else dtype_name(dtype)
    if name in ONE_WORD_DTYPES:
        return KeyCodec(name, 1, descending)
    if name in TWO_WORD_DTYPES:
        return KeyCodec(name, 2, descending)
    raise TypeError(
        f"unsupported sort key dtype {name}; supported: {SUPPORTED_DTYPES}"
    )
