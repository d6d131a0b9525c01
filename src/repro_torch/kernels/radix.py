"""K5: stable LSD radix sort of (m, T) rows on the key words alone.

The "radix" local-sort strategy.  :func:`radix_sort_rows` (with
:func:`digit_rank` and :func:`_hillis`) is the plain PyTorch version,
the JAX package's ``kernels/radix.py`` body line for line; the CUDA
kernel (``csrc/radix_sort.cu``) sorts the same rows on the card in
registers, ranking 8-bit digits a warp at a time, with the launch
geometry of :func:`radix_geometry`.  :func:`sort_tiles_kv` and
:func:`sort_tiles_sample_kv` are the kernel's wrappers: they take CUDA
tensors only, launch the kernel and count the launch.
:func:`composite_sort_rows` / :func:`composite_sort_sample_rows` are the
JAX package's xla stand-ins for this strategy, ported for parity; no
path of the port runs them.

Strategy contract (as in the JAX package): a STABLE sort keyed on the
key words only; the int32 payload rides along.  Inside the pipeline that
equals the bitonic order on (*words, payload), because equal keys always
arrive in increasing-payload order.  A stable sort has one result
whatever its digit width: in the plain version a word is ``32 /
radix_bits`` digit passes, least significant word first, while the
kernel takes its own width (``DIGIT_BITS``), so on the card
``radix_bits`` is checked but sets no passes.

Keys are one or two biased int32 word tensors (``core/key_codec``), most
significant first, or a bare tensor for one word.  A digit comes from
the canonical word ``w ^ 0x80000000``: int32 ``>>`` is arithmetic, so
the digit is masked after the shift (exact while shift + width <= 32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import (
    as_words,
    effective_block_rows,
    launch_row_sort,
    like_words,
    register_launch,
    take_samples,
)

# Elements per scan segment: one packed counter holds 8 x 4-bit digit
# counts, and a segment of 8 elements can never overflow a field.
_SEG = 8
_BIAS = -(2**31)  # int32 0x80000000: biased word ^ _BIAS = canonical word

# K5's digit width on the card: four passes a key word, each ranking a
# warp's items against 256 shared counters a warp (csrc/radix_sort.cu).
DIGIT_BITS = 8

LAUNCHES = _build.LaunchCounter("radix_sort")


class RadixGeometry(NamedTuple):
    """K5's launch: ``threads`` of ``items`` elements each sort ``rows``
    rows a CTA in passes of ``digit_bits``-wide digits, with
    ``shared_bytes`` of dynamic shared memory."""

    threads: int
    items: int
    rows: int
    digit_bits: int
    shared_bytes: int


def radix_geometry(m: int, t: int, nw: int) -> RadixGeometry:
    """K5's launch for m rows of T (a power of two in [2, MAX_TILE]) and
    nw key words: K1's threads and items a thread
    (``bitonic.register_launch``) over ``effective_block_rows`` rows.

    Shared memory holds one exchange of the CTA's elements, at least 32
    slots (its swizzle stays inside an aligned block of 32): an 8-byte
    key, plus the 4-byte payload with two words and the 4-byte row index
    when rows share the CTA; and for each warp 2^digit_bits counters and
    one sum.  At T = MAX_TILE with two words that is 208 KB of the 227 KB
    a block may take.
    """
    rows = effective_block_rows(m, t)
    e = rows * t
    threads, items, _ = register_launch(e, t, nw)
    warps = -(-threads // 32)
    entry = 8 + 4 * (nw == 2) + 4 * (rows > 1)
    shared = max(e, 32) * entry + 4 * warps * ((1 << DIGIT_BITS) + 1)
    return RadixGeometry(threads, items, rows, DIGIT_BITS, shared)


def _k5_geometry(m: int, t: int, nw: int) -> tuple[int, int, int, int]:
    """K5's launch arguments after ``num_samples``: threads, items, digit
    bits, shared bytes."""
    g = radix_geometry(m, t, nw)
    return g.threads, g.items, g.digit_bits, g.shared_bytes


def _digits(w: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """Bits [shift, shift + bits) of the canonical words of biased ``w``."""
    return ((w ^ _BIAS) >> shift) & ((1 << bits) - 1)


def _hillis(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """Inclusive Hillis-Steele prefix sum along a length-n axis."""
    k = 1
    while k < n:
        pad = torch.zeros_like(x.narrow(dim, 0, k))
        shifted = torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - k)], dim=dim)
        x = x + shifted
        k *= 2
    return x


def digit_rank(d: torch.Tensor, num_digits: int) -> torch.Tensor:
    """Source permutation of one stable counting pass.

    Args:
        d: (rows, T) int32 digits in [0, num_digits); T a power of two.
        num_digits: D, 2 <= D <= 16.
    Returns:
        (rows, T) int32 ``src``: gathering x at src sorts x stably by digit.

    The packed per-segment counters are uint32 with 4-bit fields up to
    bit 31 in the JAX package; here they are int64, so that field 7 is
    not a sign bit under ``>>``.
    """
    rows, t = d.shape
    if t & (t - 1):
        raise ValueError(f"row width {t} must be a power of two")
    if not 2 <= num_digits <= 16:
        raise ValueError(f"num_digits must be in [2, 16], got {num_digits}")
    dev = d.device
    if t == 1:
        return torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    c = min(_SEG, t)
    s = t // c
    n_arr = (num_digits + _SEG - 1) // _SEG  # packed counter words
    d = d.long()

    # 1. packed per-segment counters + intra-segment inclusive scan.
    enc = torch.ones_like(d) << ((d & (_SEG - 1)) << 2)
    arr_id = d >> 3
    pres = [
        _hillis(torch.where(arr_id == a, enc, 0).reshape(rows, s, c), c)
        for a in range(n_arr)
    ]  # (rows, S, C) each
    sh4 = (torch.arange(_SEG, device=dev) << 2)[None, None, :]

    # 2. unpack segment totals -> (rows, S, D) counts, scan across segments.
    cnt = torch.cat([(p[:, :, -1:] >> sh4) & 15 for p in pres],
                    dim=2)[:, :, :num_digits]
    inc_seg = _hillis(cnt, s, dim=1)  # (rows, S, D) inclusive over segments
    tot = inc_seg[:, -1, :]  # (rows, D)
    start = torch.cumsum(tot, dim=1) - tot  # (rows, D) exclusive digit starts

    # 3a. digit of each destination slot: last k with start[k] <= p.
    p = torch.arange(t, device=dev).expand(rows, t)
    j = torch.full((rows, t), -1, dtype=torch.long, device=dev)
    for k in range(num_digits):
        j = j + (start[:, k:k + 1] <= p).long()
    q = p - torch.gather(start, 1, j)

    # 3b. source segment: first seg with inclusive count > q, in
    # S.bit_length() halvings of [0, S].
    flat = inc_seg.reshape(rows, s * num_digits)
    lo = torch.zeros((rows, t), dtype=torch.long, device=dev)
    hi = torch.full((rows, t), s, dtype=torch.long, device=dev)
    for _ in range(s.bit_length()):
        mid = (lo + hi) >> 1
        cmid = torch.gather(flat, 1, mid * num_digits + j)
        gt = cmid > q
        hi = torch.where(gt, mid, hi)
        lo = torch.where(gt, lo, mid + 1)
    seg = lo
    excl = torch.where(
        seg > 0,
        torch.gather(flat, 1, torch.clamp(seg - 1, min=0) * num_digits + j),
        0,
    )
    qs = q - excl  # rank within the source segment

    # 3c. source element within the segment: first c with packed
    # intra-segment prefix field > qs.
    if c == 1:
        return seg.to(torch.int32)
    pcat = torch.cat([pr.reshape(rows, t) for pr in pres], dim=1)
    fldj = (j & (_SEG - 1)) << 2
    base = (j >> 3) * t + seg * c
    lo2 = torch.zeros((rows, t), dtype=torch.long, device=dev)
    hi2 = torch.full((rows, t), c - 1, dtype=torch.long, device=dev)
    for _ in range((c - 1).bit_length()):
        mid = (lo2 + hi2) >> 1
        pv = torch.gather(pcat, 1, base + mid)
        cmid = (pv >> fldj) & 15
        gt = cmid > qs
        upd = lo2 < hi2
        hi2 = torch.where(upd & gt, mid, hi2)
        lo2 = torch.where(upd & ~gt, mid + 1, lo2)
    return (seg * c + lo2).to(torch.int32)


def radix_sort_rows(keys, vals: torch.Tensor, *, radix_bits: int = 4):
    """Plain version of K5: stable LSD radix sort of each row of (rows, T)
    by the key words, ``32 / radix_bits`` digit passes per word, least
    significant word first; each pass a :func:`digit_rank` and one gather
    per tensor.

    Args:
        keys: (rows, T) biased int32 word tensor or tuple (msw first).
        vals: (rows, T) int32 payloads, carried and not compared.
        radix_bits: digit width in {1, 2, 4}.
    Returns:
        (sorted keys in the input structure, payloads moved alongside).
    """
    if radix_bits not in (1, 2, 4):
        raise ValueError(f"radix_bits must be 1, 2 or 4, got {radix_bits}")
    words = as_words(keys)
    t = words[0].shape[1]
    if t == 1:
        return like_words(words, keys), vals
    num_digits = 1 << radix_bits
    parts = list(words) + [vals]
    for wi in reversed(range(len(words))):  # least significant word first
        for sh in range(0, 32, radix_bits):
            d = _digits(parts[wi], sh, radix_bits)
            src = digit_rank(d, max(num_digits, 2)).long()
            parts = [torch.gather(x, 1, src) for x in parts]
    return like_words(tuple(parts[:-1]), keys), parts[-1]


def sort_tiles_kv(keys, vals: torch.Tensor, *, radix_bits: int = 4):
    """Launch K5 on CUDA tensors: stable radix sort of each row of (m, T)
    by the key words (payloads increasing within equal keys give the
    bitonic order).

    Returns:
        (sorted keys in the input structure, sorted vals), new tensors.
    Raises:
        ValueError: for tensors or a radix_bits the kernel does not take.
        RuntimeError: when the launch fails.
    """
    if radix_bits not in (1, 2, 4):
        raise ValueError(f"radix_bits must be 1, 2 or 4, got {radix_bits}")
    out, _ = launch_row_sort("radix_sort", LAUNCHES, as_words(keys), vals, 0,
                             geometry=_k5_geometry)
    return like_words(out[:-1], keys), out[-1]


def sort_tiles_sample_kv(keys, vals: torch.Tensor, *, num_samples: int,
                         radix_bits: int = 4):
    """Launch K5 with the sample epilogue of K1 on CUDA tensors.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s));
        sample j of a row is its sorted element (j+1)*T/s - 1.
    """
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if radix_bits not in (1, 2, 4):
        raise ValueError(f"radix_bits must be 1, 2 or 4, got {radix_bits}")
    out, samp = launch_row_sort("radix_sort", LAUNCHES, as_words(keys), vals,
                                num_samples, geometry=_k5_geometry)
    return (
        like_words(out[:-1], keys), out[-1],
        like_words(samp[:-1], keys), samp[-1],
    )


def composite_sort_rows(keys, vals: torch.Tensor):
    """The JAX package's xla stand-in for the radix strategy: stable LSD
    passes that each sort the composite ``(digit << log2(T)) | position``
    as one key, composing the source permutation.

    The JAX composites are uint32; these are int64, since CPU torch has
    no uint32 sort, shift or gather.  The digit width is still
    ``min(16, 32 - log2(T))`` bits, as there.
    """
    words = as_words(keys)
    rows, t = words[0].shape
    if t == 1:
        return like_words(words, keys), vals
    if t & (t - 1):
        raise ValueError(f"row width {t} must be a power of two")
    pb = (t - 1).bit_length()  # log2(T) position bits
    db = min(16, 32 - pb)
    dev = vals.device
    pos = torch.arange(t, device=dev).expand(rows, t)
    src_total = pos
    for wi in reversed(range(len(words))):  # least significant word first
        w = words[wi]
        for sh in range(0, 32, db):
            bits = min(db, 32 - sh)
            cur = torch.gather(w, 1, src_total)
            comp = (_digits(cur, sh, bits).long() << pb) | pos
            comp = torch.sort(comp, dim=1).values  # unique keys
            src_total = torch.gather(src_total, 1, comp & (t - 1))
    out_words = tuple(torch.gather(w, 1, src_total) for w in words)
    return like_words(out_words, keys), torch.gather(vals, 1, src_total)


def composite_sort_sample_rows(keys, vals: torch.Tensor, *, num_samples: int):
    """Stand-in of the sort+sample entry: :func:`composite_sort_rows`,
    then the s equidistant samples."""
    sk, sv = composite_sort_rows(keys, vals)
    sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
    return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)
