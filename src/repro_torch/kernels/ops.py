"""Kernel dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the kernel's plain PyTorch version.  There
is no fallback from one to the other, and no other device is taken.
:func:`topk`, the MoE router's entry point, first moves its scores to
``device`` as the ``repro_torch.core`` entry points do
(:func:`resolve_device`: None means "cuda").

Keys are one or two biased int32 word tensors (``core/key_codec``),
most significant first, or a bare tensor for one word; payloads int32.
"""

from __future__ import annotations

import torch

from repro_torch.core.key_codec import codec_for
from repro_torch.kernels import bitonic as _bitonic
from repro_torch.kernels import splitter as _splitter
from repro_torch.kernels import topk as _topk
from repro_torch.kernels.bitonic import as_words, like_words, take_samples

COUNTERS = (_bitonic.LAUNCHES, _splitter.LAUNCHES, _splitter.RANKS_LAUNCHES,
            _topk.LAUNCHES)
_PAD = 2**31 - 1  # biased pad word (canonical 0xFFFFFFFF), the worst score


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.reset()


def resolve_device(device=None) -> torch.device:
    """An entry point's ``device`` as a torch.device, None meaning "cuda".

    Raises:
        RuntimeError: for a CUDA device when CUDA is not available.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch sorts on CUDA by default and CUDA is not available; "
            'pass device="cpu" to run the plain PyTorch versions'
        )
    return dev


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def sort_tiles(keys, vals: torch.Tensor):
    """Sort each row of (m, T) on (*words, payload); T a power of two.

    Returns:
        (sorted keys in the input structure, sorted vals).
    """
    if _on_cuda(vals):
        return _bitonic.sort_tiles_kv(keys, vals)
    return _bitonic.bitonic_network_rows(keys, vals)


def sort_tiles_sample(keys, vals: torch.Tensor, *, num_samples: int):
    """Sorted (m, T) tiles plus s equidistant samples per tile.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s)).
    """
    if _on_cuda(vals):
        return _bitonic.sort_tiles_sample_kv(keys, vals, num_samples=num_samples)
    sk, sv = _bitonic.bitonic_network_rows(keys, vals)
    sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
    return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)


def splitter_partition(keys, vals, sp_keys, sp_vals):
    """Splitter ranks (m, S) and bucket counts (m, S+1) per tile.  On CUDA
    the tiles must be sorted (see ``splitter.splitter_partition_cuda``)."""
    if _on_cuda(vals):
        return _splitter.splitter_partition_cuda(keys, vals, sp_keys, sp_vals)
    return _splitter.splitter_partition(keys, vals, sp_keys, sp_vals)


def splitter_ranks(keys, vals, sp_keys, sp_vals):
    """(m, S) int32 count of the elements of tile i lexicographically
    below splitter (i, j); tiles and splitters in any order."""
    if _on_cuda(vals):
        return _splitter.splitter_ranks_cuda(keys, vals, sp_keys, sp_vals)
    return _splitter.splitter_ranks(keys, vals, sp_keys, sp_vals)


def topk(x, k: int, *, device=None):
    """Row-wise top-k (descending) of (R, C) scores: the MoE router's
    entry point.

    Args:
        x: (R, C) scores of any codec dtype (``key_codec.SUPPORTED_DTYPES``).
        k: 1 <= k <= C.
        device: where to run (None = "cuda"; "cpu" runs the plain
            version).  ``x`` is moved there.
    Returns:
        (values (R, k) in x.dtype, indices (R, k) int32), on ``device``;
        ties toward the smaller index.  C is padded up to a power of two
        with worst-score columns, which never enter the top k (k <= C,
        and pads lose index ties).
    Raises:
        RuntimeError: for CUDA when it is not available.
        ValueError: for k out of range, or when C pads to more than
            ``bitonic.MAX_TILE`` columns (one row lives in one CTA's
            shared memory); ``repro_torch.core.topk_batched`` takes rows
            of any width.
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"ops.topk takes (R, C) scores, got shape {tuple(x.shape)}")
    r, c = x.shape
    if not 1 <= k <= c:
        raise ValueError(f"top-k needs 1 <= k <= C = {c}, got {k}")
    cp = 1 << (c - 1).bit_length()
    if cp > _bitonic.MAX_TILE:
        raise ValueError(
            f"ops.topk sorts rows of up to {_bitonic.MAX_TILE} columns after "
            f"padding to a power of two; C = {c} pads to {cp}: use "
            "repro_torch.core.topk_batched for wider rows"
        )
    codec = codec_for(x.dtype, descending=True)
    words = codec.encode(x)
    if cp > c:
        pad = torch.full((r, cp - c), _PAD, dtype=torch.int32, device=x.device)
        words = tuple(torch.cat([w, pad], dim=1) for w in words)
    if _on_cuda(words[0]):
        tk, ti = _topk.topk_desc_cuda(words, k)
    else:
        tk, ti = _topk.topk_desc(words, k)
    return codec.decode(tk), ti
