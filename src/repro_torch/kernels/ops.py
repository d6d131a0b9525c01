"""Kernel dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the kernel's plain PyTorch version.  There
is no fallback from one to the other, and no other device is taken.
:func:`topk`, the MoE router's entry point, first moves its scores to
``device`` as the ``repro_torch.core`` entry points do
(:func:`resolve_device`: None means "cuda").

Keys are one or two biased int32 word tensors (``core/key_codec``),
most significant first, or a bare tensor for one word; payloads int32.

:func:`sort_tiles` and :func:`sort_tiles_sample` check the fault site
``kernel.launch`` (``core/faults.py``) before they dispatch, on either
device, so a test on the CPU can fail a launch the card would make.
"""

from __future__ import annotations

import torch

from repro_torch.core import faults
from repro_torch.core.key_codec import codec_for
from repro_torch.kernels import bitonic as _bitonic
from repro_torch.kernels import merge as _merge
from repro_torch.kernels import radix as _radix
from repro_torch.kernels import splitter as _splitter
from repro_torch.kernels import topk as _topk
from repro_torch.kernels.bitonic import as_words, like_words, take_samples

COUNTERS = (_bitonic.LAUNCHES, _splitter.LAUNCHES, _splitter.RANKS_LAUNCHES,
            _topk.LAUNCHES, _radix.LAUNCHES, _merge.LAUNCHES)
STRATEGIES = ("bitonic", "radix", "merge")
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


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown local-sort strategy {strategy!r}; expected one of "
            f"{STRATEGIES}"
        )


def _plain_sort(keys, vals, strategy: str, radix_bits: int, merge_run: int):
    """The plain version of the strategy's kernel (K1, K5 or K6)."""
    if strategy == "radix":
        return _radix.radix_sort_rows(keys, vals, radix_bits=radix_bits)
    if strategy == "merge":
        return _merge.merge_sort_rows(keys, vals, merge_run=merge_run)
    return _bitonic.bitonic_network_rows(keys, vals)


def sort_tiles(keys, vals: torch.Tensor, *, strategy: str = "bitonic",
               radix_bits: int = 4, merge_run: int = 512):
    """Sort each row of (m, T) on (*words, payload); T a power of two.

    ``strategy`` picks the local sort: "bitonic" (K1), "radix" (K5,
    ``radix_bits`` wide digits) or "merge" (K6, runs of ``merge_run``).
    The radix and merge sorts are stable on the key words alone, so they
    give the bitonic order where payloads increase within equal keys (as
    everywhere in the pipeline).

    Returns:
        (sorted keys in the input structure, sorted vals).
    """
    _check_strategy(strategy)
    faults.check("kernel.launch")  # once per launch, on either device
    if not _on_cuda(vals):
        return _plain_sort(keys, vals, strategy, radix_bits, merge_run)
    if strategy == "radix":
        return _radix.sort_tiles_kv(keys, vals, radix_bits=radix_bits)
    if strategy == "merge":
        return _merge.sort_tiles_kv(keys, vals, merge_run=merge_run)
    return _bitonic.sort_tiles_kv(keys, vals)


def sort_tiles_sample(keys, vals: torch.Tensor, *, num_samples: int,
                      strategy: str = "bitonic", radix_bits: int = 4,
                      merge_run: int = 512):
    """Sorted (m, T) tiles plus s equidistant samples per tile, with the
    local sort of :func:`sort_tiles`; the kernels emit the samples from
    their epilogue.

    Returns:
        (sorted keys, sorted vals, sample keys (m, s), sample vals (m, s)).
    """
    _check_strategy(strategy)
    faults.check("kernel.launch")  # once per launch, on either device
    if not _on_cuda(vals):
        sk, sv = _plain_sort(keys, vals, strategy, radix_bits, merge_run)
        sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
        return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)
    if strategy == "radix":
        return _radix.sort_tiles_sample_kv(
            keys, vals, num_samples=num_samples, radix_bits=radix_bits)
    if strategy == "merge":
        return _merge.sort_tiles_sample_kv(
            keys, vals, num_samples=num_samples, merge_run=merge_run)
    return _bitonic.sort_tiles_sample_kv(keys, vals, num_samples=num_samples)


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
        and pads lose index ties), and K4 sorts each row in one CTA.
        Rows that pad to more than ``bitonic.MAX_TILE`` columns do not
        fit a CTA: their words are sorted with the column payload by the
        bucket-sort executor (``DEFAULT_CONFIG``, as the partial sort
        sorts its wide rows, ROADMAP.md D3), unpadded since the pads
        never enter the top k, and the first k columns are taken.
    Raises:
        RuntimeError: for CUDA when it is not available.
        ValueError: for k out of range.
    """
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"ops.topk takes (R, C) scores, got shape {tuple(x.shape)}")
    r, c = x.shape
    if not 1 <= k <= c:
        raise ValueError(f"top-k needs 1 <= k <= C = {c}, got {k}")
    cp = 1 << (c - 1).bit_length()
    codec = codec_for(x.dtype, descending=True)
    words = codec.encode(x)
    if cp > _bitonic.MAX_TILE:
        tk, ti = _wide_rows_topk(words, k)
    else:
        if cp > c:
            pad = torch.full((r, cp - c), _PAD, dtype=torch.int32,
                             device=x.device)
            words = tuple(torch.cat([w, pad], dim=1) for w in words)
        if _on_cuda(words[0]):
            tk, ti = _topk.topk_desc_cuda(words, k)
        else:
            tk, ti = _topk.topk_desc(words, k)
    return codec.decode(tk), ti


def _wide_rows_topk(words, k: int):
    """The k smallest (*words, column) of each row of (R, C) words, sorted
    whole by the bucket-sort executor on the ``DEFAULT_CONFIG`` plan."""
    from repro_torch.core.bucket_sort import _execute_packed
    from repro_torch.core.plan import build_words_plan
    from repro_torch.core.sort_config import DEFAULT_CONFIG

    r, c = words[0].shape
    cols = torch.arange(c, dtype=torch.int32, device=words[0].device)
    if r == 0:
        return tuple(w[:, :k] for w in words), cols[None, :k].expand(0, k)
    plan = build_words_plan(c, len(words), DEFAULT_CONFIG, rows=r)
    # The router has no degradation chain: a failure raises.
    skw, sv = _execute_packed(words, cols.expand(r, c).contiguous(), plan, c,
                              degrade=False)
    return tuple(w[:, :k] for w in skw), sv[:, :k]
