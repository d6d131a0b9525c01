"""Input-distribution probe that picks a local-sort strategy.

Port of the JAX package's ``core/probe.py``.  Which local sort fits the
data is a choice the planner cannot make from (shape, dtype, config)
alone; this module measures two signals on a small sample and picks it:

  * ``sortedness``: the fraction of adjacent pairs already in canonical
    order, over a few evenly spaced CONTIGUOUS chunks (runs are a
    neighbourhood property, which a scattered sample would destroy);
  * ``top_bits_entropy``: the Shannon entropy (bits, at most 8) of the
    top 8 bits of the canonical most significant key word.

Thresholds (the JAX package's):

  * sortedness >= 0.9 -> "merge" (long runs dominate; random data sits
    near 0.5);
  * one-word keys, n >= 2^19, entropy >= 2 bits -> "radix" (narrow keys,
    enough digit spread, n large enough for the passes to pay);
  * otherwise -> "bitonic".

The probe runs on the host with numpy: on a CUDA tensor only the
sampled chunks are copied to the host.  The JAX package refuses tracers
here (a data-dependent strategy cannot be picked inside ``jit``); eager
PyTorch has no tracers, so there is no such check.  Use::

    cfg = probe.probed_config(x, SortConfig())
    y = bucket_sort.sort(x, cfg)     # the plan carries the strategy

:func:`priors_for` turns the same two signals into the cost model's
``Priors`` (``core/cost_model.py``), for the autotuner's pruning.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cost_model import Priors
from repro_torch.core.key_codec import codec_for
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig

SORTEDNESS_MERGE_THRESHOLD = 0.9
ENTROPY_RADIX_THRESHOLD_BITS = 2.0
RADIX_MIN_N = 1 << 19


def _canonical_msw(words) -> np.ndarray:
    """The canonical (unbiased) most significant words as uint64."""
    biased = words[0].cpu().numpy().view(np.uint32)
    return (biased ^ np.uint32(0x80000000)).astype(np.uint64)


def probe(x, *, sample_size: int = 4096, num_chunks: int = 16,
          descending: bool = False) -> dict:
    """Measure the two strategy signals on a small sample of ``x``.

    Args:
        x: 1-D tensor or array of any codec dtype, on any device.
        sample_size: elements inspected in all (evenly spaced contiguous
            chunks; the whole array when it is small).
        num_chunks: the number of contiguous chunks.
        descending: measure sortedness in the descending canonical order
            (``SortConfig.descending``).
    Returns:
        dict with ``sortedness`` (float in [0, 1]), ``top_bits_entropy``
        (float bits in [0, 8]), ``n`` and ``num_words``.
    """
    x = torch.as_tensor(x)
    codec = codec_for(x.dtype, descending)
    n = int(x.shape[0])
    if n == 0:
        return dict(sortedness=1.0, top_bits_entropy=0.0, n=0,
                    num_words=codec.num_words)
    sample_size = min(sample_size, n)
    chunk = max(sample_size // max(num_chunks, 1), 2)
    chunks = []
    for i in range(num_chunks):
        start = (i * max(n - chunk, 0)) // max(num_chunks - 1, 1)
        chunks.append(x[start:start + chunk].cpu())
        if start + chunk >= n:
            break
    in_order = 0
    pairs = 0
    top = []
    for c in chunks:
        if c.numel() == 0:
            continue
        msw = _canonical_msw(codec.encode(c))
        if msw.size >= 2:
            in_order += int(np.sum(msw[:-1] <= msw[1:]))
            pairs += msw.size - 1
        top.append(msw >> 24)
    sortedness = (in_order / pairs) if pairs else 1.0
    hist = np.bincount(
        np.concatenate(top).astype(np.int64), minlength=256
    ).astype(np.float64)
    p = hist / hist.sum()
    nz = p[p > 0]
    entropy = float(-(nz * np.log2(nz)).sum())
    return dict(sortedness=float(sortedness), top_bits_entropy=entropy,
                n=n, num_words=codec.num_words)


def recommend_strategy(x, cfg: SortConfig = DEFAULT_CONFIG, *,
                       sample_size: int = 4096) -> str:
    """The local-sort strategy for the data ``x`` (the rule and the
    thresholds are in the module docstring)."""
    sig = probe(x, sample_size=sample_size, descending=cfg.descending)
    if sig["sortedness"] >= SORTEDNESS_MERGE_THRESHOLD:
        return "merge"
    if (
        sig["num_words"] == 1
        and sig["n"] >= RADIX_MIN_N
        and sig["top_bits_entropy"] >= ENTROPY_RADIX_THRESHOLD_BITS
    ):
        return "radix"
    return "bitonic"


def priors_for(x, cfg: SortConfig = DEFAULT_CONFIG, *,
               sample_size: int = 4096) -> Priors:
    """The cost model's distribution priors for the data ``x``:
    ``sortedness`` discounts the merge strategy's compares,
    ``top_bits_entropy`` scales the radix term for skewed digits.  Pass
    the result to ``autotune.autotune(..., priors=...)`` or
    ``autotune.plan_for(..., priors=...)``.

    Example:
        >>> import torch
        >>> from repro_torch.core import probe
        >>> probe.priors_for(torch.arange(4096, dtype=torch.int32)).sortedness
        1.0
    """
    sig = probe(x, sample_size=sample_size, descending=cfg.descending)
    return Priors(sortedness=sig["sortedness"],
                  top_bits_entropy=sig["top_bits_entropy"])


def probed_config(x, cfg: SortConfig = DEFAULT_CONFIG, *,
                  sample_size: int = 4096) -> SortConfig:
    """``cfg`` with ``strategy`` replaced by the probe's pick for ``x``.

    Example:
        >>> import torch
        >>> from repro_torch.core import probe
        >>> from repro_torch.core.sort_config import SortConfig
        >>> x = torch.arange(100_000, dtype=torch.int32)
        >>> probe.probed_config(x, SortConfig()).strategy
        'merge'
    """
    return dataclasses.replace(
        cfg, strategy=recommend_strategy(x, cfg, sample_size=sample_size)
    )
