"""Torch oracles for K1-K4, independent of the kernels' formulations.

Lexicographic order on ``(*words, payload)`` comes from stable
``torch.sort`` passes, least significant word first.  The tests and
the chip check hold the plain versions and the kernels against these.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitonic import as_words, like_words, take_samples


def lex_order(parts) -> torch.Tensor:
    """int64 permutation along the last axis that sorts ``parts``
    (equal-shape tensors, most significant first) lexicographically;
    stable."""
    idx = None
    for p in reversed(parts):
        key = p if idx is None else torch.gather(p, -1, idx)
        order = torch.sort(key, dim=-1, stable=True).indices
        idx = order if idx is None else torch.gather(idx, -1, order)
    return idx


def sort_tiles_kv(keys, vals):
    """Each row of (m, T) sorted ascending on (*words, payload)."""
    words = as_words(keys)
    idx = lex_order(words + (vals,))
    out = tuple(torch.gather(w, -1, idx) for w in words)
    return like_words(out, keys), torch.gather(vals, -1, idx)


def sort_tiles_sample_kv(keys, vals, *, num_samples: int):
    """Sorted rows plus the s samples (elements (j+1)*T/s - 1) per row."""
    sk, sv = sort_tiles_kv(keys, vals)
    sw = tuple(take_samples(w, num_samples) for w in as_words(sk))
    return sk, sv, like_words(sw, keys), take_samples(sv, num_samples)


def splitter_ranks(keys, vals, sp_keys, sp_vals):
    """(m, S) ranks by merging: each tile's elements and its splitters
    are sorted together, splitters before equal elements, and a
    splitter's rank is the number of tile elements ahead of it.  Holds
    for tiles and splitters in any order."""
    words, sp_words = as_words(keys), as_words(sp_keys)
    m, t = vals.shape
    s = sp_vals.shape[1]
    tag = torch.cat([
        torch.ones((m, t), dtype=torch.int32, device=vals.device),
        torch.zeros((m, s), dtype=torch.int32, device=vals.device),
    ], dim=1)
    parts = tuple(
        torch.cat([a, b], dim=1)
        for a, b in zip(words + (vals,), sp_words + (sp_vals,))
    ) + (tag,)
    idx = lex_order(parts)
    is_elem = torch.gather(tag, 1, idx)
    elems_before = torch.cumsum(is_elem, dim=1) - is_elem
    # Position of every merged column in the sorted order (inverse of idx).
    pos = torch.empty_like(idx)
    pos.scatter_(1, idx, torch.arange(t + s, device=vals.device).expand(m, -1))
    return torch.gather(elems_before, 1, pos[:, t:]).to(torch.int32)


def splitter_partition(keys, vals, sp_keys, sp_vals):
    """(ranks (m, S), counts (m, S+1)): :func:`splitter_ranks` and the
    bucket sizes ends - starts of each tile."""
    ranks = splitter_ranks(keys, vals, sp_keys, sp_vals)
    t = vals.shape[1]
    zero = torch.zeros_like(ranks[:, :1])
    counts = torch.cat([ranks, zero + t], 1) - torch.cat([zero, ranks], 1)
    return ranks, counts


def topk_desc(keys, k: int):
    """Per row of (R, C) words, the k smallest keys on (*words, column)
    and their columns, by a stable lexicographic sort."""
    words = as_words(keys)
    r, c = words[0].shape
    idx = torch.arange(c, dtype=torch.int32, device=words[0].device).expand(r, c)
    order = lex_order(words + (idx,))[:, :k]
    top = tuple(torch.gather(w, 1, order) for w in words)
    return like_words(top, keys), torch.gather(idx, 1, order)
