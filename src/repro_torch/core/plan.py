"""Sort-plan IR: the static schedule of GPU BUCKET SORT as data.

Regular sampling makes every quantity of the multi-level pipeline a
function of ``(rows, length, key words, config)``: recursion levels,
per-level ``rows x tile`` geometry, ``s_round``, bucket capacities.
:func:`build_plan` computes that schedule once as a frozen
:class:`SortPlan`; the executor in ``core/bucket_sort.py`` walks it and
derives nothing.  The algorithmic fields (``kind``, ``rows``,
``length``, ``lp``, ``m``, ``s_round``, ``cap`` and the tree) equal the
JAX package's plan.  The TPU's VMEM blocking (``block_rows`` /
``part_block_rows``) has no field here: the CUDA kernel wrappers derive
their rows per CTA from the tile shape (``kernels/bitonic.py``
``effective_block_rows``, ``kernels/splitter.py``
``partition_block_rows``).  Rows are never padded (the TPU's sublane
rule does not apply).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json

import torch

from repro_torch.core.key_codec import codec_for
from repro_torch.core.sort_config import SortConfig, next_pow2, round_up


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One node of the static recursion tree.

    ``kind == "direct"``: one tile sort of each (rows, lp) row, lp =
    next_pow2(length).  ``kind == "bucket"``: one bucket round — tile
    sort with samples, sample recursion (``sample_plan``), splitter
    partition, relocation into the (rows*s_round, cap) bucket array,
    bucket recursion (``bucket_plan``), compaction.

    Attributes:
        kind: "direct" | "bucket".
        rows / length: the shape entering this level (before padding).
        lp: padded row length (direct: next power of two; bucket: a
            multiple of tile).
        tile / s / m: tile width, samples per tile, tiles per row
            (bucket levels only; 0 for direct).
        s_round: buckets this round.
        cap: per-bucket capacity round_up(lp/s_round + lp/s, 128).
    """

    kind: str
    rows: int
    length: int
    lp: int
    tile: int = 0
    s: int = 0
    m: int = 0
    s_round: int = 0
    cap: int = 0
    sample_plan: "LevelPlan | None" = None
    bucket_plan: "LevelPlan | None" = None


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """The full static schedule of one sort signature.

    Attributes:
        rows / length: entry shape (rows = 1 for the 1-D API).
        dtype_name / num_words / descending: key codec identity.
        impl: "cuda" (kernels, CUDA tensors) or "torch" (plain
            versions, CPU tensors).
        cfg_fingerprint: hash of the generating config.
        root: the level tree the executor walks.
    """

    rows: int
    length: int
    dtype_name: str
    num_words: int
    descending: bool
    impl: str
    cfg_fingerprint: str
    root: LevelPlan

    @property
    def num_levels(self) -> int:
        """Bucket rounds on the bucket_plan spine."""
        n, node = 0, self.root
        while node is not None and node.kind == "bucket":
            n += 1
            node = node.bucket_plan
        return n

    def describe(self) -> str:
        """Human-readable summary (levels and geometry)."""
        lines = [
            f"SortPlan(rows={self.rows}, length={self.length}, "
            f"dtype={self.dtype_name}{' desc' if self.descending else ''}, "
            f"impl={self.impl}, levels={self.num_levels})"
        ]
        node, depth = self.root, 0
        while node is not None:
            if node.kind == "direct":
                lines.append(
                    f"  L{depth}: direct rows={node.rows} lp={node.lp}"
                )
                break
            lines.append(
                f"  L{depth}: bucket rows={node.rows} lp={node.lp} "
                f"tile={node.tile} s={node.s} m={node.m} "
                f"s_round={node.s_round} cap={node.cap}"
            )
            node = node.bucket_plan
            depth += 1
        return "\n".join(lines)


def config_fingerprint(cfg: SortConfig) -> str:
    """Stable hash of every SortConfig field except ``plan`` and ``check``
    (they select how a plan is obtained and checked, not the schedule)."""
    d = dataclasses.asdict(cfg)
    d.pop("plan", None)
    d.pop("check", None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _build_node(rows: int, length: int, cfg: SortConfig) -> LevelPlan:
    if length <= cfg.direct_max:
        lp = next_pow2(length)
        return LevelPlan(kind="direct", rows=rows, length=length, lp=lp)
    t, sper = cfg.tile, cfg.s
    lp = round_up(length, t)
    m = lp // t
    # Step 5: s_round - 1 equidistant global splitters (s_round buckets).
    s_round = min(max(next_pow2(-(-2 * lp // t)), 2), sper)
    # The paper's guaranteed capacity, lane-rounded as in the JAX plan.
    cap = round_up(lp // s_round + lp // sper, 128)
    # A level whose sample or bucket rows are no shorter than its own
    # rows recurses forever (s == tile, s == 2, or a capacity rounded up
    # past a short length): refuse before recursing.
    if m * sper >= length or cap >= length:
        raise ValueError(
            f"SortConfig.s={sper} cannot shrink a row of length {length} "
            f"(tile={t}, direct_max={cfg.direct_max}): the level's "
            f"{'sample' if m * sper >= length else 'bucket'} rows would be "
            f"{m * sper if m * sper >= length else cap} long; use "
            "4 <= s < tile and a larger direct_max"
        )
    return LevelPlan(
        kind="bucket", rows=rows, length=length, lp=lp,
        tile=t, s=sper, m=m, s_round=s_round, cap=cap,
        sample_plan=_build_node(rows, m * sper, cfg),
        bucket_plan=_build_node(rows * s_round, cap, cfg),
    )


@functools.lru_cache(maxsize=512)
def _assemble_plan(rows: int, length: int, dtype_name: str, nw: int,
                   descending: bool, cfg: SortConfig, impl: str) -> SortPlan:
    return SortPlan(
        rows=rows, length=length, dtype_name=dtype_name, num_words=nw,
        descending=descending, impl=impl,
        cfg_fingerprint=config_fingerprint(cfg),
        root=_build_node(max(rows, 1), length, cfg),
    )


def resolve_impl(cfg: SortConfig, device) -> str:
    """The plan's impl for a device (None means "cuda").

    Raises:
        ValueError: when ``cfg.impl`` names the other device's route.
    """
    want = "cuda" if torch.device(device or "cuda").type == "cuda" else "torch"
    if cfg.impl not in (None, want):
        raise ValueError(
            f"SortConfig.impl={cfg.impl!r} does not run on device "
            f"{device or 'cuda'}: kernels take CUDA tensors, the plain "
            "versions CPU tensors"
        )
    return want


def build_plan(length: int, dtype, cfg: SortConfig, *, rows: int = 1,
               device=None) -> SortPlan:
    """Static schedule for sorting ``rows`` rows of ``length`` keys of
    ``dtype`` (a torch dtype or its name) on ``device`` (None = cuda).

    Pure and memoized: equal arguments give the same plan object.

    Example:
        >>> from repro_torch.core.plan import build_plan
        >>> from repro_torch.core.sort_config import SortConfig
        >>> p = build_plan(100_000, "int32", SortConfig(), device="cpu")
        >>> (p.root.kind, p.root.m, p.root.s_round, p.root.cap)
        ('bucket', 25, 64, 3200)
    """
    codec = codec_for(dtype, cfg.descending)
    return _assemble_plan(rows, length, codec.dtype_name, codec.num_words,
                          cfg.descending, cfg, resolve_impl(cfg, device))


def build_words_plan(length: int, num_words: int, cfg: SortConfig, *,
                     rows: int = 1, device=None) -> SortPlan:
    """Plan for callers holding canonical key words (always ascending)."""
    return _assemble_plan(rows, length, f"int32x{num_words}", num_words,
                          False, cfg, resolve_impl(cfg, device))
