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
rule does not apply).  A plan depends on shape, dtype and config only:
the device of the tensors it runs on decides kernel or plain version.

:func:`build_topk_plan` is the partial sort's one-round schedule
(:class:`TopkPlan`, ``core/partial_sort.py``).  :func:`kernel_launches`
and :func:`topk_launches` list the kernel launches a plan's walk makes;
:func:`plan_to_dict` / :func:`plan_from_dict` serialize a plan for the
autotuner's store and plan files (``core/autotune.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json

from repro_torch.core.key_codec import codec_for
from repro_torch.core.sort_config import SortConfig, next_pow2, round_up
from repro_torch.kernels import bitonic


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
        fuse_ranking: bucket levels: rank splitters and count buckets
            with K2 (True) or rank with K3 and count from the ranks
            (False); False on direct levels, as in the JAX plan.
        fuse_sampling: bucket levels: samples from the tile sort's
            epilogue (True) or sliced from the sorted tiles (False);
            False on direct levels, as in the JAX plan.
        strategy / radix_bits / merge_run: the local sort of the level's
            tiles or rows (K1, K5 or K6) and its knobs, copied from the
            config at every node.
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
    fuse_ranking: bool = False
    fuse_sampling: bool = False
    strategy: str = "bitonic"
    radix_bits: int = 4
    merge_run: int = 512
    sample_plan: "LevelPlan | None" = None
    bucket_plan: "LevelPlan | None" = None


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """The full static schedule of one sort signature.

    Attributes:
        rows / length: entry shape (rows = 1 for the 1-D API).
        dtype_name / num_words / descending: key codec identity.
        cfg_fingerprint: hash of the generating config.
        root: the level tree the executor walks.
    """

    rows: int
    length: int
    dtype_name: str
    num_words: int
    descending: bool
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
            f"levels={self.num_levels})"
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


def _strategy_fields(cfg: SortConfig) -> dict:
    """The local-sort fields every plan node copies from the config."""
    return dict(strategy=cfg.strategy, radix_bits=cfg.radix_bits,
                merge_run=cfg.merge_run)


def _build_node(rows: int, length: int, cfg: SortConfig) -> LevelPlan:
    if length <= cfg.direct_max:
        lp = next_pow2(length)
        return LevelPlan(kind="direct", rows=rows, length=length, lp=lp,
                         **_strategy_fields(cfg))
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
        fuse_ranking=cfg.fuse_ranking, fuse_sampling=cfg.fuse_sampling,
        **_strategy_fields(cfg),
        sample_plan=_build_node(rows, m * sper, cfg),
        bucket_plan=_build_node(rows * s_round, cap, cfg),
    )


@functools.lru_cache(maxsize=512)
def _assemble_plan(rows: int, length: int, dtype_name: str, nw: int,
                   descending: bool, cfg: SortConfig) -> SortPlan:
    return SortPlan(
        rows=rows, length=length, dtype_name=dtype_name, num_words=nw,
        descending=descending, cfg_fingerprint=config_fingerprint(cfg),
        root=_build_node(max(rows, 1), length, cfg),
    )


def build_plan(length: int, dtype, cfg: SortConfig, *,
               rows: int = 1) -> SortPlan:
    """Static schedule for sorting ``rows`` rows of ``length`` keys of
    ``dtype`` (a torch dtype or its name).

    Pure and memoized: equal arguments give the same plan object.

    Example:
        >>> from repro_torch.core.plan import build_plan
        >>> from repro_torch.core.sort_config import SortConfig
        >>> p = build_plan(100_000, "int32", SortConfig())
        >>> (p.root.kind, p.root.m, p.root.s_round, p.root.cap)
        ('bucket', 25, 64, 3200)
    """
    codec = codec_for(dtype, cfg.descending)
    return _assemble_plan(rows, length, codec.dtype_name, codec.num_words,
                          cfg.descending, cfg)


def build_words_plan(length: int, num_words: int, cfg: SortConfig, *,
                     rows: int = 1) -> SortPlan:
    """Plan for callers holding canonical key words (always ascending)."""
    return _assemble_plan(rows, length, f"int32x{num_words}", num_words,
                          False, cfg)


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    """Static schedule of the partial sort: one bucket round (tile sort
    with samples, sample sort, splitter ranks), the candidate pack and
    the candidate sort (``core/partial_sort.py``).

    Attributes:
        rows: batch rows (1 for the 1-D entry).
        length: scores per row.
        k: requested top-k.
        lp: length padded to a tile multiple.
        m: tiles per row.
        tile / s: tile width and samples per tile.
        cap: the bucket-capacity bound round_up(2*lp/s, 128) that the
            threshold argument relies on.
        ccap: candidate-buffer width round_up(min(k + cap, lp), 128).
        direct_max: rows up to this length are sorted whole instead.
        sample_plan / final_plan: how the (rows, m*s) sample rows and the
            rows sorted last (the (rows, ccap) candidates, or the whole
            (rows, length) rows on the direct path) are sorted.  None:
            the row, padded to a power of two, fits one tile of the row
            sorts (``bitonic.MAX_TILE``).  Otherwise the bucket-sort plan the
            executor runs on the row, from the caller's config.
            ``sample_plan`` is None on the direct path.
        strategy / radix_bits / merge_run: the local sort (K1, K5 or K6)
            of the tiles and of the rows sorted whole, from the config.
    """

    rows: int
    length: int
    k: int
    lp: int
    m: int
    tile: int
    s: int
    cap: int
    ccap: int
    direct_max: int
    sample_plan: SortPlan | None = None
    final_plan: SortPlan | None = None
    strategy: str = "bitonic"
    radix_bits: int = 4
    merge_run: int = 512


_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=512)
def _assemble_topk_plan(length: int, k: int, cfg: SortConfig, rows: int,
                        num_words: int, max_tile: int) -> TopkPlan:
    t, sper = cfg.tile, cfg.s
    lp = round_up(length, t)
    cap = round_up(2 * lp // sper, 128)
    ccap = round_up(min(k + cap, lp), 128)

    def row_plan(width: int) -> SortPlan | None:
        if next_pow2(width) <= max_tile:
            return None
        # The executor needs distinct pairs, so each pad of such a row
        # gets the int32 payload length + its column (partial_sort).
        if length + width > _INT_MAX:
            raise ValueError(
                f"top-k of rows of {length} keys: a {width}-wide row's pad "
                f"payloads (length + column) would overflow int32"
            )
        return build_words_plan(width, num_words, cfg, rows=rows)

    direct = length <= cfg.direct_max
    return TopkPlan(
        rows=rows, length=length, k=k, lp=lp, m=lp // t, tile=t, s=sper,
        cap=cap, ccap=ccap, direct_max=cfg.direct_max,
        sample_plan=None if direct else row_plan(lp // t * sper),
        final_plan=row_plan(length if direct else ccap),
        **_strategy_fields(cfg),
    )


def build_topk_plan(length: int, k: int, dtype, cfg: SortConfig, *,
                    rows: int = 1) -> TopkPlan:
    """Static schedule for :func:`repro_torch.core.partial_sort.topk`
    (``rows`` = 1) and ``topk_batched`` (``rows`` = B).

    Pure and memoized like :func:`build_plan` (``bitonic.MAX_TILE`` is
    part of the key).  Lengths up to ``cfg.direct_max`` take the direct
    path and never read the bucket fields.  Which rows one row-sort
    launch (K1, K5 or K6) sorts and which the bucket-sort executor sorts
    is decided here, from the shape alone.

    Raises:
        ValueError: unless 1 <= k <= length; or when a row too wide for
            one tile would need pad payloads past int32 (length near 2^31).
        TypeError: for a dtype without a key codec.
    """
    codec = codec_for(dtype, descending=True)
    if not 1 <= k <= length:
        raise ValueError(f"top-k needs 1 <= k <= length, got k={k}, "
                         f"length={length}")
    return _assemble_topk_plan(length, k, cfg, rows, codec.num_words,
                               bitonic.MAX_TILE)


# ----------------------------------------------------------------------
# The launches of a plan's walk
# ----------------------------------------------------------------------

#: The row-sort kernel of each local-sort strategy: K1, K5, K6.
SORTERS = {"bitonic": "tile_sort", "radix": "radix_sort", "merge": "merge_sort"}


def kernel_launches(node: LevelPlan | None, out: list | None = None) -> list:
    """(kernel, rows, T, samples or splitters) of every launch the
    executor's walk of ``node`` makes on the card, in order: a row sort
    (K1, K5 or K6 by the node's strategy) of each level's tiles or direct
    rows, and K2 (fused ranking) or K3 of each bucket level."""
    out = [] if out is None else out
    if node is None:
        return out
    sorter = SORTERS[node.strategy]
    if node.kind == "direct":
        out.append((sorter, node.rows, node.lp, 0))
        return out
    out.append((sorter, node.rows * node.m, node.tile,
                node.s if node.fuse_sampling else 0))
    kernel_launches(node.sample_plan, out)
    out.append(("splitter_partition" if node.fuse_ranking else "splitter_ranks",
                node.rows * node.m, node.tile, node.s_round - 1))
    kernel_launches(node.bucket_plan, out)
    return out


def topk_launches(tplan: TopkPlan) -> list:
    """The launches of a partial sort's walk, from its TopkPlan: a row
    the plan gives no SortPlan is one launch of the strategy's row sort
    at its power-of-two width, a row it does is that plan's walk."""
    out = []
    sorter = SORTERS[tplan.strategy]

    def row(n, plan):
        if plan is None:
            out.append((sorter, tplan.rows, max(2, next_pow2(n)), 0))
        else:
            kernel_launches(plan.root, out)

    if tplan.length <= tplan.direct_max:
        row(tplan.length, tplan.final_plan)
        return out
    tiles = tplan.rows * tplan.m
    out.append((sorter, tiles, tplan.tile, tplan.s))
    row(tplan.m * tplan.s, tplan.sample_plan)
    out.append(("splitter_ranks", tiles, tplan.tile, tplan.s - 1))
    row(tplan.ccap, tplan.final_plan)
    return out


def plan_launches(plan: SortPlan) -> collections.Counter:
    """Launches per kernel of a SortPlan's walk."""
    return collections.Counter(k for k, *_ in kernel_launches(plan.root))


# ----------------------------------------------------------------------
# Serialization: the autotuner's store and plan files
# ----------------------------------------------------------------------

# The port's own record tag: its plans carry no TPU fields (block_rows,
# impl, interpret, backend, relocation), so a JAX package record
# (sort_plan/v2) is not one of them.
_SCHEMA = "torch_sort_plan/v1"


def _node_from_dict(d) -> LevelPlan | None:
    if d is None:
        return None
    d = dict(d)
    d["sample_plan"] = _node_from_dict(d.get("sample_plan"))
    d["bucket_plan"] = _node_from_dict(d.get("bucket_plan"))
    return LevelPlan(**d)


def plan_to_dict(plan: SortPlan) -> dict:
    """JSON-serializable record of a plan; ``plan_from_dict(plan_to_dict(p))
    == p`` exactly."""
    d = dataclasses.asdict(plan)
    d["schema"] = _SCHEMA
    return d


def plan_from_dict(d: dict) -> SortPlan:
    """The :class:`SortPlan` of a record written by :func:`plan_to_dict`.

    Raises:
        ValueError: for a record without the port's schema tag (a JAX
            package record, an older schema), or with fields that are
            not the plan's.
    """
    d = dict(d)
    schema = d.pop("schema", None)
    if schema != _SCHEMA:
        raise ValueError(f"not a {_SCHEMA} record (schema={schema!r})")
    try:
        d["root"] = _node_from_dict(d["root"])
        return SortPlan(**d)
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed {_SCHEMA} record: {e}") from e


def plan_json(plan: SortPlan) -> str:
    """Canonical JSON of a plan (sorted keys): byte-identical for equal
    plans."""
    return json.dumps(plan_to_dict(plan), sort_keys=True)
