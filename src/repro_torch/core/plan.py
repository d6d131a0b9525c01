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

:class:`ShardPlan` is the distributed sort's schedule
(``core/distributed_sort.py``): the capacities of :func:`shard_geometry`
and four per-phase local-sort plans, built by :func:`build_shard_plan`;
:func:`shard_launches` is its walk, and :func:`shard_plan_to_dict` /
:func:`shard_plan_from_dict` its record.  Like :class:`SortPlan` it
holds no device and no backend: the tensors and the process group of a
run decide those.
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
# ShardPlan: the distributed sort's schedule
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """Capacities of the distributed deal-round sort, the JAX package's
    arithmetic.

    Regular sampling bounds every global bucket at ``b_t = n_pad * (1 +
    1/oversample)``; the deal spreads each source's share of a bucket
    over the d ranks to within one, so one rank sends another at most
    ``c_pair = ceil(b_t / d) + d`` elements (rounded up to
    ``pair_align``), and the exchange has a fixed shape.

    Attributes:
        n_local: shard length before padding.
        d: ranks the sort spans.
        oversample: regular-sampling oversample factor c.
        pair_align: the multiple c_pair is rounded up to.
        s_loc: samples per shard (oversample * d).
        n_pad: shard length padded to a multiple of s_loc, so that the
            deal and the equidistant sampling are exact.
        b_t: the largest global bucket, n_pad + n_pad // oversample.
        c_pair: what one rank sends another in the exchange, at most.
        out_cap: the output capacity of a rank, at least any bucket.
    """

    n_local: int
    d: int
    oversample: int
    pair_align: int
    s_loc: int
    n_pad: int
    b_t: int
    c_pair: int
    out_cap: int


def shard_geometry(n_local: int, d: int, oversample: int = 8,
                   pair_align: int = 8) -> ShardGeometry:
    """The distributed sort's capacities, validated.

    Raises:
        ValueError: naming the argument, with the JAX package's messages:
            ``n_local`` an int >= 1, ``d`` an int >= 2, ``oversample`` a
            power of two >= 1, ``pair_align`` a power of two >= 8.

    Example:
        >>> from repro_torch.core.plan import shard_geometry
        >>> g = shard_geometry(n_local=1000, d=4, oversample=8)
        >>> (g.s_loc, g.n_pad, g.b_t, g.c_pair >= g.b_t // 4 + 4)
        (32, 1024, 1152, True)
    """
    if not (isinstance(n_local, int) and n_local >= 1):
        raise ValueError(
            f"shard_geometry n_local must be an int >= 1, got {n_local!r}")
    if not (isinstance(d, int) and d >= 2):
        raise ValueError(
            f"shard_geometry d must be an int >= 2 (devices along the "
            f"sort axis), got {d!r}")
    if not (isinstance(oversample, int) and oversample >= 1
            and oversample & (oversample - 1) == 0):
        raise ValueError(
            "oversample must be a power of two >= 1 (keeps s_loc = "
            f"oversample * d power-of-two-compatible), got {oversample!r}")
    if not (isinstance(pair_align, int) and pair_align >= 8
            and pair_align & (pair_align - 1) == 0):
        raise ValueError(
            f"pair_align must be a power of two >= 8, got {pair_align!r}")
    s_loc = oversample * d
    n_pad = round_up(n_local, s_loc)
    b_t = n_pad + n_pad // oversample
    c_pair = round_up(-(-b_t // d) + d, pair_align)
    return ShardGeometry(
        n_local=n_local, d=d, oversample=oversample, pair_align=pair_align,
        s_loc=s_loc, n_pad=n_pad, b_t=b_t, c_pair=c_pair,
        out_cap=min(round_up(b_t, 8), d * c_pair),
    )


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The static schedule of one distributed sort signature.

    Attributes:
        axis: the mesh axis names the group stands for (identity only).
        d / n_local / n_pad / oversample / pair_align / s_loc / b_t /
            c_pair / out_cap: the :class:`ShardGeometry`.
        dtype_name / num_words / descending: key codec identity.
        cfg_fingerprint: hash of the generating config.
        run_plan: the local sort of the (1, n_pad) shard, with the
            config's strategy.
        dealt_plan: the local sort of the dealt (1, n_pad) run.
        sample_plan: the sort of the (1, d*s_loc) gathered samples.
        bucket_plan: the sort of the received (1, d*c_pair) buckets.
            These three sort with the bitonic strategy (K1, on words and
            payload) whatever the config's: their inputs are d sorted
            runs one after the other, whose equal keys a sort stable on
            the key words alone would leave out of payload order.
    """

    axis: tuple[str, ...]
    d: int
    n_local: int
    n_pad: int
    oversample: int
    pair_align: int
    s_loc: int
    b_t: int
    c_pair: int
    out_cap: int
    dtype_name: str
    num_words: int
    descending: bool
    cfg_fingerprint: str
    run_plan: SortPlan
    dealt_plan: SortPlan
    sample_plan: SortPlan
    bucket_plan: SortPlan

    @property
    def n_glob(self) -> int:
        """Global padded element count (n_pad * d)."""
        return self.n_pad * self.d

    @property
    def bytes_per_element(self) -> int:
        """Bytes an element moves with: its key words and its payload."""
        return 4 * (self.num_words + 1)

    @property
    def exchange_elements(self) -> int:
        """Elements a rank sends (and receives) in the bucket exchange,
        c_pair-padded: d * c_pair."""
        return self.d * self.c_pair

    @property
    def collective_elements(self) -> int:
        """Elements a rank moves through collectives: the deal (n_pad),
        the sample gather (d * s_loc) and the exchange (d * c_pair)."""
        return self.n_pad + self.d * self.s_loc + self.exchange_elements

    def signature(self) -> tuple:
        """The plan's identity: axis names and d, shard length, dtype and
        order, oversample and pair_align, the config's fingerprint."""
        return ("x".join(self.axis), self.d, self.n_local, self.dtype_name,
                self.descending, self.oversample, self.pair_align,
                self.cfg_fingerprint)

    def describe(self) -> str:
        """Human-readable summary of the distributed schedule."""
        lines = [
            f"ShardPlan(axis={self.axis}, d={self.d}, "
            f"n_local={self.n_local}->{self.n_pad}, dtype={self.dtype_name}"
            f"{' desc' if self.descending else ''}, "
            f"oversample={self.oversample}, c_pair={self.c_pair}, "
            f"out_cap={self.out_cap})"
        ]
        for name in SHARD_SUBPLANS:
            sub: SortPlan = getattr(self, name)
            lines.append(f"  {name}: length={sub.length} "
                         f"levels={sub.num_levels} strategy={sub.root.strategy}")
        return "\n".join(lines)


#: The four per-phase local-sort plans of a ShardPlan, in run order.
SHARD_SUBPLANS = ("run_plan", "dealt_plan", "sample_plan", "bucket_plan")


@functools.lru_cache(maxsize=256)
def _assemble_shard_plan(axis: tuple[str, ...], d: int, n_local: int,
                         dtype_name: str, nw: int, descending: bool,
                         cfg: SortConfig, oversample: int,
                         pair_align: int) -> ShardPlan:
    g = shard_geometry(n_local, d, oversample, pair_align)
    sub = functools.partial(build_words_plan, num_words=nw, cfg=cfg)
    # The dealt run, the gathered samples and the received buckets are
    # concatenations of d sorted runs: equal keys do not arrive in payload
    # order there, so only a sort on (words, payload) orders them, and the
    # radix and merge sorts are stable on the words alone (ROADMAP.md R5,
    # D13).  The config's strategy sorts the shard itself.
    merged = functools.partial(
        build_words_plan, num_words=nw,
        cfg=dataclasses.replace(cfg, strategy="bitonic", plan="default"))
    return ShardPlan(
        axis=axis, d=d, n_local=n_local, n_pad=g.n_pad, oversample=oversample,
        pair_align=pair_align, s_loc=g.s_loc, b_t=g.b_t, c_pair=g.c_pair,
        out_cap=g.out_cap, dtype_name=dtype_name, num_words=nw,
        descending=descending, cfg_fingerprint=config_fingerprint(cfg),
        run_plan=sub(g.n_pad), dealt_plan=merged(g.n_pad),
        sample_plan=merged(d * g.s_loc), bucket_plan=merged(d * g.c_pair),
    )


def build_shard_plan(axis, d: int, n_local: int, dtype, cfg: SortConfig, *,
                     oversample: int = 8, pair_align: int = 8) -> ShardPlan:
    """Static schedule of a distributed sort of d shards of ``n_local``
    keys of ``dtype``.

    Pure and memoized like :func:`build_plan`: equal arguments give the
    same plan object.  ``axis`` (a name or a tuple of names) becomes a
    tuple; ``cfg.plan`` is not read here (``make_sharded_sort`` is where
    a plan is chosen).

    Raises:
        ValueError: from :func:`shard_geometry`, naming the argument, or
            from the sub-plans' builder (ROADMAP.md D2).
        TypeError: for a dtype without a key codec.

    Example:
        >>> from repro_torch.core.plan import build_shard_plan
        >>> from repro_torch.core.sort_config import SortConfig
        >>> p = build_shard_plan("data", 4, 2048, "int32",
        ...                      SortConfig(tile=256, s=16, direct_max=512))
        >>> (p.axis, p.n_pad, p.c_pair % 8, p.out_cap >= p.b_t)
        (('data',), 2048, 0, True)
    """
    axt = (axis,) if isinstance(axis, str) else tuple(axis)
    codec = codec_for(dtype, cfg.descending)
    return _assemble_shard_plan(axt, d, n_local, codec.dtype_name,
                                codec.num_words, cfg.descending, cfg,
                                oversample, pair_align)


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


def shard_launches(plan: ShardPlan) -> list:
    """The launches one rank's run of a ShardPlan makes, in order: the
    walks of the run, dealt and sample plans, one K3 launch ranking the
    d - 1 splitters in the (1, n_pad) run, then the bucket plan's walk."""
    out = kernel_launches(plan.run_plan.root)
    kernel_launches(plan.dealt_plan.root, out)
    kernel_launches(plan.sample_plan.root, out)
    out.append(("splitter_ranks", 1, plan.n_pad, plan.d - 1))
    kernel_launches(plan.bucket_plan.root, out)
    return out


def plan_launches(plan) -> collections.Counter:
    """Launches per kernel of a SortPlan's or a ShardPlan's walk (one
    rank's, for a ShardPlan)."""
    walk = (shard_launches(plan) if isinstance(plan, ShardPlan)
            else kernel_launches(plan.root))
    return collections.Counter(k for k, *_ in walk)


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


# The distributed sort's record: the four sub-plans are embedded as
# whole torch_sort_plan/v1 records, so a change of that schema makes
# stored shard plans clean misses too.
_SHARD_SCHEMA = "torch_shard_plan/v1"


def shard_plan_to_dict(plan: ShardPlan) -> dict:
    """JSON-serializable record of a shard plan;
    ``shard_plan_from_dict(shard_plan_to_dict(p)) == p`` exactly."""
    d = dataclasses.asdict(plan)
    d["axis"] = list(plan.axis)
    for name in SHARD_SUBPLANS:
        d[name] = plan_to_dict(getattr(plan, name))
    d["schema"] = _SHARD_SCHEMA
    return d


def shard_plan_from_dict(d: dict) -> ShardPlan:
    """The :class:`ShardPlan` of a record written by
    :func:`shard_plan_to_dict`.

    Raises:
        ValueError: for a record without the port's shard schema tag (a
            JAX package record among them), with a sub-plan of another
            schema, or with fields that are not the plan's.
    """
    d = dict(d)
    schema = d.pop("schema", None)
    if schema != _SHARD_SCHEMA:
        raise ValueError(f"not a {_SHARD_SCHEMA} record (schema={schema!r})")
    try:
        d["axis"] = tuple(d["axis"])
        for name in SHARD_SUBPLANS:
            d[name] = plan_from_dict(d[name])
        return ShardPlan(**d)
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed {_SHARD_SCHEMA} record: {e}") from e


def shard_plan_json(plan: ShardPlan) -> str:
    """Canonical JSON of a shard plan (sorted keys)."""
    return json.dumps(shard_plan_to_dict(plan), sort_keys=True)
