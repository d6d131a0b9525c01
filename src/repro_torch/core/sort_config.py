"""Configuration for the deterministic sample sort on an NVIDIA card.

Same knobs and the same field-naming ``ValueError``s as the JAX
package's ``SortConfig``, minus the TPU-only ones (``interpret``,
``row_pad``) and ``block_rows``: the kernel wrappers size their CTAs
from the tile shape alone.  Values the port does not run yet raise
``NotImplementedError`` naming the field and the ROADMAP.md item that
will bring them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import guard


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (next_pow2(0) == 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= x."""
    return ((x + mult - 1) // mult) * mult


# (field, value the port runs, ROADMAP.md item that ports the others)
_NOT_YET_PORTED = (
    ("relocation", "gather", "Queue 1 item 4 (scatter relocation)"),
)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Knobs of Algorithm 1 (GPU BUCKET SORT).

    tile: tile width T sorted by one CTA of the tile-sort kernel; a
        power of two (T <= 16384 on the card: the row lives in shared
        memory).
    s: samples per tile == most buckets per round.
    direct_max: rows up to this length are sorted directly as one
        tile instead of going through a bucket round.
    fuse_ranking: True ranks splitters and counts buckets in one
        kernel (K2, splitter partition); False ranks them with K3
        (splitter ranks) and derives the counts from the ranks.
    fuse_sampling: True takes the samples in the tile sort's epilogue;
        False sorts the tiles, then slices the samples out.
    strategy: the local sort of every tile and direct row: "bitonic"
        (K1, the network), "radix" (K5, a stable LSD radix sort on the
        key words) or "merge" (K6, bitonic runs and merge-path levels).
        All three give the same rows inside the pipeline.
    radix_bits: digit width of the radix strategy, 1, 2 or 4.
    merge_run: run length the merge strategy forms with the bitonic
        network before its merge levels; a power of two >= 2.
    relocation: as in the JAX package; only "gather" runs in the port.
    plan: how the sort's plan is obtained (``bucket_sort.resolve_plan``):
        "default" builds it from these knobs, "autotune" takes the
        measured-best plan for the signature on the sort's device
        (``core/autotune.py``, kept in a store on disk), and any other
        string is the path of a plan file written by
        ``autotune.save_plan``.
    check: runtime invariant checking (``core/guard.py``): "off",
        "bounds" (the capacity bound on every round's measured bucket
        fills) or "full" (also permutation checksums and sortedness of
        the output).  Not part of the config fingerprint, so checked and
        unchecked runs share plans.
    descending: stable descending order through the codec.

    There is no ``impl``: the device of the tensors alone decides
    whether a kernel or its plain version runs.
    """

    tile: int = 4096
    s: int = 64
    direct_max: int = 8192
    fuse_sampling: bool = True
    fuse_ranking: bool = True
    relocation: str = "gather"
    descending: bool = False
    plan: str = "default"
    strategy: str = "bitonic"
    radix_bits: int = 4
    merge_run: int = 512
    check: str = "off"

    def __post_init__(self):
        def _pow2(name, v, lo):
            if not (isinstance(v, int) and v >= lo and v & (v - 1) == 0):
                raise ValueError(
                    f"SortConfig.{name} must be a power of two >= {lo}, "
                    f"got {v!r}"
                )

        _pow2("tile", self.tile, 2)
        _pow2("s", self.s, 2)
        if self.s > self.tile:
            raise ValueError(
                f"SortConfig.s ({self.s}) must not exceed SortConfig.tile "
                f"({self.tile}): s samples are drawn per tile"
            )
        if self.tile % self.s != 0:
            raise ValueError(
                f"SortConfig.tile ({self.tile}) must be a multiple of "
                f"SortConfig.s ({self.s})"
            )
        if self.direct_max < self.tile:
            raise ValueError(
                f"SortConfig.direct_max ({self.direct_max}) must be >= "
                f"SortConfig.tile ({self.tile})"
            )
        if self.relocation not in ("gather", "scatter"):
            raise ValueError(
                f'SortConfig.relocation must be "gather" or "scatter", '
                f"got {self.relocation!r}"
            )
        if self.strategy not in ("bitonic", "radix", "merge"):
            raise ValueError(
                'SortConfig.strategy must be "bitonic", "radix" or '
                f'"merge", got {self.strategy!r}'
            )
        if self.radix_bits not in (1, 2, 4):
            raise ValueError(
                f"SortConfig.radix_bits must be 1, 2 or 4, got "
                f"{self.radix_bits!r}"
            )
        _pow2("merge_run", self.merge_run, 2)
        if not (isinstance(self.plan, str) and self.plan):
            raise ValueError(
                'SortConfig.plan must be "default", "autotune", or a '
                f"plan-file path, got {self.plan!r}"
            )
        guard.validate_check(self.check, "SortConfig.check")
        for name, ported, item in _NOT_YET_PORTED:
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"SortConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (only {ported!r}); see ROADMAP.md {item}"
                )


# Paper default: s = 64 (Fig. 3 sweep), 2K-item tiles.
PAPER_CONFIG = SortConfig(tile=2048, s=64, direct_max=4096)
DEFAULT_CONFIG = SortConfig()
