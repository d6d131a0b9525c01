"""Deterministic fault injection for guarded execution.

The port's copy of the JAX package's ``core/faults.py``, with the same
registry and rules.  Production code calls ``faults.check("<site>")``
at each fallible site; with no rule armed the call is a dict lookup and
an integer increment.

Sites are a closed registry (``SITES``), so a typo in either the
instrumentation or a test is an immediate ``ValueError`` rather than a
rule that never fires.  ``kernels/ops.py`` ``sort_tiles`` and
``sort_tiles_sample`` check ``kernel.launch`` before they dispatch, on
either device.  The JAX package checks it when it traces a jitted sort,
once per trace; the port checks it once per launch, so a sort hits the
site once per row-sort launch of its plan.  ``core/autotune.py`` checks
``cache.load`` and ``cache.save`` at each store read and write, and
``autotune.measure`` once per candidate measurement, as the JAX package
does (the distributed tuner once per attempt on every rank).
``core/distributed_sort.py`` checks ``collective.exchange`` once per
attempt of a rank, just before the bucket exchange; the ranks agree on a
failure before any of them retries.  ``data/pipeline.py``'s prefetch
thread checks ``pipeline.producer`` before each batch it makes, as the
JAX package's does; the consumer gets the failure as a ``ProducerError``.

Two ways to arm a rule:

* ``with faults.inject("kernel.launch", on_hit=1, count=2): ...`` —
  scoped; resets the site's hit counter on entry, so ``on_hit`` is
  relative to the block.
* ``REPRO_SORT_FAULTS="kernel.launch:1:2,cache.load:1"`` — process-wide,
  parsed once (``site:on_hit[:count]``, comma-separated).

Both are deterministic: rule ``(on_hit=h, count=c)`` fails exactly hits
``h .. h+c-1`` of its site.  A seeded probabilistic mode
(``inject(site, prob=0.5, seed=7)``) uses a private ``random.Random``
per rule, so two runs with the same seed fire on the same hits.

Counters are lock-protected.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Iterator

__all__ = [
    "SITES",
    "FaultInjected",
    "check",
    "inject",
    "hits",
    "reset",
]

#: Closed registry of named fault sites.
SITES = (
    "kernel.launch",        # row-sort kernel dispatch (kernels/ops.py)
    "cache.load",           # plan-cache store read (core/autotune.py)
    "cache.save",           # plan-cache store persist (core/autotune.py)
    "autotune.measure",     # candidate measurement (core/autotune.py)
    "collective.exchange",  # all-to-all of the distributed sort (core/distributed_sort.py)
    "pipeline.producer",    # prefetch thread of the data pipeline (data/pipeline.py)
)

_ENV = "REPRO_SORT_FAULTS"


class FaultInjected(RuntimeError):
    """Raised by :func:`check` when an armed rule matches the current hit.

    Attributes:
      site: the fault-site name that fired.
      hit: the 1-based hit number at which it fired.
    """

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at site {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class _Rule:
    __slots__ = ("site", "on_hit", "count", "prob", "_rng", "fired")

    def __init__(self, site: str, on_hit: int = 1, count: int = 1,
                 prob: float | None = None, seed: int = 0):
        _validate_site(site)
        if on_hit < 1:
            raise ValueError(f"on_hit must be >= 1, got {on_hit}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if prob is not None and not (0.0 <= prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        self.site = site
        self.on_hit = on_hit
        self.count = count
        self.prob = prob
        self._rng = random.Random(seed) if prob is not None else None
        self.fired = 0

    def matches(self, hit: int) -> bool:
        if self.prob is not None:
            return self._rng.random() < self.prob
        return self.on_hit <= hit < self.on_hit + self.count


_lock = threading.RLock()
_hits: dict[str, int] = {}
_rules: list[_Rule] = []
_env_rules: list[_Rule] | None = None  # parsed lazily, invalidated by reset()


def _validate_site(site: str) -> None:
    if site not in SITES:
        raise ValueError(
            f"unknown fault site {site!r}; registered sites: {', '.join(SITES)}")


def _parse_env(spec: str) -> list[_Rule]:
    rules: list[_Rule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site = fields[0]
        try:
            on_hit = int(fields[1]) if len(fields) > 1 else 1
            count = int(fields[2]) if len(fields) > 2 else 1
        except ValueError as e:
            raise ValueError(
                f"bad {_ENV} entry {part!r}: expected site:on_hit[:count]"
            ) from e
        rules.append(_Rule(site, on_hit=on_hit, count=count))
    return rules


def check(site: str) -> None:
    """Record one hit at ``site``; raise :class:`FaultInjected` if armed.

    No-op (beyond the counter) unless a matching :func:`inject` rule or
    ``REPRO_SORT_FAULTS`` entry is active.
    """
    _validate_site(site)
    global _env_rules
    with _lock:
        if _env_rules is None:
            _env_rules = _parse_env(os.environ.get(_ENV, ""))
        hit = _hits.get(site, 0) + 1
        _hits[site] = hit
        for rule in _rules + _env_rules:
            if rule.site == site and rule.matches(hit):
                rule.fired += 1
                raise FaultInjected(site, hit)


def hits(site: str) -> int:
    """Total hits recorded at ``site`` since the last reset."""
    _validate_site(site)
    with _lock:
        return _hits.get(site, 0)


def reset() -> None:
    """Clear all hit counters, scoped rules, and the env-rule cache."""
    global _env_rules
    with _lock:
        _hits.clear()
        _rules.clear()
        _env_rules = None


@contextlib.contextmanager
def inject(site: str, *, on_hit: int = 1, count: int = 1,
           prob: float | None = None, seed: int = 0) -> Iterator[_Rule]:
    """Arm a deterministic fault at ``site`` for the duration of the block.

    The site's hit counter is reset on entry, so ``on_hit=n`` means "the
    n-th hit inside this block".  ``count`` consecutive hits fail starting
    at ``on_hit``; pass a large count to fail every hit.  ``prob``/``seed``
    switch to seeded probabilistic firing (still reproducible).  Yields the
    rule; ``rule.fired`` counts how many times it actually raised.
    """
    rule = _Rule(site, on_hit=on_hit, count=count, prob=prob, seed=seed)
    with _lock:
        _hits[site] = 0
        _rules.append(rule)
    try:
        yield rule
    finally:
        with _lock:
            _rules.remove(rule)
