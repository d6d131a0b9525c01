"""Rank processes and meshes of process groups for the distributed sort.

The JAX package sorts across a device mesh inside one controller; the
port sorts across ``torch.distributed`` ranks, one process each.  This
module holds what it takes to get there:

* :func:`init_rank` joins this process to a group of ``world_size``
  ranks through a ``FileStore`` (no TCP port to pick or to collide),
  with a finite timeout, so that a rank that dies ends its peers' next
  collective with an error instead of a hang;
* :func:`make_mesh` lays the ranks out row-major over a shape with axis
  names, as the JAX package's ``launch/mesh.make_mesh`` lays out
  devices, and makes one subgroup per line of each requested axis (a
  name, or a tuple of names in mesh order) with
  ``torch.distributed.new_group``; :meth:`Mesh.group` is the calling
  rank's;
* :func:`run_ranks` starts ``world_size`` rank processes (``spawn``),
  joins them with a deadline and returns what each returned.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

#: Seconds a collective waits for its peers before it fails.
DEFAULT_TIMEOUT_S = 120.0


def init_rank(store_path: str, rank: int, world_size: int, *,
              backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world_size``,
    meeting the others at the file ``store_path``."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _axis_tuple(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the default group laid out row-major over ``shape``.

    Attributes:
        shape / names: the mesh's sizes and axis names.
        rank: this process's rank in the default group.
        groups: this rank's subgroup for every axis the mesh was made
            with, keyed by the tuple of its names.
    """

    shape: tuple[int, ...]
    names: tuple[str, ...]
    rank: int
    groups: dict = dataclasses.field(compare=False, repr=False)

    def size(self, axis) -> int:
        """Ranks along ``axis`` (a name or a tuple of names)."""
        return math.prod(self.shape[self.names.index(a)]
                         for a in _axis_tuple(axis))

    def group(self, axis):
        """This rank's process group along ``axis``; its group ranks are
        the positions along the axis, row-major over a tuple of names.

        Raises:
            KeyError: for an axis the mesh was not made with.
        """
        axt = _axis_tuple(axis)
        if axt not in self.groups:
            raise KeyError(f"mesh made without axis {axis!r}; it has "
                           f"{sorted(self.groups)}")
        return self.groups[axt]


def _line_ranks(shape, names, axt):
    """The global ranks of every line along the names ``axt``: each
    line's ranks vary the axis coordinates row-major, the others fixed."""
    along = [names.index(a) for a in axt]
    others = [i for i in range(len(shape)) if i not in along]
    for fixed in itertools.product(*(range(shape[i]) for i in others)):
        ranks = []
        for moving in itertools.product(*(range(shape[i]) for i in along)):
            coord = [0] * len(shape)
            for i, c in zip(others, fixed):
                coord[i] = c
            for i, c in zip(along, moving):
                coord[i] = c
            ranks.append(sum(c * math.prod(shape[i + 1:])
                             for i, c in enumerate(coord)))
        yield ranks


def make_mesh(shape, names, *, axes=None, backend: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Lay the default group's ranks out over ``shape`` and make the
    subgroups of ``axes`` (default: every name, and all names together).

    Every rank must call it with the same arguments: each
    ``new_group`` is collective over the default group.

    Raises:
        ValueError: when the shape does not hold every rank, names are
            missing or repeated, or an axis tuple is not in mesh order
            (the group ranks would not be the positions along it).
    """
    shape, names = tuple(int(x) for x in shape), tuple(names)
    world = dist.get_world_size()
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"make_mesh needs one distinct name per dimension, "
                         f"got shape {shape} and names {names}")
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks, the group has {world}")
    if axes is None:
        axes = [(n,) for n in names] + ([names] if len(names) > 1 else [])
    rank = dist.get_rank()
    groups = {}
    for axis in axes:
        axt = _axis_tuple(axis)
        if any(a not in names for a in axt) or len(set(axt)) != len(axt):
            raise ValueError(f"make_mesh axis {axis!r} is not a set of the "
                             f"mesh's names {names}")
        pos = [names.index(a) for a in axt]
        if pos != sorted(pos):
            raise ValueError(f"make_mesh axis {axis!r} must list names in "
                             f"mesh order {names}")
        for ranks in _line_ranks(shape, names, axt):
            g = dist.new_group(ranks, backend=backend,
                               timeout=datetime.timedelta(seconds=timeout_s))
            if rank in ranks:
                groups[axt] = g
    return Mesh(shape=shape, names=names, rank=rank, groups=groups)


def _rank_main(rank, fn, args, world_size, store_dir, backend, timeout_s):
    torch.set_num_threads(1)
    init_rank(os.path.join(store_dir, "store"), rank, world_size,
              backend=backend, timeout_s=timeout_s)
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(store_dir, f"result-{rank}.pt"))


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S,
              deadline_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined to one process group, and return their results in
    rank order.

    ``fn`` must be importable by name (a module-level function); its
    result is saved with ``torch.save`` and read back here.  Collectives
    time out after ``timeout_s``; the whole run after ``deadline_s``,
    when every rank still alive is killed.

    Raises:
        TimeoutError: past the deadline.
        torch.multiprocessing.ProcessRaisedException: a rank raised (the
            others are terminated); its traceback is in the message.
    """
    with tempfile.TemporaryDirectory() as store_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, world_size, store_dir, backend,
                              timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.0, end - time.monotonic())):
                if time.monotonic() >= end:
                    raise TimeoutError(
                        f"{world_size} ranks still running after "
                        f"{deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(store_dir, f"result-{r}.pt"),
                           weights_only=False) for r in range(world_size)]
