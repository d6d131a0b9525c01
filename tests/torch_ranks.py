"""Rank processes of the distributed sort's CPU tests.

``repro_torch.launch.mesh.run_ranks`` starts each function here in
``world`` spawned processes on one gloo group; the processes import this
module by name, so it imports neither JAX nor the test files.  Inputs
come from an ``.npz`` the test wrote; each rank returns numpy arrays.
"""

from __future__ import annotations

import collections
import contextlib
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

GEOMETRY = dict(tile=256, s=16, direct_max=512)
SPECIALS = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, 1.5, -1.5]


def make_input(dtype: str, dist_name: str, n: int, rng) -> np.ndarray:
    """The JAX package's conformance inputs (``tests/test_distributed.py``):
    full-range ints or normal floats (spiked with NaN, +-inf, -0.0 here),
    all equal, zipf-skewed, or sorted with 1 % of neighbours swapped."""
    if np.issubdtype(np.dtype(dtype), np.floating):
        base = (rng.standard_normal(n) * 1e6).astype(dtype)
        base[rng.integers(0, n, len(SPECIALS))] = SPECIALS
    else:
        info = np.iinfo(dtype)
        base = rng.integers(info.min, info.max, n, dtype=np.int64).astype(dtype)
    if dist_name == "uniform":
        return base
    if dist_name == "equal":
        return np.full(n, base[0], dtype)
    if dist_name == "zipf":
        return (rng.zipf(1.5, n) % 100000).astype(dtype)
    if dist_name == "nearly-sorted":
        x = np.sort(base)
        idx = rng.integers(0, n - 1, n // 100)
        x[idx], x[idx + 1] = x[idx + 1].copy(), x[idx].copy()
        return x
    raise KeyError(dist_name)


@contextlib.contextmanager
def counted_launches():
    """Count the kernel dispatcher calls (one launch each on the card) by
    kernel, as ``tests/test_torch_strategy.py`` does; a call that hands a
    kernel a strided tensor (the kernels take contiguous rows only) is
    counted under "strided" instead."""
    from repro_torch.core.plan import SORTERS
    from repro_torch.kernels import ops

    calls = collections.Counter()
    names = ("sort_tiles", "sort_tiles_sample", "splitter_partition",
             "splitter_ranks")
    real = {name: getattr(ops, name) for name in names}

    def spy(name):
        def call(*args, **kwargs):
            kernel = (SORTERS[kwargs.get("strategy", "bitonic")]
                      if name.startswith("sort_tiles") else name)
            tensors = [t for a in args
                       for t in (a if isinstance(a, tuple) else (a,))]
            contiguous = all(t.is_contiguous() for t in tensors)
            calls[kernel if contiguous else "strided"] += 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ops, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def cell_id(name: str, desc: bool) -> str:
    return f"{name}-{'desc' if desc else 'asc'}"


def _sort_one(group, d, pos, x, cfg, axis, oversample=8):
    """One distributed sort of ``x`` (this rank's shard of it); returns
    the outputs as numpy and whether the launches equal the plan's walk."""
    from repro_torch.core import guard
    from repro_torch.core.distributed_sort import make_sharded_sort
    from repro_torch.core.plan import plan_launches

    n = len(x)
    t = torch.from_numpy(x)
    run, plan = make_sharded_sort(group, n, cfg, oversample, dtype=t.dtype,
                                  axis=axis, device="cpu")
    nl = n // d
    guard.clear_degradation_log()
    with counted_launches() as calls:
        k, v, c, mw = run(t[pos * nl:(pos + 1) * nl])
    return dict(
        keys=k.numpy(), vals=v.numpy(), count=int(c), max_within=int(mw),
        c_pair=plan.c_pair, out_cap=plan.out_cap,
        launches_equal=calls == plan_launches(plan),
        log=[e.action for e in guard.degradation_log()],
        events=[(e.site, e.action, e.frm, e.to) for e in guard.degradation_log()],
        stats=dict(run.last_stats),
    )


def run_key(axis, name: str, desc: bool, strategy: str = "bitonic") -> str:
    """The result key of a cell sorted along ``axis``."""
    axt = (axis,) if isinstance(axis, str) else tuple(axis)
    key = f"{'x'.join(axt)}/{cell_id(name, desc)}"
    return key if strategy == "bitonic" else f"{key}/{strategy}"


def sort_cells(rank, world, spec):
    """The cells of ``spec["runs"]`` ((axis, [(input name in
    ``spec["data"]``, descending)][, local-sort strategy])), each sorted
    along its axis of the
    mesh ``spec["mesh"]`` ((shape, names); None: the default group,
    axis "data"), by :func:`run_key`.  Then each cell of
    ``spec.get("degraded", [])`` over the default group with
    ``collective.exchange`` failing on rank 0, which takes the CPU's last
    rung (key "degraded/<cell>")."""
    from repro_torch.core import faults
    from repro_torch.core.sort_config import SortConfig
    from repro_torch.launch.mesh import make_mesh

    data = np.load(spec["data"])
    mesh = None
    if spec.get("mesh") is not None:
        mesh = make_mesh(*spec["mesh"], axes=[r[0] for r in spec["runs"]])
    out = {}
    for axis, cells, *strategy in spec["runs"]:
        strategy = strategy[0] if strategy else "bitonic"
        group, d, pos = None, world, rank
        if mesh is not None:
            group = mesh.group(axis)
            d, pos = mesh.size(axis), dist.get_rank(group)
        for name, desc in cells:
            cfg = SortConfig(**GEOMETRY, descending=desc, strategy=strategy)
            out[run_key(axis, name, desc, strategy)] = _sort_one(
                group, d, pos, data[name], cfg, axis)
    for name, desc in spec.get("degraded", []):
        cfg = SortConfig(**GEOMETRY, descending=desc)
        arm = (faults.inject("collective.exchange", on_hit=1, count=10**6)
               if rank == 0 else contextlib.nullcontext())
        with warnings.catch_warnings(), arm:
            warnings.simplefilter("ignore")
            out[f"degraded/{cell_id(name, desc)}"] = _sort_one(
                None, world, rank, data[name], cfg, "data")
    return out


def fault_chain(rank, world, spec):
    """``collective.exchange`` armed on rank ``spec["fault_rank"]`` only,
    for each hit count of ``spec["counts"]`` in turn; then one call with
    no fault."""
    from repro_torch.core import faults
    from repro_torch.core.sort_config import SortConfig

    x = np.load(spec["data"])[spec["cell"]]
    cfg = SortConfig(**GEOMETRY)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for count in spec["counts"]:
            arm = (faults.inject("collective.exchange", on_hit=1, count=count)
                   if rank == spec["fault_rank"] else contextlib.nullcontext())
            with arm:
                out[count] = _sort_one(None, world, rank, x, cfg, "data")
                out[count]["hits"] = faults.hits("collective.exchange")
        out["healed"] = _sort_one(None, world, rank, x, cfg, "data")
    return out


def tune(rank, world, spec):
    """``SortConfig(plan="autotune")`` against a fresh store, a warm call,
    a lookup from the store after the memo is cleared, and a plan file;
    ``autotune.measure`` armed once on rank 1 during the cold tune."""
    from repro_torch.core import autotune, faults
    from repro_torch.core.plan import shard_plan_json
    from repro_torch.core.sort_config import SortConfig

    os.environ["REPRO_TORCH_SORT_PLAN_CACHE"] = spec["store"]
    x = np.load(spec["data"])[spec["cell"]]
    measured = []
    real = autotune._measure_shard_candidate

    def spy(run, xs, label, comm, **kw):
        measured.append(label)
        return real(run, xs, label, comm, **kw)

    autotune._measure_shard_candidate = spy
    cfg = SortConfig(**GEOMETRY, plan="autotune")
    arm = (faults.inject("autotune.measure", on_hit=1) if rank == 1
           else contextlib.nullcontext())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with arm:
            cold = _sort_one(None, world, rank, x, cfg, "data")
    from repro_torch.core.distributed_sort import make_sharded_sort

    n = len(x)
    dtype = torch.from_numpy(x).dtype
    _, plan = make_sharded_sort(None, n, cfg, dtype=dtype, device="cpu")
    n_cold = len(measured)
    _, warm = make_sharded_sort(None, n, cfg, dtype=dtype, device="cpu")
    autotune.clear_memo()
    _, stored = make_sharded_sort(None, n, cfg, dtype=dtype, device="cpu")
    path = os.path.join(os.path.dirname(spec["store"]), "shard_plan.json")
    if rank == 0:
        autotune.save_shard_plan(plan, path, meta={"note": "test"})
    dist.barrier()
    from_file = SortConfig(**GEOMETRY, plan=path)
    filed = _sort_one(None, world, rank, x, from_file, "data")
    _, file_plan = make_sharded_sort(None, n, from_file, dtype=dtype,
                                     device="cpu")
    return dict(
        cold=cold, filed=filed, plan=shard_plan_json(plan),
        measured=measured[:n_cold], later_measured=measured[n_cold:],
        warm_same=warm is plan, stored_equal=stored == plan,
        file_equal=file_plan == plan,
    )


def validation(rank, world, spec):
    """The messages of make_sharded_sort's ValueErrors, and of the run's."""
    from repro_torch.core.distributed_sort import make_sharded_sort
    from repro_torch.core.sort_config import SortConfig

    cfg = SortConfig(**GEOMETRY)
    singles = [dist.new_group([r]) for r in range(world)]
    cases = {
        "single": lambda: make_sharded_sort(singles[rank], 1024, cfg),
        "divisible": lambda: make_sharded_sort(None, 1001, cfg),
        "budget": lambda: make_sharded_sort(None, 2**27, cfg),
        "oversample": lambda: make_sharded_sort(None, 2048, cfg, 5),
        "pair_align": lambda: make_sharded_sort(None, 2048, cfg, pair_align=4),
    }
    run, _ = make_sharded_sort(None, 2048, cfg, device="cpu")
    cases["dtype"] = lambda: run(torch.zeros(1024, dtype=torch.float32))
    cases["shape"] = lambda: run(torch.zeros(1000, dtype=torch.int32))
    out = {}
    for name, fn in cases.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def card_sort(rank, world, spec):
    """On the card (every rank on cuda:0): the cells of ``spec["cells"]``
    ((input name, descending)) under ``DEFAULT_CONFIG``, with the kernel
    launches counted; then, if ``spec["fault"]``, one call with
    ``collective.exchange`` failing on rank 0 at every hit, which must
    raise a SortRuntimeError on every rank without a host sort or a
    library sort."""
    from repro_torch.core import distributed_sort, faults, guard
    from repro_torch.core.plan import plan_launches
    from repro_torch.core.sort_config import SortConfig
    from repro_torch.kernels import ops

    dev = spec.get("device", "cuda")  # "cpu" rehearses it off the card
    if dev == "cuda":
        torch.cuda.set_device(0)
    data = np.load(spec["data"])
    out = {}
    for name, desc in spec["cells"]:
        x = data[name]
        n = len(x)
        nl = n // world
        shard = torch.from_numpy(x[rank * nl:(rank + 1) * nl]).to(dev)
        run, plan = distributed_sort.make_sharded_sort(
            None, n, SortConfig(descending=desc), dtype=shard.dtype)
        with counted_launches() as calls:
            ops.reset_launch_counts()
            k, v, c, mw = run(shard)
            if dev == "cuda":
                torch.cuda.synchronize()
                calls = collections.Counter(
                    {k_: c_ for k_, c_ in ops.launch_counts().items() if c_})
        out[cell_id(name, desc)] = dict(
            keys=k.cpu().numpy(), vals=v.cpu().numpy(), count=int(c),
            max_within=int(mw), c_pair=plan.c_pair,
            launches_equal=calls == plan_launches(plan))
    if spec.get("fault"):
        name = spec["cells"][0][0]
        x = data[name]
        nl = len(x) // world
        shard = torch.from_numpy(x[rank * nl:(rank + 1) * nl]).to(dev)
        run, plan = distributed_sort.make_sharded_sort(None, len(x),
                                                       dtype=shard.dtype)
        calls = []
        real_sort, real_host = torch.sort, distributed_sort._degraded_host_sort
        torch.sort = lambda *a, **k: calls.append("torch.sort") or real_sort(*a, **k)
        distributed_sort._degraded_host_sort = (
            lambda *a, **k: calls.append("host") or real_host(*a, **k))
        arm = (faults.inject("collective.exchange", on_hit=1, count=10**6)
               if rank == 0 else contextlib.nullcontext())
        guard.clear_degradation_log()
        error = None
        try:
            with warnings.catch_warnings(), arm:
                warnings.simplefilter("ignore")
                run(shard)
        except guard.SortRuntimeError as e:
            error = dict(type=type(e).__name__, site=e.site, message=str(e))
        finally:
            torch.sort, distributed_sort._degraded_host_sort = real_sort, real_host
        out["fault"] = dict(error=error, calls=calls,
                            log=[e.action for e in guard.degradation_log()])
    return out
