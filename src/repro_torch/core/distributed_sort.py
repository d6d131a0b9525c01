"""Distributed deterministic sample sort over ``torch.distributed`` ranks.

Port of the JAX package's ``core/distributed_sort.py``.  There the sort
runs inside ``shard_map`` over a mesh axis under one controller; here
each rank is a process, the mesh axis is a process group
(``launch/mesh.py``), and ``lax.all_to_all`` / ``lax.all_gather`` /
``axis_index`` become ``all_to_all_single`` / ``all_gather`` / the rank
in the group.  The schedule is the reference's, step for step
(d ranks, shard length n_loc, oversample c):

  1. pad the shard to n_pad and sort it (the run plan);
  2. deal: element p of the sorted run goes to rank p mod d, one
     ``all_to_all_single``; every rank then holds a stride-d regular
     sample of every rank's data;
  3. sort the dealt run (the dealt plan);
  4. s_loc = c*d equidistant local samples, ``all_gather`` in rank order,
     the same sort of them on every rank (the sample plan), d - 1
     equidistant splitters;
  5. K3 ranks the splitters in the sorted run (``ops.splitter_ranks``);
  6. scatter the run into a (d, c_pair) buffer, one ``all_to_all_single``;
  7. sort the received buckets (the bucket plan); count and max_within.

Every static quantity comes from a :class:`~repro_torch.core.plan.ShardPlan`
(``build_shard_plan``); pads and their payloads follow the reference's
offsets, so that a rank's whole (out_cap,) output, pads included, is
bit-equal to the reference's chunk.  Key words travel as biased int32
(``core/key_codec``): the pad word 0xFFFFFFFF is 2^31 - 1 here.  The
local sorts are the single-device executor's walk
(``bucket_sort._run_node``): on CUDA tensors they launch K1 and K2, or
K5 / K6 by strategy, and step 5 launches K3; on CPU tensors the
kernels' plain versions run.

The steps that need no collective are plain functions on tensors
(:func:`pad_shard`, :func:`deal_layout`, :func:`sample_index`,
:func:`splitter_index`, :func:`chunk_destinations`,
:func:`scatter_buckets`, :func:`valid_count`), which the CPU tests hold
against the reference's jnp expressions.

**Agreement.** The reference has one controller; here d processes must
issue the same collectives in the same order, or they hang or swap data.
So the local work between two collectives runs as one step whose failure
(a kernel's error, an injected fault) every rank learns of: after each
step the ranks reduce a failure flag (MAX) over the group, and if any
rank failed, every rank raises at the same point.  The fault site
``collective.exchange`` is checked in the step before the exchange.
``make_sharded_sort``'s chain then acts on every rank alike: one logged
``"retry"``, then on CUDA tensors a ``SortRuntimeError`` (ROADMAP.md D8:
nothing on the card leaves the port's kernels), on CPU tensors the
reference's last rung, a gather of every key and one stable sort
(:func:`_degraded_host_sort`).  An error inside a collective (a peer that
died, the group's timeout) is not agreed on and propagates.

**Collectives and devices.** The collectives take the tensors on their
own device: gloo takes CUDA tensors and copies them through host memory
itself (``all_to_all_single``, ``all_gather`` and ``all_reduce``, probed
on the H100 by ``chip_smoke.py``), NCCL moves them between cards (not
run: the card is one H100, and NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import faults, guard
from repro_torch.core.bucket_sort import _launch, _run_node
from repro_torch.core.key_codec import codec_for
from repro_torch.core.plan import ShardPlan, SortPlan, build_shard_plan, shard_geometry
from repro_torch.core.sort_config import DEFAULT_CONFIG, SortConfig
from repro_torch.kernels import ops, ref

_PAD = 2**31 - 1  # biased pad word (canonical 0xFFFFFFFF)
_INT_MAX = 2**31 - 1
#: The phases a run reports to its ``phase`` hook, in order.
PHASES = ("local_sort", "deal", "resort", "samples_splitters", "k3",
          "exchange", "bucket_sort")


@dataclasses.dataclass(frozen=True)
class DistSortSpec:
    """The distributed sort's geometry as plain ints, every derived
    quantity from :func:`repro_torch.core.plan.shard_geometry` (the
    reference's ``DistSortSpec``).

    Attributes:
        axis: the mesh axis name (or tuple of names) the sort spans.
        d: ranks along the axis.
        n_local: shard length before padding.
        oversample: regular-sampling oversample factor.
        pair_align: the multiple the exchange capacity is rounded up to.
    """

    axis: str | tuple[str, ...]
    d: int
    n_local: int
    oversample: int = 8
    pair_align: int = 8

    @property
    def axis_tuple(self) -> tuple[str, ...]:
        return (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)

    @property
    def _geometry(self):
        return shard_geometry(self.n_local, self.d, self.oversample,
                              self.pair_align)

    @property
    def s_loc(self) -> int:
        return self._geometry.s_loc

    @property
    def n_pad(self) -> int:
        return self._geometry.n_pad

    @property
    def b_t(self) -> int:
        return self._geometry.b_t

    @property
    def c_pair(self) -> int:
        return self._geometry.c_pair

    @property
    def out_cap(self) -> int:
        return self._geometry.out_cap


# ----------------------------------------------------------------------
# The steps without a collective
# ----------------------------------------------------------------------


def pad_shard(kw, vals, n_pad: int, n_glob: int, me: int):
    """Step 1's padding: the shard to ``n_pad`` with pad words and the
    unique payloads ``n_glob + me*pad_n + j``, above every real one."""
    pad_n = n_pad - vals.shape[0]
    if not pad_n:
        return tuple(kw), vals
    dev = vals.device
    pk = torch.full((pad_n,), _PAD, dtype=torch.int32, device=dev)
    pv = n_glob + me * pad_n + torch.arange(pad_n, dtype=torch.int32, device=dev)
    return tuple(torch.cat([w, pk]) for w in kw), torch.cat([vals, pv])


def deal_layout(x: torch.Tensor, d: int) -> torch.Tensor:
    """Step 2's send buffer: (..., n_pad) -> contiguous (d, ..., n_pad/d),
    row j the elements at positions p = j (mod d), in order."""
    return x.reshape(*x.shape[:-1], -1, d).movedim(-1, 0).contiguous()


def sample_index(n_pad: int, s_loc: int, device=None) -> torch.Tensor:
    """Step 4: the s_loc equidistant sample positions of a sorted run,
    ``(j+1) * n_pad/s_loc - 1``."""
    j = torch.arange(1, s_loc + 1, dtype=torch.int32, device=device)
    return j * (n_pad // s_loc) - 1


def splitter_index(d: int, s_loc: int, device=None) -> torch.Tensor:
    """Step 4: the d - 1 equidistant splitter positions among the d*s_loc
    sorted samples, ``t * (d*s_loc) // d``."""
    t = torch.arange(1, d, dtype=torch.int32, device=device)
    return t * (d * s_loc) // d


def chunk_destinations(ranks: torch.Tensor, n_pad: int, c_pair: int, d: int):
    """Step 6's geometry from the splitter ranks (d - 1,) in [0, n_pad]:
    (destination of each element in the flat (d*c_pair,) buffer, with
    d*c_pair for one past its chunk's capacity; elements per target (d,);
    max_within, the largest position inside a chunk)."""
    dev = ranks.device
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    starts = torch.cat([zero, ranks])
    counts = torch.cat([ranks, zero + n_pad]) - starts
    ind = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
    ind.index_add_(0, ranks.long(), torch.ones_like(ranks))
    chunk_id = torch.cumsum(ind, 0, dtype=torch.int32)[:n_pad]
    within = torch.arange(n_pad, dtype=torch.int32, device=dev) - starts[chunk_id.long()]
    dest = torch.where(within < c_pair, chunk_id * c_pair + within, d * c_pair)
    return dest, counts, within.max()


def scatter_buckets(kw, vals, dest: torch.Tensor, d: int, c_pair: int,
                    pad_base: int):
    """Step 6's (d*c_pair,) send buffers: each element at its
    destination (one past capacity is dropped), the other slots pad words
    with payloads ``pad_base + slot``."""
    dev = vals.device
    size = d * c_pair
    idx = dest.long()
    bkw = []
    for w in kw:
        buf = torch.full((size + 1,), _PAD, dtype=torch.int32, device=dev)
        buf[idx] = w
        bkw.append(buf[:size])
    bv = pad_base + torch.arange(size + 1, dtype=torch.int32, device=dev)
    bv[idx] = vals
    return tuple(bkw), bv[:size]


def valid_count(recv_counts: torch.Tensor, fv: torch.Tensor, out_cap: int,
                n_glob: int, d: int, n_pad: int) -> torch.Tensor:
    """Step 7: the received elements less the shards' pads (payloads in
    [n_glob, n_glob + d*n_pad)), which sort after every real element."""
    head = fv[:out_cap]
    pads = ((head >= n_glob) & (head < n_glob + d * n_pad)).sum(dtype=torch.int32)
    return recv_counts.sum(dtype=torch.int32) - pads


# ----------------------------------------------------------------------
# Collectives over the group, and the agreement on failures
# ----------------------------------------------------------------------


class _StepFailed(guard.SortRuntimeError):
    """A step failed on some rank; every rank of the group raises it at
    the same point, so all of them may retry together."""


class _Comm:
    """The collectives of one run over ``group`` for tensors on
    ``device``."""

    def __init__(self, group, device):
        self.group = group
        self.d = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        self.device = device

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(d, ...) contiguous, row j for rank j -> (d, ...), row i from
        rank i."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) -> (d, ...) in rank order."""
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.d)]
        dist.all_gather(outs, x, group=self.group)
        return torch.stack(outs)

    def max(self, x: float) -> float:
        """The largest ``x`` over the group."""
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t.item())

    def any_failed(self, failed: bool) -> bool:
        """Whether ``failed`` holds on any rank."""
        return self.max(float(failed)) > 0

    def step(self, site: str, fn):
        """Run ``fn()``, then agree whether it failed on any rank; if it
        did, raise :class:`_StepFailed` on every rank (this rank's error,
        if it had one, as the cause).  Every rank must call it at the same
        point whatever happened before, so the error is caught whole."""
        err = None
        try:
            out = fn()
        except Exception as e:  # agreed on below, then raised on every rank
            err = e
        if self.any_failed(err is not None):
            detail = (f"{type(err).__name__}: {err}" if err is not None
                      else "failed on another rank")
            raise _StepFailed(site, "every rank completes the step",
                              f"rank {self.me} of {self.d}: {detail}") from err
        return out


def _no_phase(name):
    return contextlib.nullcontext()


def shard_site(plan: ShardPlan) -> str:
    """Stable human-readable identity of a shard plan for error sites."""
    return (f"ShardPlan(axis={'x'.join(plan.axis)}, d={plan.d}, "
            f"n_local={plan.n_local}, dtype={plan.dtype_name}, "
            f"strategy={plan.run_plan.root.strategy})")


def _local_sort(kw, v, sub: SortPlan, pad_base: int, site: str):
    """One per-phase local sort: the executor's walk of ``sub`` on the
    (1, L) row, cut back to L (the walk returns its padded width).  The
    walk's own pad high-water mark is not carried on: the caller adds the
    reference's fixed offsets."""
    skw, sv, _ = _run_node([tuple(w[None, :] for w in kw), v[None, :]],
                           sub.root, pad_base, None, site)
    return tuple(w[0, :sub.length] for w in skw), sv[0, :sub.length]


def _pack(kw, v) -> torch.Tensor:
    """Key words and payloads as one (nw+1, ...) tensor for a collective."""
    return torch.stack(tuple(kw) + (v,))


def sorted_shard(keys_local, vals_local: torch.Tensor, plan: ShardPlan,
                 group=None, *, phase=None):
    """One rank's part of the distributed sort: the reference's seven
    steps over ``group`` (None = the default group), every static
    quantity read off ``plan``.

    Args:
        keys_local: (n_local,) biased int32 key words, a tensor or a tuple
            of ``plan.num_words`` (most significant first).
        vals_local: (n_local,) int32 payloads, unique over the group (the
            global indices).
        plan: the schedule (:func:`repro_torch.core.plan.build_shard_plan`)
            with ``plan.d`` the group's size.
        phase: optional hook; ``phase(name)`` returns a context manager
            around each of :data:`PHASES` (``chip_smoke.py`` records CUDA
            events with it).
    Returns:
        (keys (out_cap,) in the input structure, vals (out_cap,), count,
        max_within) with count and max_within 0-d int32 tensors: the
        first ``count`` elements are this rank's part of the sorted
        sequence, the ranks' parts in rank order the whole of it.
    Raises:
        _StepFailed (a :class:`guard.SortRuntimeError`): on every rank
            alike, when a step failed on one of them.
        ValueError: for a group whose size is not ``plan.d``.
    """
    ph = phase or _no_phase
    one = isinstance(keys_local, torch.Tensor)
    kw = (keys_local,) if one else tuple(keys_local)
    dev = vals_local.device
    comm = _Comm(group, dev)
    if comm.d != plan.d:
        raise ValueError(f"the group has {comm.d} ranks, the plan d={plan.d}")
    d, n_pad, s_loc, c_pair = plan.d, plan.n_pad, plan.s_loc, plan.c_pair
    n_glob, nw, me = plan.n_glob, plan.num_words, comm.me
    site = shard_site(plan)
    # Pad payload ranges of each phase, the reference's offsets: payloads
    # are global indices < n_glob, then the shards' pads, then 4*n_glob of
    # headroom for each local sort's own pads.
    base_run = n_glob + d * n_pad
    base_dealt = base_run + 4 * n_glob
    base_sample = base_dealt + 4 * n_glob
    base_buf = base_sample + 4 * d * s_loc
    base_bucket = base_buf + d * d * c_pair

    # 1. pad, local sort
    def run_sort():
        with ph("local_sort"):
            pkw, pv = pad_shard(kw, vals_local, n_pad, n_glob, me)
            return _local_sort(pkw, pv, plan.run_plan, base_run, f"{site}/run")
    skw, sv = comm.step(site, run_sort)

    # 2. deal: one all_to_all of the (d, n_pad/d) transposed run
    with ph("deal"):
        recv = comm.all_to_all(deal_layout(_pack(skw, sv), d))
        dkw = tuple(recv[:, i].reshape(n_pad) for i in range(nw))
        dv = recv[:, nw].reshape(n_pad)
    del skw, sv, recv

    # 3. local sort of the dealt run, and its samples
    def dealt_sort():
        with ph("resort"):
            rkw, rv = _local_sort(dkw, dv, plan.dealt_plan, base_dealt,
                                  f"{site}/dealt")
            si = sample_index(n_pad, s_loc, dev).long()
            return rkw, rv, _pack(tuple(w[si] for w in rkw), rv[si])
    kw2, v2, samples = comm.step(site, dealt_sort)
    del dkw, dv

    # 4. gather the samples in rank order
    with ph("samples_splitters"):
        gathered = comm.all_gather(samples).transpose(0, 1).reshape(nw + 1, d * s_loc)
    del samples

    # 4-6. sort the samples, pick the splitters; K3; the scatter into the
    # (d, c_pair) buffer; the fault site
    def split_and_scatter():
        with ph("samples_splitters"):
            sskw, ssv = _local_sort(tuple(gathered[:nw]), gathered[nw],
                                    plan.sample_plan, base_sample,
                                    f"{site}/sample")
            spi = splitter_index(d, s_loc, dev).long()
            spkw = tuple(w[spi][None, :].contiguous() for w in sskw)
            spv = ssv[spi][None, :].contiguous()
        with ph("k3"):
            ranks = _launch(site, "splitter_ranks", ops.splitter_ranks,
                            tuple(w[None, :] for w in kw2), v2[None, :],
                            spkw, spv)[0]
        with ph("exchange"):
            dest, counts, max_within = chunk_destinations(ranks, n_pad, c_pair, d)
            bkw, bv = scatter_buckets(kw2, v2, dest, d, c_pair, base_buf)
            faults.check("collective.exchange")
            body = _pack(bkw, bv).reshape(nw + 1, d, c_pair).transpose(0, 1)
            send = torch.cat([body.reshape(d, -1), counts[:, None]], 1)
            return send.contiguous(), max_within
    send, max_within = comm.step(site, split_and_scatter)
    del kw2, v2, gathered

    # 6. the exchange: one all_to_all of (d, (nw+1)*c_pair + 1)
    with ph("exchange"):
        recv = comm.all_to_all(send)
        recv_counts = recv[:, -1]
        body = recv[:, :-1].reshape(d, nw + 1, c_pair).transpose(0, 1)
        rkw = tuple(body[i].reshape(d * c_pair) for i in range(nw))
        rv = body[nw].reshape(d * c_pair)
    del send, recv, body

    # 7. local sort of the received buckets; reals sort before pads
    def bucket_sort():
        with ph("bucket_sort"):
            fkw, fv = _local_sort(rkw, rv, plan.bucket_plan, base_bucket,
                                  f"{site}/bucket")
            oc = plan.out_cap
            count = valid_count(recv_counts, fv, oc, n_glob, d, n_pad)
            return tuple(w[:oc] for w in fkw), fv[:oc], count
    fkw, fv, count = comm.step(site, bucket_sort)
    return (fkw[0] if one else fkw), fv, count, max_within


def _degraded_host_sort(kw, plan: ShardPlan, comm: _Comm, codec):
    """The last rung of the chain on CPU tensors, the reference's: every
    rank gathers every key's words, sorts them stably on (words, global
    index) and emits its own (out_cap,) chunk; the chunk's first n_local
    slots are the sorted keys, the rest repeat its last key with payload
    2^31 - 1.  max_within is 0 (no exchange ran)."""
    n_loc, oc, me = plan.n_local, plan.out_cap, comm.me
    words = comm.all_gather(torch.stack(kw)).transpose(0, 1).reshape(len(kw), -1)
    gid = torch.arange(words.shape[1], dtype=torch.int32, device=words.device)
    order = ref.lex_order(tuple(words) + (gid,))
    mine = order[me * n_loc:(me + 1) * n_loc]
    keys = codec.decode(tuple(w[mine] for w in words))
    out_k = torch.cat([keys, keys[-1:].expand(oc - n_loc)])
    out_v = torch.full((oc,), _INT_MAX, dtype=torch.int32, device=words.device)
    out_v[:n_loc] = gid[mine]
    zero = torch.zeros((), dtype=torch.int32, device=words.device)
    return out_k, out_v, zero + n_loc, zero


def _resolve_shard_plan(group, axt, d: int, n_global: int, dtype,
                        cfg: SortConfig, oversample: int, pair_align: int,
                        device) -> ShardPlan:
    """The plan ``cfg.plan`` asks for: "default" builds it, "autotune"
    takes the measured-best plan of the group (``autotune.shard_plan_for``),
    any other string is a plan file from ``autotune.save_shard_plan``."""
    if cfg.plan == "default":
        return build_shard_plan(axt, d, n_global // d, dtype, cfg,
                                oversample=oversample, pair_align=pair_align)
    from repro_torch.core import autotune  # autotune imports this module

    if cfg.plan == "autotune":
        return autotune.shard_plan_for(
            group, axt, n_global, dtype, cfg, oversample=oversample,
            pair_align=pair_align, device=device)
    return autotune.load_shard_plan(cfg.plan, axis=axt, d=d,
                                    n_local=n_global // d, dtype=dtype, cfg=cfg)


def make_sharded_sort(group, n_global: int, cfg: SortConfig = DEFAULT_CONFIG,
                      oversample: int = 8, *, dtype=torch.int32,
                      pair_align: int = 8, axis="data", device=None):
    """A distributed argsort over the ranks of ``group``: each rank calls
    it, then ``run`` on its shard.

    Args:
        group: the process group the sort spans (None = the default
            group); d = its size.  It stands for the reference's mesh.
        n_global: keys over all ranks; a multiple of d.
        cfg: the local sorts' knobs; ``cfg.descending`` flips the order;
            ``cfg.plan`` is "default", "autotune" (the plan the group
            measured fastest, ``autotune.shard_plan_for``) or a shard-plan
            file (``autotune.save_shard_plan``).
        oversample: regular-sampling oversample factor (power of two).
        dtype: the keys' dtype (any codec dtype).
        pair_align: the multiple the exchange capacity is rounded up to.
        axis: mesh axis name or tuple of names, the plan's identity only.
        device: where "autotune" measures (None = "cuda").
    Returns:
        (run, plan): ``run(keys_local)`` takes this rank's (n_local,)
        shard (rank r holds global indices [r*n_local, (r+1)*n_local)) on
        the device of the sort, and returns this rank's (keys (out_cap,),
        int32 payloads (out_cap,), count, max_within): the first
        ``count`` keys, ranks in order, are the stably sorted sequence,
        their payloads the global indices.  ``run.last_stats`` is
        {"degraded", "retries"} of the last call.  ``run`` takes a
        keyword ``phase`` (see :func:`sorted_shard`).
    Raises:
        ValueError: naming the argument: a group of fewer than 2 ranks,
            ``n_global`` not a multiple of d or past the int32 payload
            budget, a bad ``oversample`` / ``pair_align`` (from the plan);
            ``run`` for keys of another dtype or length.
    """
    axt = (axis,) if isinstance(axis, str) else tuple(axis)
    d = dist.get_world_size(group)
    if d < 2:
        raise ValueError(
            f"make_sharded_sort group (axis {axis!r}) spans d={d} rank(s); "
            "need d >= 2 (use bucket_sort.sort on a single device)")
    if n_global % d != 0:
        raise ValueError(
            f"make_sharded_sort n_global ({n_global}) must be divisible by "
            f"the axis device count d={d}")
    if n_global * 16 >= 2**31:
        raise ValueError(
            f"make_sharded_sort n_global ({n_global}) exceeds the int32 "
            f"payload budget (n_global * 16 < 2**31, i.e. n_global <= "
            f"{2**27}): per-phase pad ranges are drawn from the int32 "
            "payload space")
    plan = _resolve_shard_plan(group, axt, d, n_global, dtype, cfg,
                               oversample, pair_align, device)
    return shard_runner(plan, group), plan


def shard_runner(plan: ShardPlan, group=None):
    """``run`` of :func:`make_sharded_sort` for a plan in hand (the
    autotuner times its candidates with it): :func:`sorted_shard` behind
    the codec and the degradation chain, on every rank alike.

    The chain: an attempt; if a step failed on some rank, one logged
    ``"retry"`` at ``collective.exchange[D=d]`` on every rank; if that
    fails too, on CUDA tensors a ``SortRuntimeError`` naming the site and
    the plan (ROADMAP.md D8), on CPU tensors the reference's rung,
    :func:`_degraded_host_sort`, logged as a ``"fallback"``.
    """
    codec = codec_for(plan.dtype_name, plan.descending)
    me = dist.get_rank(group)
    n_loc = plan.n_local
    site = f"collective.exchange[D={plan.d}]"

    def run(keys_local: torch.Tensor, *, phase=None):
        name = codec_for(keys_local.dtype).dtype_name
        if name != plan.dtype_name:
            raise ValueError(
                f"keys dtype {name} does not match the shard plan's dtype "
                f"{plan.dtype_name} (pass dtype= to make_sharded_sort)")
        if tuple(keys_local.shape) != (n_loc,):
            raise ValueError(f"keys_local must be this rank's ({n_loc},) "
                             f"shard, got shape {tuple(keys_local.shape)}")
        kw = codec.encode(keys_local)
        gid = me * n_loc + torch.arange(n_loc, dtype=torch.int32,
                                        device=keys_local.device)

        def attempt():
            fkw, fv, count, mw = sorted_shard(kw, gid, plan, group, phase=phase)
            return codec.decode(fkw), fv, count, mw

        try:
            out = attempt()
            run.last_stats = {"degraded": False, "retries": 0}
            return out
        except _StepFailed as e1:
            guard.record_degradation(site, "retry", "mesh execution",
                                     "mesh execution (retry)", e1)
            first = e1
        try:
            out = attempt()
            run.last_stats = {"degraded": False, "retries": 1}
            return out
        except _StepFailed as e2:
            if keys_local.is_cuda:
                raise guard.SortRuntimeError(
                    f"{site}:{shard_site(plan)}", e2.invariant,
                    f"failed on the run and on its retry: {e2.detail}",
                ) from first
            guard.record_degradation(site, "fallback", "mesh execution",
                                     "gather-to-host degraded sort", e2)
        out = _degraded_host_sort(kw, plan, _Comm(group, keys_local.device),
                                  codec)
        run.last_stats = {"degraded": True, "retries": 1}
        return out

    run.last_stats = {"degraded": False, "retries": 0}
    return run
