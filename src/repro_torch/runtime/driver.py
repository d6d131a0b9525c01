"""Fault-tolerant training runtime.

The port's copy of the JAX package's ``runtime/driver.py``.  A step's
metrics are waited for with ``torch.cuda.synchronize`` where one is a
CUDA tensor (the reference's ``jax.block_until_ready``); the heartbeat's
``"process"`` is the ``torch.distributed`` rank, 0 without a group.

* auto-resume: state restored from the newest complete checkpoint; the
  seekable data pipeline replays from the exact step (bitwise identical
  batches), so crash -> restart converges to the same trajectory;
* async checkpoints (never blocks the step loop) + keep-k GC + atomic
  rename (no corrupt ckpts on crash mid-write);
* straggler monitor: rolling per-step stats + heartbeat file per host —
  the supervisor side of slow-host eviction at pod scale;
* elastic: ``fit_parallel_to_devices`` re-derives the mesh from the LIVE
  device count so a restart with fewer/more pods keeps running (data
  axis rescales; global batch preserved via grad-accumulation factor).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.config import ParallelConfig


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _wait_for(metrics: dict) -> None:
    """The reference's ``jax.block_until_ready`` of the step's metrics."""
    devices = {v.device for v in metrics.values()
               if isinstance(v, torch.Tensor) and v.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StragglerMonitor:
    """Rolling step-time stats + heartbeat; flags outlier steps/hosts."""

    def __init__(self, window: int = 50, z_thresh: float = 3.0,
                 heartbeat_path: str | None = None):
        self.times: deque[float] = deque(maxlen=window)
        self.z = z_thresh
        self.hb = heartbeat_path
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        is_straggler = False
        if len(self.times) >= 10:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if dt > mu + self.z * sd and dt > 1.5 * mu:
                is_straggler = True
                self.flagged.append((step, dt))
        self.times.append(dt)
        if self.hb:
            os.makedirs(os.path.dirname(self.hb) or ".", exist_ok=True)
            tmp = self.hb + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"step": step, "t": time.time(), "dt": dt,
                     "process": _process_index()}, f
                )
            os.replace(tmp, self.hb)
        return is_straggler


def fit_parallel_to_devices(p: ParallelConfig, n_devices: int) -> ParallelConfig:
    """Elastic mesh derivation: shrink/grow the data(/pod) axes to match
    the live device count, preserving the model axis."""
    import dataclasses

    shape = dict(zip(p.mesh_axes, p.mesh_shape))
    model = shape.get("model", 1)
    if n_devices % model:
        raise ValueError(f"{n_devices} devices do not divide into model axis {model}")
    rest = n_devices // model
    if "pod" in shape:
        pod = shape["pod"]
        while pod > 1 and rest % pod:
            pod //= 2
        shape["pod"], shape["data"] = pod, rest // pod
    else:
        shape["data"] = rest
    new_shape = tuple(shape[a] for a in p.mesh_axes)
    return dataclasses.replace(p, mesh_shape=new_shape)


class TrainDriver:
    """Generic fault-tolerant step loop.

    step_fn: (state, batch) -> (state, metrics dict of scalars)
    dataset: seekable (batch_at(step)) — restart replays deterministically.
    A restored state's tensors go where ``init_state_fn``'s are (the
    reference's ``state_shardings``: the port runs on one device).
    """

    def __init__(self, step_fn, init_state_fn, dataset, *, ckpt_dir: str,
                 ckpt_every: int = 100, ckpt_keep: int = 3,
                 log_every: int = 10, monitor: StragglerMonitor | None = None,
                 log_fn=print):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.dataset = dataset
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.monitor = monitor or StragglerMonitor()
        self.log = log_fn
        self.ckpt = checkpoint.AsyncCheckpointer(ckpt_dir, keep=ckpt_keep)

    def init_or_restore(self):
        """Returns (state, start_step): restores the newest checkpoint."""
        state = self.init_state_fn()
        step = checkpoint.latest_step(self.ckpt_dir)
        if step is None:
            return state, 0
        self.log(f"[runtime] resuming from checkpoint step {step}")
        state = checkpoint.restore(self.ckpt_dir, step, state)
        return state, step

    def run(self, total_steps: int, fault_injector=None):
        """Run to total_steps; returns (state, history).  fault_injector
        (step -> None|raise) simulates node failures in tests."""
        state, start = self.init_or_restore()
        history = []
        for step in range(start, total_steps):
            batch = self.dataset.batch_at(step)
            t0 = time.perf_counter()
            if fault_injector is not None:
                fault_injector(step)
            state, metrics = self.step_fn(state, batch)
            _wait_for(metrics)
            dt = time.perf_counter() - t0
            straggler = self.monitor.record(step, dt)
            if straggler:
                self.log(f"[runtime] straggler step {step}: {dt * 1e3:.1f} ms")
            if step % self.log_every == 0 or step == total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m, "dt": dt})
                self.log(f"[train] step {step} {m} ({dt * 1e3:.0f} ms)")
            if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        if self.ckpt_every and total_steps % self.ckpt_every != 0:
            checkpoint.save(self.ckpt_dir, total_steps, state)
        return state, history
