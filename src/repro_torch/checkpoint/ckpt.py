"""Checkpointing: atomic, per-leaf, keep-k, async — numpy files and json.

The JAX package's on-disk layout, so each package reads what the other
wrote:

    <dir>/step_<N>/
      manifest.json        {step, keys, dtypes, shapes}
      <flatkey>.npy        one file per leaf

A leaf's key is its path joined with "/" (``repro_torch.tree``: dict
keys sorted, tuple items by index), so the port's train state
``(params, opt_state)`` holds the reference's keys for the same state
(``0/period/slot0/moe/wg``, ``1/m/...``, ``1/step``); the file name
replaces "/" by "__".  A bfloat16 leaf is written as the reference's
numpy writes an ml_dtypes bfloat16 array: 2-byte records under the
``<V2`` descriptor, manifest dtype ``"bfloat16"``.  :func:`restore`
reads each leaf's dtype from the manifest and reinterprets those bytes
as ``torch.bfloat16``, so the port resumes a bfloat16 checkpoint, which
the reference cannot (ROADMAP.md Queue 3 R9, D22).

Fault-tolerance properties, as the reference's:
  * atomic: written into a staging directory then renamed — a crash
    mid-save never corrupts the latest checkpoint;
  * restartable: ``latest_step`` scans for complete manifests only;
  * keep-k GC after each successful save;
  * async: :class:`AsyncCheckpointer` copies the tensors to the host,
    then writes on a worker thread, so the train loop never waits on
    the disk.

:func:`restore` places every leaf on one target device; it has no
``shardings`` argument (the port's models run on one device,
ROADMAP.md Queue 3 D19).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import key as tree_key
from repro_torch.tree import leaves, map_tree, map_with_path

_BF16_DESCR = "<V2"  # what numpy writes for an ml_dtypes bfloat16 array


def _to_host(leaf):
    """A host copy of a leaf that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _write_leaf(fn: str, leaf) -> tuple[str, list[int]]:
    """Write one leaf as a .npy file; returns (manifest dtype, shape)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            with open(fn, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(t.shape)})
                t.view(torch.int16).numpy().tofile(f)
            return "bfloat16", list(t.shape)
        leaf = t.numpy()
    arr = np.asarray(leaf)
    np.save(fn, arr)
    return str(arr.dtype), list(arr.shape)


def _read_leaf(fn: str, dtype: str) -> torch.Tensor:
    arr = np.load(fn)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(path: str, step: int, tree) -> str:
    """Blocking atomic save.  Returns the final directory.

    The staging directory is unique per attempt (pid + thread id), so
    two concurrent saves of the same step never touch each other's
    files; the loser of the final rename discards its staging dir.
    """
    final = os.path.join(path, f"step_{step:08d}")
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": [], "dtypes": {}, "shapes": {}}
    for p, leaf in leaves(tree):
        key = tree_key(p)
        dtype, shape = _write_leaf(os.path.join(tmp, key.replace("/", "__") + ".npy"), leaf)
        manifest["keys"].append(key)
        manifest["dtypes"][key] = dtype
        manifest["shapes"][key] = shape
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final, ignore_errors=True)
    try:
        os.rename(tmp, final)
    except OSError:
        if not os.path.exists(os.path.join(final, "manifest.json")):
            raise  # a real failure, not a concurrent publish
        # Lost the publish race to a concurrent save of the same step
        # (same state: steps are deterministic); keep the winner's copy.
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def _complete_steps(path: str) -> list[int]:
    return sorted(
        int(n[5:]) for n in os.listdir(path)
        if n.startswith("step_") and ".tmp" not in n
        and os.path.exists(os.path.join(path, n, "manifest.json"))
    )


def latest_step(path: str) -> int | None:
    """Largest step with a COMPLETE manifest (ignores .tmp partials)."""
    if not os.path.isdir(path):
        return None
    steps = _complete_steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (a tree whose leaves have
    ``.shape``: tensors, or tensors on the "meta" device).

    Each leaf's dtype is the manifest's; it is placed on ``device``, or,
    when that is None, on the ``like`` leaf's device ("meta" and
    non-tensor leaves: the CPU).  Returns new tensors: ``like`` is not
    written.

    Raises:
        KeyError: the checkpoint lacks a leaf of ``like``.
        ValueError: a leaf's shape differs from ``like``'s.
    """
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(p, want):
        key = tree_key(p)
        if key not in manifest["dtypes"]:
            raise KeyError(f"checkpoint {d} has no leaf {key}")
        t = _read_leaf(os.path.join(d, key.replace("/", "__") + ".npy"),
                       manifest["dtypes"][key])
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(want.shape)}")
        dev = device
        if dev is None:
            dev = want.device if isinstance(want, torch.Tensor) else "cpu"
            if torch.device(dev).type == "meta":
                dev = "cpu"
        return t.to(dev)

    return map_with_path(load, like)


def gc_keep_k(path: str, keep: int, stale_tmp_secs: float = 3600.0):
    """Keep the newest ``keep`` complete checkpoints; also sweep staging
    dirs (``step_*.tmp.*``) untouched for ``stale_tmp_secs`` — orphans
    of crashed writers, whose pid-unique names nothing else reclaims."""
    if not os.path.isdir(path):
        return
    steps = _complete_steps(path)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)
    now = time.time()
    for n in os.listdir(path):
        if n.startswith("step_") and ".tmp" in n:
            p = os.path.join(path, n)
            try:
                if now - os.path.getmtime(p) > stale_tmp_secs:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass  # disappeared mid-check (its writer finished)


class AsyncCheckpointer:
    """Non-blocking checkpoints: copy to the host, write on a thread."""

    def __init__(self, path: str, keep: int = 3):
        self.path, self.keep = path, keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree):
        self.wait()  # one in flight at a time
        host_tree = map_tree(_to_host, tree)

        def work():
            try:
                save(self.path, step, host_tree)
                gc_keep_k(self.path, self.keep)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
