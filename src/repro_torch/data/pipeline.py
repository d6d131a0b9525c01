"""Data pipeline: deterministic synthetic stream + memmap shards + loader.

The port's copy of the JAX package's ``data/pipeline.py``: numpy
batches, bit for bit the reference's (the same splitmix64 on uint64),
which the training step moves to its device.  The prefetch thread
checks the fault site ``pipeline.producer`` before each batch.

Production properties:
  * deterministic & seekable — batch(step) is a pure function of (seed,
    step, shard), so restart-from-checkpoint replays the exact stream
    (no state files needed);
  * per-host sharding — each process reads only its data-parallel slice;
  * background prefetch — a double-buffered thread hides host latency;
  * fail-loud producer (DESIGN.md §11) — an exception in the prefetch
    thread is surfaced to the consumer as a structured
    :class:`ProducerError` on the next ``__next__`` (batches already
    prefetched before the failure are still delivered, in order), never
    a silent hang; ``close()`` is a deterministic, idempotent join.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core import faults


class ProducerError(RuntimeError):
    """The DataLoader's prefetch thread died; raised to the consumer.

    Attributes:
        site: the fault-site name (``"pipeline.producer"``).
        step: the dataset step the producer failed at.

    The original exception is chained as ``__cause__``.
    """

    site = "pipeline.producer"

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"data pipeline producer failed at step {step} "
            f"(site {self.site}): {type(cause).__name__}: {cause}"
        )
        self.step = step


class SyntheticDataset:
    """Deterministic hash-based token stream (infinite, seekable).

    tokens[step, i] = splitmix64(seed, step, i) % vocab — cheap,
    reproducible, and non-degenerate for throughput/loss smoke tests.
    """

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed

    def _splitmix(self, x: np.ndarray) -> np.ndarray:
        x = (x + np.uint64(0x9E3779B97F4A7C15)) * np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return x

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        n = self.batch * (self.seq_len + 1)
        base = np.uint64(self.seed) * np.uint64(0x100000001B3) + np.uint64(step)
        idx = np.arange(n, dtype=np.uint64) + base * np.uint64(n)
        toks = (self._splitmix(idx) % np.uint64(self.vocab)).astype(np.int32)
        toks = toks.reshape(self.batch, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class MemmapDataset:
    """Flat binary token file (int32), read as (batch, seq+1) windows.

    Seekable: window offsets derive from (step, shard_idx, n_shards).
    """

    def __init__(self, path: str, seq_len: int, batch: int,
                 shard_idx: int = 0, n_shards: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len, self.batch = seq_len, batch
        self.shard_idx, self.n_shards = shard_idx, n_shards
        self.n_windows = len(self.tokens) // (seq_len + 1)
        if self.n_windows < batch * n_shards:
            raise ValueError(f"{path}: {self.n_windows} windows of {seq_len + 1} "
                             f"tokens, fewer than {batch} x {n_shards} shards")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        w = self.seq_len + 1
        rows = []
        for i in range(self.batch):
            j = (step * self.batch * self.n_shards
                 + self.shard_idx * self.batch + i) % self.n_windows
            rows.append(np.asarray(self.tokens[j * w:(j + 1) * w]))
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class DataLoader:
    """Background-prefetching iterator over a seekable dataset.

    Producer failures propagate: if the prefetch thread raises, the
    already-queued batches are still delivered in order, then the next
    ``__next__`` raises :class:`ProducerError` (original exception
    chained) instead of blocking forever.  ``close()`` drains the queue
    so a blocked producer observes the stop promptly, joins the thread,
    and is idempotent; iterating a closed loader raises StopIteration.
    """

    _SENTINEL = object()  # queued after a producer error/stop: wake consumer

    def __init__(self, dataset, start_step: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.step = start_step
        self.error: ProducerError | None = None
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1) + 1)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="DataLoader-producer"
        )
        self._thread.start()

    def _worker(self):
        s = self.step
        try:
            while not self._stop.is_set():
                faults.check("pipeline.producer")
                item = (s, self.dataset.batch_at(s))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                s += 1
        except Exception as e:  # fail loud: surface on next __next__
            err = ProducerError(s, e)
            err.__cause__ = e
            self.error = err
        finally:
            # Wake a consumer blocked on get(); maxsize=prefetch+1
            # guarantees one sentinel slot beyond the prefetch depth.
            try:
                self._q.put_nowait(self._SENTINEL)
            except queue.Full:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    if self.error is not None:
                        raise self.error
                    raise StopIteration  # closed/stopped loader
                continue
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                raise StopIteration
            s, b = item
            self.step = s + 1
            return b

    def close(self):
        """Deterministic, idempotent shutdown: signal stop, drain the
        queue (a producer blocked on a full queue re-checks the stop
        flag within its put timeout), and join the thread."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
