#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the deterministic sample sort on one card.

Usage (from the root of a checkout, on a machine with an NVIDIA card):

    python3 chip_smoke.py

It builds the six CUDA kernels from ``src/repro_torch/kernels/csrc``
(K1 tile sort, K2 splitter partition, K3 splitter ranks, K4 row top-k,
K5 radix sort, K6 merge sort) and then

1. holds each kernel bit for bit against its plain PyTorch version on
   the card, at the row widths, word counts, sample and splitter counts
   of the main path (rows capped to 2^22 elements per check; K1 also at
   every power-of-two T from 2 to 16384, one and two words, 0 or 64
   samples, on permutation and on full-range payloads; K2 also at T in
   {2, 32}, one window; K3 on sorted and on unsorted tiles, and on one
   tile of 2^22, which it splits across CTAs; K4 at every power-of-two
   width from 1 to 16384 columns, one and two words, k in {1, min(8, C),
   C}, with the last CTA's rows partly masked; K5 and K6 also at T in
   {2, 64, 4096, 8192, 16384}, one and two words, 0 or 64 samples,
   radix_bits 1, 2, 4 and merge_run 64, 512, and at every power-of-two
   T, 0 or 64 samples by turns, radix_bits 1, 2, 4 and merge_run 2, 64,
   512 and 16384, on duplicate keys with arange payloads, on random keys
   and payloads, and on duplicate keys with random payloads, which only a
   stable sort on the key words alone gets right), and at a main-path
   shape, which is also timed;
2. drives the main path through the public entry points on seeded
   numpy data, fifteen cases: ``sort`` / ``argsort`` 2^26 int32,
   ``argsort`` 2^24 float32 with NaN / +-inf / -0.0, ``sort_kv`` 2^24
   int64, ``sort_batched`` (256, 65536) int32, ``sort`` 2^24 int32 with
   ``fuse_ranking=False``, ``topk_batched`` (256, 151936) float32 k=50,
   ``topk`` 2^24 float32 k=1024, ``ops.topk`` of (65536, 128) k=8 and
   (65536, 64) k=6 router probabilities; then with the radix and merge
   strategies: ``sort`` 2^26 int32 with the probe's config (radix),
   ``sort_kv`` 2^24 int64 with radix_bits=2, ``sort`` 2^24 nearly
   sorted int32 with the probe's config (merge), ``argsort`` 2^24
   float64 with NaN / +-inf / -0.0 (merge) and the serving
   ``topk_batched`` (radix); checks each result against stable
   ``torch.sort`` on the card (descending for top-k, whose ties go to
   the smaller index), and counts the kernel launches, which must equal
   the launches the plans call for;
3. times each entry point (median of CUDA-event-timed runs) beside
   ``torch.sort`` or ``torch.topk``, with the peak device memory, and
   profiles the 2^26 sort (bitonic and radix) and the batched top-k;
4. drives the paths of guarded execution, the segmented sort, the
   paper's baselines and the autotuner, each a JSON line:
   - segmented: ``segment_sort`` / ``segment_argsort`` of CSR column
     indices (65,536 rows of 0 to 512 entries, empty and one-entry rows
     included) and of 64 segments of 2^16 to 2^18 keys, against one
     stable ``torch.sort`` of (segment, key), timed, with the peak;
   - checked: the 2^26 int32 sort with ``check`` "bounds" and "full",
     equal to and timed beside ``check="off"``, and the serving
     ``topk_batched`` with ``check="full"``;
   - faults: a 2^20 sort under an injected ``kernel.launch`` fault,
     once (one logged retry, the correct result) and twice (a
     ``SortRuntimeError`` naming the node and the kernel), and a plan
     whose capacity is shrunk below the fills under ``check="bounds"``
     (a ``SortRuntimeError``), with no library sort called;
   - the paper's comparison: 2^26 int32 keys under seven distributions,
     the deterministic sort (time, top round's largest bucket fill
     against its capacity), the randomized sample sort (capacity factor
     4, four attempts and one), ``merge_sort`` at 2^24 and stable
     ``torch.sort``, then each one's spread of time over the
     distributions;
   - autotune: the cost model and the plan autotuner.  The 11
     candidates of the space around ``DEFAULT_CONFIG`` at 2^26 int32
     keys, each run once (checked against stable ``torch.sort``, its
     peak memory read) and timed by the tuner (medians of 3 after a
     warm-up), a line each with its predicted cost, channels, levels and
     peak; then Spearman rho of predicted against measured, the measured
     winner and whether it is among the five cheapest predicted or the
     base, and a least-squares fit of the cost model's constants
     (``FIT_GRID``).  The same space at 2^24 int64, held out: rho with
     the committed constants.  Then ``sort(x, SortConfig(plan="autotune"))``
     at 2^20 and 2^26 int32 against a fresh store in a temporary
     directory: the cold call's seconds, the candidates it measured, the
     winner, ``best_us`` / ``default_us`` / ``speedup``, a warm call with
     no measurement and the same plan object, a ``save_plan`` /
     ``plan=<path>`` round trip, no library sort in any of them, and the
     time and peak memory of the winner beside the default plan's;
   - distributed: ``make_sharded_sort`` over D in {2, 4} rank processes
     sharing this card in one gloo group (met through a ``FileStore``,
     with a finite timeout and a deadline on the join; gloo takes the
     CUDA tensors and copies them through host memory, which
     ``gloo_cuda_probe`` confirms first): 2^26 int32 keys over D = 4 and
     D = 2, 2^24 int64 over D = 4, 2^24 float32 descending with NaN /
     +-inf / -0.0 over D = 2.  Each run is gathered here and held
     against stable ``torch.sort`` on the card (the ranks' valid prefixes
     in rank order, the payloads its permutation, counts summing to n,
     max_within below c_pair, every rank's launches the ShardPlan's walk)
     and timed: the last rank's wall (median of 3 after the counted run),
     per-phase ms from CUDA events (the max over ranks), the exchange
     bytes and peak memory of a rank, beside the single-process ``sort``
     of the same keys.  Then ``collective.exchange`` armed on rank 1
     only, once (every rank logs a retry, the result is right) and at
     every hit (every rank raises a ``SortRuntimeError``), and
     ``SortConfig(plan="autotune")`` at 2^24 int32 over D = 2 against a
     fresh store (the candidates measured, the winner, the same on every
     rank, a warm call, a plan file).  These are ranks sharing one card,
     not a multi-GPU result;
   - serving: ``qwen3-moe-30b-a3b`` at full width and depth (48 layers,
     d_model 2048, 128 experts top-8, 30,079,649,792 parameters drawn
     on the card from ``--seed`` in bfloat16) through
     ``launch/serve.generate``: 8 requests of 1,024 ``default_rng(0)``
     prompt tokens prefilled (8,192 tokens, 65,536 routed slots), 15
     decode steps, 16 tokens sampled at top-k 8, temperature 0.8, TF32
     off.  First layer 0's router ids and dispatch permutation against a
     stable descending ``torch.sort`` and ``torch.argsort(stable=True)``;
     then one serve with each dispatch ("sample_sort": K4 router, the
     sample sort's K1 and K2 for the dispatch; "xla_sort" and "onehot":
     library sort, one-hot rank), each with its launches held to the
     plans (K1 912, K2 48, K3 16, K4 768 for "sample_sort"; K1 48, K3
     16 for the others: the sampler's), every logit finite and every
     token in the padded vocab, a ``{"serving": ...}`` line each (cold
     init s, prefill ms, decode ms a token, peak GB, launches, the
     router's, dispatch's and sampler's ms from CUDA events around them
     and their share); the three prefill logits and token sequences
     must be bit-identical, and the sampler's ``topk_batched`` of the
     prefill logits equal ``kernels/ref.topk_desc``.  The model is
     freed; then the smoke config (float32, the same weights on both
     devices) through prefill and 4 greedy decode steps on the card and
     on the CPU: logits within 1e-4, the same tokens;
   - training: ``qwen3-moe-30b-a3b`` at full width, its depth cut from 48
     to 4 layers (3,077,588,992 parameters drawn on the card from
     ``--seed`` in bfloat16, float32 moments, ``remat="full"``,
     ``dispatch="sample_sort"``, TF32 off), trained through
     ``launch/train``'s parts (``build_train_step``, ``TrainDriver``,
     ``SyntheticDataset(seed=0)``, AdamW with 6 total and 1 warmup
     steps) on 2 x 4,096 tokens a step (65,536 routed slots, capacity
     768): a straight run of 6 steps, every loss finite, the launches
     held to the plans (K4 8, K1 24, K2 8 a step: each MoE layer's
     router and dispatch sort in the forward and again in the recompute;
     no library sort), a ``{"training": ...}`` line (step ms from CUDA
     events, the median of the steps after the first, tokens/s, peak
     GB, the forward's, backward's and optimizer's ms and share, the
     router's and dispatch's ms a step and their share, the launches,
     losses and gradient norms) and a ``{"training_profile": ...}`` line
     of one more step; then a run stopped after its step-3 checkpoint
     (30.8 GB, in a temporary directory) and a new driver that resumes
     from it to step 6: the resumed step's loss bit-equal to the
     straight run's, the later ones within 1e-3; step 0 with "xla_sort"
     and "onehot" from the same weights: the loss bit-identical, the
     gradient norm within 1e-4; ``python -m repro_torch.launch.train
     --arch qwen3-moe-30b-a3b --smoke --steps 20 --batch 8 --seq 128`` in
     a subprocess on the card, its last loss finite; and the smoke
     config's one train step on the card against the CPU from the same
     weights: the loss within 1e-5, the parameters within 2 lr;
   every run of these paths has its kernel launches counted, and they
   must be those its plan calls for;
5. prints the script's wall time, then a JSON line of per-kernel numbers
   (a kernel's and its library call's ``ms``, one call between two
   events, the host's time to launch it included; ``device_ms`` and
   ``library_device_ms``, the device's time per launch over 20 launches
   that it runs back to back; the radix_sort row also K5's digit width,
   ``digit_bits``; ``launches`` over every counted run), the card's name
   and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the last line;
it also exits non-zero when CUDA is not available.

    python3 chip_smoke.py --memory

runs the memory probe instead: the peak device memory of every step of
one 2^26 int32 ``sort`` (tile sort, relocation, direct sort, compaction,
by level), then ``sort`` of growing n, each checked against
``torch.sort``, until one runs out of device memory; the largest n that
fits is the last line before the device line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM: 3.35 TB/s of HBM3 (NVIDIA data sheet); 132 SMs x 64 INT32
# lanes x 1.98 GHz = 16.7e12 int32 operations/s (Hopper white paper).
BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CHECK_ELEMENTS = 1 << 22
# Every power-of-two row width the row sorts take (2 to 16384): each puts
# K1's and K6's in-thread, shuffle and shared-memory strides elsewhere.
WIDTHS = [1 << k for k in range(1, 15)]


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def per_launch_ms(fn, launches: int = 20, reps: int = 3) -> float:
    """Device time of one launch, in ms: the median over ``reps`` of CUDA
    events around ``launches`` back-to-back calls, enqueued behind a spin
    of the device (``torch.cuda._sleep``) that outlasts their enqueueing,
    so that the device runs them back to back whatever the host's time to
    launch one (the wrappers' Python), which this leaves out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_s = (time.perf_counter() - t0) / launches
    torch.cuda.synchronize()
    # 2e9 cycles a second covers the card's clock; thrice the host's time.
    spin = int(3 * host_s * launches * 2e9) + 1000
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs, expected {len(want)}")
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    return err


def flat(out):
    """Flatten a kernel result ((words...), vals[, (words...), vals])."""
    res = []
    for x in out:
        res.extend(x if isinstance(x, tuple) else (x,))
    return res


def random_tiles(m, t, nw, gen):
    """(m, T) key words with many ties and a per-row payload permutation."""
    words = tuple(
        torch.randint(-(2**31), 2**31 - 1, (m, t), generator=gen,
                      device="cuda", dtype=torch.int32) >> (28 if i == 0 else 0)
        for i in range(nw)
    )
    vals = torch.argsort(torch.rand((m, t), generator=gen, device="cuda"),
                         dim=1).to(torch.int32)
    return words, vals


def duplicate_tiles(m, t, nw, gen):
    """(m, T) key words below 16 (canonical: biased words from -2^31)
    and arange payloads, the pipeline's payload order."""
    words = tuple(
        torch.randint(0, 16, (m, t), generator=gen, device="cuda",
                      dtype=torch.int32) ^ -(2**31)
        for _ in range(nw)
    )
    vals = torch.arange(t, dtype=torch.int32, device="cuda").repeat(m, 1)
    return words, vals


def full_range(m, t, gen):
    """(m, T) int32 over the whole range, repeats allowed."""
    return torch.randint(-(2**31), 2**31 - 1, (m, t), generator=gen,
                         device="cuda", dtype=torch.int32)


def random_rows(m, t, nw, gen):
    """(m, T) random key words and random payloads, repeats allowed."""
    words = tuple(
        torch.randint(-(2**31), 2**31 - 1, (m, t), generator=gen,
                      device="cuda", dtype=torch.int32)
        for _ in range(nw + 1)
    )
    return words[:-1], words[-1]


def real_splitters(tkw, tv, samp_kw, samp_v, num_splitters, ref):
    """The pipeline's splitters for one row of m sorted tiles: the sorted
    samples' equidistant elements, repeated for every tile."""
    m = tv.shape[0]
    sk, sv = ref.sort_tiles_kv(tuple(w.reshape(1, -1) for w in samp_kw),
                               samp_v.reshape(1, -1))
    total = sv.shape[1]
    idx = torch.arange(1, num_splitters + 1, device="cuda") * total // (
        num_splitters + 1)
    return (
        tuple(w[:, idx].repeat_interleave(m, 0).contiguous() for w in sk),
        sv[:, idx].repeat_interleave(m, 0).contiguous(),
    )


def check_kernels(launch_shapes, gen):
    """Each kernel vs its plain version on the card, bit for bit.

    ``launch_shapes`` holds (kernel, rows, T, samples / splitters / k,
    key words, radix_bits or merge_run) of the main path's launches."""
    from repro_torch.kernels import bitonic, ref, splitter, topk

    main_k1 = {(t, nw, s) for k, _, t, s, nw, _ in launch_shapes
               if k == "tile_sort"}
    k1 = main_k1 | {(t, nw, s) for t in WIDTHS for nw in (1, 2)
                    for s in (0, min(64, t))}
    k2 = {(t, nw, s) for k, _, t, s, nw, _ in launch_shapes
          if k == "splitter_partition"}
    # Tiles no wider than K2's window of 32, which is then the whole tile.
    k2 |= {(t, nw, s) for t, s in ((2, 1), (32, 7)) for nw in (1, 2)}
    for (t, nw, s), payloads in itertools.product(
            sorted(k1), ("permutation", "full_range")):
        m = max(1, (CHECK_ELEMENTS if (t, nw, s) in main_k1
                    else CHECK_ELEMENTS // 4) // t)
        words, vals = random_tiles(m, t, nw, gen)
        if payloads == "full_range":
            vals = full_range(m, t, gen)
        if s:
            got = bitonic.sort_tiles_sample_kv(words, vals, num_samples=s)
        else:
            got = bitonic.sort_tiles_kv(words, vals)
        torch.cuda.synchronize()
        pw, pv = bitonic.bitonic_network_rows(words, vals)
        want = (pw, pv)
        if s:
            want += (tuple(bitonic.take_samples(w, s) for w in pw),
                     bitonic.take_samples(pv, s))
        err = max_abs_err(flat(got), flat(want))
        print(f"K1 tile_sort T={t} nw={nw} samples={s} {payloads} payloads: "
              f"max_abs_err={err}")
        if err:
            raise AssertionError("K1 disagrees with its plain version")
    for t, nw, s in sorted(k2):
        m = max(1, CHECK_ELEMENTS // t)
        tkw, tv, skw, sv = bitonic.sort_tiles_sample_kv(
            *random_tiles(m, t, nw, gen), num_samples=min(64, t))
        spw, spv = real_splitters(tkw, tv, skw, sv, s, ref)
        got = splitter.splitter_partition_cuda(tkw, tv, spw, spv)
        torch.cuda.synchronize()
        err = max_abs_err(got, splitter.splitter_partition(tkw, tv, spw, spv))
        print(f"K2 splitter_partition T={t} nw={nw} S={s}: max_abs_err={err}")
        if err:
            raise AssertionError("K2 disagrees with its plain version")
    k3 = {(t, nw, s) for k, _, t, s, nw, _ in launch_shapes if k == "splitter_ranks"}
    for t, nw, s in sorted(k3):
        m = max(1, CHECK_ELEMENTS // t)
        words, vals = random_tiles(m, t, nw, gen)
        # Unsorted tiles with unsorted splitters drawn from them (ties),
        # payloads moved by -1, 0 or 1; then K1-sorted tiles with the
        # pipeline's splitters.
        pick = torch.randint(0, t, (m, s), generator=gen, device="cuda")
        unsorted = (words, vals, tuple(torch.gather(w, 1, pick) for w in words),
                    torch.gather(vals, 1, pick) + torch.randint(
                        -1, 2, (m, s), generator=gen, device="cuda",
                        dtype=torch.int32))
        tkw, tv, skw, sv = bitonic.sort_tiles_sample_kv(
            words, vals, num_samples=min(64, t))
        for order, args in (("unsorted", unsorted),
                            ("sorted", (tkw, tv) + real_splitters(
                                tkw, tv, skw, sv, s, ref))):
            got = splitter.splitter_ranks_cuda(*args)
            torch.cuda.synchronize()
            err = max_abs_err((got,), (splitter.splitter_ranks(*args),))
            print(f"K3 splitter_ranks T={t} nw={nw} S={s} {order} tiles: "
                  f"max_abs_err={err}")
            if err:
                raise AssertionError("K3 disagrees with its plain version")
    check_k3_split(gen)
    k4 = {(c, nw, k) for c in [1] + WIDTHS for nw in (1, 2)
          for k in (1, min(8, c), c)}
    k4 |= {(t, nw, s) for k, _, t, s, nw, _ in launch_shapes if k == "topk"}
    for c, nw, k in sorted(k4):
        # A row count that leaves the last CTA's rows partly masked.
        words, _ = random_tiles(max(1, CHECK_ELEMENTS // c) + 3, c, nw, gen)
        got = topk.topk_desc_cuda(words, k)
        torch.cuda.synchronize()
        err = max_abs_err(flat(got), flat(topk.topk_desc(words, k)))
        print(f"K4 topk C={c} nw={nw} k={k}: max_abs_err={err}")
        if err:
            raise AssertionError("K4 disagrees with its plain version")
    check_row_sorters(launch_shapes, gen)


def check_k3_split(gen):
    """K3 on one tile of 2^22 elements, which it cuts across CTAs, with 7
    splitters: unsorted tiles with unsorted splitters drawn from them, and
    the tile sorted (by the oracle: no row sort takes 2^22) with them
    sorted."""
    from repro_torch.kernels import ref, splitter

    t, s = CHECK_ELEMENTS, 7
    if splitter.ranks_geometry(1, t)[0] < 2:
        raise AssertionError("K3 does not split a lone tile of 2^22")
    for nw in (1, 2):
        words, vals = random_tiles(1, t, nw, gen)
        pick = torch.randint(0, t, (1, s), generator=gen, device="cuda")
        sk, sv = ref.sort_tiles_kv(words, vals)
        spick = torch.sort(pick, dim=1).values
        for order, args in (
            ("unsorted", (words, vals, tuple(torch.gather(w, 1, pick) for w in words),
                          torch.gather(vals, 1, pick))),
            ("sorted", (sk, sv, tuple(torch.gather(w, 1, spick) for w in sk),
                        torch.gather(sv, 1, spick))),
        ):
            got = splitter.splitter_ranks_cuda(*args)
            torch.cuda.synchronize()
            err = max_abs_err((got,), (splitter.splitter_ranks(*args),))
            print(f"K3 splitter_ranks one tile T={t} nw={nw} S={s} {order}, "
                  f"split: max_abs_err={err}")
            if err:
                raise AssertionError("K3 disagrees with its plain version")


def row_sorter(kernel):
    """(wrapper, sample wrapper, plain version, knob name) of K5 or K6."""
    from repro_torch.kernels import merge, radix

    if kernel == "radix_sort":
        return radix.sort_tiles_kv, radix.sort_tiles_sample_kv, \
            radix.radix_sort_rows, "radix_bits"
    return merge.sort_tiles_kv, merge.sort_tiles_sample_kv, \
        merge.merge_sort_rows, "merge_run"


def check_row_sorters(launch_shapes, gen):
    """K5 and K6 bit for bit against their plain versions, at every
    (T, key words, samples, knob) the main path launches them with and on
    a grid: at T in {2, 64, 4096, 8192, 16384}, one and two words, 0 or
    64 samples, radix_bits 1, 2, 4 and merge_run 64, 512; and at every
    power-of-two T from 2 to 16384, one and two words, 0 or 64 samples by
    turns, radix_bits 1, 2, 4 (K5 ranks 8-bit digits whatever it says)
    and merge_run 2, 64, 512 and 16384 (at least T: K6 is then K1).
    Data: keys below 16 with arange payloads, random keys and payloads
    (both plain versions are defined for any payload), and keys below 16
    with random payloads, which only a stable sort (K5) or a merge (K6)
    on the key words alone gets right."""
    from repro_torch.kernels import bitonic

    first = [(t, nw, s) for t in (2, 64, 4096, 8192, bitonic.MAX_TILE)
             for nw in (1, 2) for s in (0, min(64, t))]
    knobs = {"radix_sort": ((1, 2, 4), (1, 2, 4)),
             "merge_sort": ((64, 512), (2, 64, 512, bitonic.MAX_TILE))}
    grids = {
        kernel: sorted(
            {x + (knob,) for x in first for knob in first_knobs}
            | {(t, nw, min(64, t) * (k % 2), knob)
               for k, t in enumerate(WIDTHS) for nw in (1, 2)
               for knob in width_knobs})
        for kernel, (first_knobs, width_knobs) in knobs.items()
    }
    for kernel, grid in grids.items():
        wrap, wrap_sample, plain, knob_name = row_sorter(kernel)
        main = {(t, nw, s, knob) for k, _, t, s, nw, knob in launch_shapes
                if k == kernel}
        datas = ("duplicates", "random", "duplicates_random_payloads")
        for t, nw, s, knob in sorted(main) + grid:
            m = max(1, (CHECK_ELEMENTS if (t, nw, s, knob) in main
                        else CHECK_ELEMENTS // 4) // t)
            for data in datas:
                words, vals = (random_rows if data == "random"
                               else duplicate_tiles)(m, t, nw, gen)
                if data == "duplicates_random_payloads":
                    vals = full_range(m, t, gen)
                kw = {knob_name: knob}
                got = (wrap_sample(words, vals, num_samples=s, **kw) if s
                       else wrap(words, vals, **kw))
                torch.cuda.synchronize()
                pw, pv = plain(words, vals, **kw)
                want = (pw, pv)
                if s:
                    want += (tuple(bitonic.take_samples(w, s) for w in pw),
                             bitonic.take_samples(pv, s))
                err = max_abs_err(flat(got), flat(want))
                print(f"{kernel} T={t} nw={nw} samples={s} {knob_name}={knob} "
                      f"{data}: max_abs_err={err}")
                if err:
                    raise AssertionError(f"{kernel} disagrees with its plain version")


def measure_k1(m, t, nw, s, gen):
    """K1 at one main-path shape: the error, the launch to time, the plain
    version's ms, the library call to time (or None), bytes, operations."""
    from repro_torch.kernels import bitonic

    words, vals = random_tiles(m, t, nw, gen)
    got = bitonic.sort_tiles_sample_kv(words, vals, num_samples=s)
    pw, pv = bitonic.bitonic_network_rows(words, vals)
    want = (pw, pv, tuple(bitonic.take_samples(w, s) for w in pw),
            bitonic.take_samples(pv, s))
    err = max_abs_err(flat(got), flat(want))
    del pw, pv, want
    run = functools.partial(bitonic.sort_tiles_sample_kv, words, vals,
                            num_samples=s)
    plain_ms = time_ms(lambda: bitonic.bitonic_network_rows(words, vals), 2)
    library = None
    if nw == 1:
        composite = (words[0].long() << 32) | vals.long()
        library = functools.partial(torch.sort, composite, dim=1)
    nbytes = 4 * (nw + 1) * (2 * m * t + m * s)
    # Any comparison sort of T distinct elements needs log2(T!) compares
    # per row, one operation each at least (not the bitonic network's
    # own T/2 * log2 T * (log2 T + 1) / 2 compare-exchanges).
    ops = m * math.lgamma(t + 1) / math.log(2)
    return err, run, plain_ms, library, nbytes, ops


def measure_row_sorter(kernel, m, t, nw, s, knob, gen):
    """K5 or K6 at K1's main-path shape, with K1's bound and library call,
    on K1's random tiles with arange payloads (the pipeline's order)."""
    from repro_torch.kernels import bitonic

    _, wrap_sample, plain, knob_name = row_sorter(kernel)
    kw = {knob_name: knob}
    words, _ = random_tiles(m, t, nw, gen)
    vals = torch.arange(t, dtype=torch.int32, device="cuda").repeat(m, 1)
    got = wrap_sample(words, vals, num_samples=s, **kw)
    pw, pv = plain(words, vals, **kw)
    want = (pw, pv, tuple(bitonic.take_samples(w, s) for w in pw),
            bitonic.take_samples(pv, s))
    err = max_abs_err(flat(got), flat(want))
    del got, pw, pv, want
    run = functools.partial(wrap_sample, words, vals, num_samples=s, **kw)
    plain_ms = time_ms(lambda: plain(words, vals, **kw), 1)
    composite = (words[0].long() << 32) | vals.long()
    library = functools.partial(torch.sort, composite, dim=1)
    nbytes = 4 * (nw + 1) * (2 * m * t + m * s)
    ops = m * math.lgamma(t + 1) / math.log(2)  # as K1: the same work
    return err, run, plain_ms, library, nbytes, ops


def measure_k2(m, t, nw, num_splitters, gen):
    """K2 at one main-path shape, on K1-sorted tiles with real splitters."""
    from repro_torch.kernels import bitonic, ref, splitter

    tkw, tv, skw, sv = bitonic.sort_tiles_sample_kv(
        *random_tiles(m, t, nw, gen), num_samples=64)
    spw, spv = real_splitters(tkw, tv, skw, sv, num_splitters, ref)
    err = max_abs_err(splitter.splitter_partition_cuda(tkw, tv, spw, spv),
                      splitter.splitter_partition(tkw, tv, spw, spv))
    run = functools.partial(splitter.splitter_partition_cuda, tkw, tv, spw, spv)
    plain_ms = time_ms(lambda: splitter.splitter_partition(tkw, tv, spw, spv), 1)
    library = None
    if nw == 1:
        tiles = (tkw[0].long() << 32) | tv.long()
        sps = (spw[0].long() << 32) | spv.long()
        library = functools.partial(torch.searchsorted, tiles, sps)
    s = num_splitters
    probes = m * s * int(math.log2(t))
    nbytes = 4 * ((nw + 1) * m * s + m * s + m * (s + 1) + (nw + 1) * probes)
    ops = probes * 2 * (nw + 1)  # a compare and an equality per word
    return err, run, plain_ms, library, nbytes, ops


def measure_k3(m, t, nw, num_splitters, gen):
    """K3 at one main-path shape, on K1-sorted tiles with real splitters
    (the partial sort's inputs)."""
    from repro_torch.kernels import bitonic, ref, splitter

    tkw, tv, skw, sv = bitonic.sort_tiles_sample_kv(
        *random_tiles(m, t, nw, gen), num_samples=64)
    spw, spv = real_splitters(tkw, tv, skw, sv, num_splitters, ref)
    args = (tkw, tv, spw, spv)
    err = max_abs_err((splitter.splitter_ranks_cuda(*args),),
                      (splitter.splitter_ranks(*args),))
    run = functools.partial(splitter.splitter_ranks_cuda, *args)
    plain_ms = time_ms(lambda: splitter.splitter_ranks(*args), 1)
    library = None
    if nw == 1:
        tiles = (tkw[0].long() << 32) | tv.long()
        sps = (spw[0].long() << 32) | spv.long()
        library = functools.partial(torch.searchsorted, tiles, sps)
    s = num_splitters
    # The contract allows unsorted tiles, so the whole tile is read once.
    nbytes = 4 * ((nw + 1) * m * t + (nw + 1) * m * s + m * s)
    # Locating each element among S sorted splitters takes at least
    # ceil(log2(S + 1)) compares.
    ops = m * t * math.ceil(math.log2(s + 1))
    return err, run, plain_ms, library, nbytes, ops


def measure_k4(r, c, nw, k, gen):
    """K4 at one main-path shape (router rows of c experts, top-k)."""
    from repro_torch.kernels import topk

    words, _ = random_tiles(r, c, nw, gen)
    err = max_abs_err(flat(topk.topk_desc_cuda(words, k)),
                      flat(topk.topk_desc(words, k)))
    run = functools.partial(topk.topk_desc_cuda, words, k)
    plain_ms = time_ms(lambda: topk.topk_desc(words, k), 2)
    library = None
    if nw == 1:  # timing only: torch.topk's tie order is its own
        library = functools.partial(torch.topk, words[0], k, dim=1, largest=False)
    nbytes = 4 * (nw * r * c + (nw + 1) * r * k)
    ops = r * (c - 1)  # the k smallest of c need at least c - 1 compares
    return err, run, plain_ms, library, nbytes, ops


def kernel_table():
    """(name, measure, shape, source, replaces) of each kernel's timed
    launch: K1 and K2 at the top-level shape of the 2^26 int32 sort, K3 at
    the serving top-k's tiles, K4 at the 128-expert router's rows; K5 and
    K6 at K1's shape, with the default radix_bits and merge_run."""
    from repro_torch.core import DEFAULT_CONFIG, build_plan, build_topk_plan

    top = build_plan(1 << 26, torch.int32, DEFAULT_CONFIG).root
    serve = build_topk_plan(151_936, 50, torch.float32, DEFAULT_CONFIG, rows=256)
    k1_shape = (top.rows * top.m, top.tile, 1, top.s)
    return [
        ("tile_sort", measure_k1, k1_shape,
         "src/repro_torch/kernels/csrc/tile_sort.cu",
         "src/repro/kernels/bitonic.py:275"),
        ("splitter_partition", measure_k2,
         (top.rows * top.m, top.tile, 1, top.s_round - 1),
         "src/repro_torch/kernels/csrc/splitter_partition.cu",
         "src/repro/kernels/splitter.py:161"),
        ("splitter_ranks", measure_k3,
         (serve.rows * serve.m, serve.tile, 1, serve.s - 1),
         "src/repro_torch/kernels/csrc/splitter_ranks.cu",
         "src/repro/kernels/splitter.py:69"),
        ("topk", measure_k4, (65536, 128, 1, 8),
         "src/repro_torch/kernels/csrc/topk.cu",
         "src/repro/kernels/topk.py:41"),
        ("radix_sort", functools.partial(measure_row_sorter, "radix_sort"),
         k1_shape + (DEFAULT_CONFIG.radix_bits,),
         "src/repro_torch/kernels/csrc/radix_sort.cu",
         "src/repro/kernels/radix.py:168"),
        ("merge_sort", functools.partial(measure_row_sorter, "merge_sort"),
         k1_shape + (DEFAULT_CONFIG.merge_run,),
         "src/repro_torch/kernels/csrc/merge_sort.cu",
         "src/repro/kernels/merge.py:102"),
    ]


def kernel_row(kernel, measure, shape, source, replaces, gen, launches):
    """One kernel's entry of the kernels line: checked against its plain
    version, timed beside it and beside its library call, with its bound.
    ``ms`` and ``library_ms`` are one call between two events, the host's
    time to launch it included; ``device_ms`` and ``library_device_ms``
    the device's time per launch (:func:`per_launch_ms`)."""
    err, run, plain_ms, library, nbytes, nops = measure(*shape, gen)
    if err:
        raise AssertionError(f"{kernel} disagrees with its plain version")
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    ops_ms = nops / INT32_OPS_PER_S * 1e3
    row = {
        "name": kernel, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "equal": err == 0, "max_abs_err": err,
        "shape": list(shape), "ms": time_ms(run, 10),
        "device_ms": per_launch_ms(run), "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": time_ms(library, 10) if library else None,
        "library_device_ms": per_launch_ms(library) if library else None,
    }
    if kernel == "radix_sort":  # the kernel's own digit width at this shape
        from repro_torch.kernels import radix

        row["digit_bits"] = radix.radix_geometry(*shape[:3]).digit_bits
    return row


def device_profile(fn, top_n=15) -> dict:
    """Device time by kernel over one run of fn() after a warm-up, and
    the device's idle share of the run's wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}  # device-side events only (kernels, copies, memsets)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = (e.self_device_time_total / 1e3, e.count)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if by_kernel else "not measured",
        "device_idle_share": 1 - device_ms / wall_ms if by_kernel else None,
        "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                for k, (ms, c) in top],
    }


def profile_main_path(case):
    """:func:`device_profile` of one run of a main-path case."""
    dev_args = tuple(a.cuda() for a in case.args)
    print(json.dumps({"profile": case.name,
                      **device_profile(lambda: case.fn(*dev_args))}))


def memory_by_step(x):
    """Peak device memory of each step of one ``sort`` of x.

    Wraps the executor's step functions for the one call: before a step
    the allocator's peak is reset, after it the peak and what was held
    when the step began are read.
    """
    from repro_torch.core import bucket_sort
    from repro_torch.kernels import ops

    steps = []
    watched = (
        (ops, "sort_tiles_sample",
         lambda kw, vals, **_: f"tile sort + samples {tuple(vals.shape)}"),
        (bucket_sort, "_relocate_gather",
         lambda *a: f"relocate -> ({a[5] * a[7]}, {a[9]})"),
        (bucket_sort, "_direct_sort",
         lambda data, node, _: f"direct sort ({node.rows}, {node.lp})"),
        (bucket_sort, "_compact_gather",
         lambda *a: f"compact -> ({a[3]}, {a[5]})"),
    )
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in watched]

    def watch(fn, label):
        def step(*args, **kwargs):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            steps.append({"step": label(*args, **kwargs), "held_bytes": held,
                          "peak_bytes": torch.cuda.max_memory_allocated()})
            return out
        return step

    for (mod, name, label), (_, _, fn) in zip(watched, originals):
        setattr(mod, name, watch(fn, label))
    try:
        base = torch.cuda.memory_allocated()
        out = bucket_sort.sort(x)
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    if not torch.equal(out, torch.sort(x, stable=True).values):
        raise AssertionError("memory probe: sort differs from torch.sort")
    for st in steps:
        st["peak_bytes_above_input"] = st["peak_bytes"] - base
        print(json.dumps({"memory_step": st}))


def memory_ceiling(sizes, gen):
    """``sort`` of int32 keys of each size in turn, checked against
    torch.sort, until one runs out of device memory.  Returns the
    largest size that fit (0 if none)."""
    from repro_torch.core import bucket_sort

    fit = 0
    for n in sizes:
        x = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen,
                          device="cuda", dtype=torch.int32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            out = bucket_sort.sort(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        except torch.cuda.OutOfMemoryError as e:
            # The probe's answer, not a failure: n does not fit the card.
            print(json.dumps({"memory_ceiling": {
                "n": n, "fits": False, "error": str(e).splitlines()[0]}}))
            break
        peak = torch.cuda.max_memory_allocated()
        if not torch.equal(out, torch.sort(x, stable=True).values):
            raise AssertionError(f"memory probe: sort of {n} differs")
        print(json.dumps({"memory_ceiling": {
            "n": n, "fits": True, "peak_bytes_above_input": peak - base,
            "wall_ms_first_call": ms}}))
        fit = n
        del x, out
        torch.cuda.empty_cache()
    return fit


Case = collections.namedtuple("Case", "name fn args check library launches")


def bf16_ties(a: np.ndarray) -> torch.Tensor:
    """float32 scores rounded to bfloat16 precision: many ties, and no
    NaN or -0.0 (the CPU tests cover those)."""
    return torch.from_numpy(a).to(torch.bfloat16).float()


def main_path_cases(rng):
    """The main-path runs, with data from rng: for each, the entry point,
    its arguments, check(out, *args) against stable torch.sort, the
    library call timed beside it and the launches its plan calls for
    (kernel, rows, width, samples / splitters / k, key words, radix_bits
    or merge_run)."""
    from repro_torch.core import (
        DEFAULT_CONFIG,
        SortConfig,
        build_plan,
        build_topk_plan,
        bucket_sort,
        codec_for,
        partial_sort,
        probe,
    )
    from repro_torch.core.plan import kernel_launches, topk_launches
    from repro_torch.kernels import ops

    def shape2(x):
        return (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)

    def knob(kernel, cfg):
        return {"radix_sort": cfg.radix_bits,
                "merge_sort": cfg.merge_run}.get(kernel, 0)

    def sort_launches(x, cfg=DEFAULT_CONFIG):
        rows, length = shape2(x)
        nw = codec_for(x.dtype).num_words
        plan = build_plan(length, x.dtype, cfg, rows=rows)
        return [ln + (nw, knob(ln[0], cfg))
                for ln in kernel_launches(plan.root)]

    def partial_launches(x, k, cfg=DEFAULT_CONFIG):
        rows, length = shape2(x)
        nw = codec_for(x.dtype).num_words
        tplan = build_topk_plan(length, k, x.dtype, cfg, rows=rows)
        return [ln + (nw, knob(ln[0], cfg)) for ln in topk_launches(tplan)]

    def router_launches(x, k):
        r, c = x.shape
        return [("topk", r, 1 << (c - 1).bit_length(), k,
                 codec_for(x.dtype).num_words, 0)]

    def probed(x, strategy):
        # The probe's pick for x, which the case asserts.
        cfg = probe.probed_config(x)
        if cfg.strategy != strategy:
            raise AssertionError(f"probe picked {cfg.strategy!r}, not {strategy!r}")
        return cfg

    n26, n24 = 1 << 26, 1 << 24
    x32 = torch.from_numpy(rng.integers(-(2**31), 2**31, n26, dtype=np.int32))
    f32 = rng.standard_normal(n24).astype(np.float32)
    special = rng.integers(0, n24, 4 * (n24 // 100))
    f32[special[0::4]] = np.nan
    f32[special[1::4]] = np.inf
    f32[special[2::4]] = -np.inf
    f32[special[3::4]] = -0.0
    f32[: n24 // 100] = 0.0  # ties between -0.0 and +0.0 too
    xf = torch.from_numpy(f32)
    x64 = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n24,
                                        dtype=np.int64))
    v64 = torch.from_numpy(rng.standard_normal(n24).astype(np.float32))
    xb = torch.from_numpy(rng.integers(0, 1000, (256, 65536), dtype=np.int32))
    # Ties: 2^24 keys from 2^20 values.
    xu = torch.from_numpy(rng.integers(0, 1 << 20, n24, dtype=np.int32))
    # Logits of a decode batch at the Qwen2 / Qwen3 vocab, and one long
    # column of scores.
    logits = bf16_ties(rng.standard_normal((256, 151_936), dtype=np.float32))
    column = bf16_ties(rng.standard_normal(n24, dtype=np.float32))
    # Router probabilities of a 64K-token prefill batch: 128 experts
    # (Qwen3-MoE-30B-A3B, top-8) and 64 experts (Moonlight, top-6).
    probs128 = bf16_ties(torch.softmax(torch.from_numpy(
        rng.standard_normal((65536, 128), dtype=np.float32)), 1).numpy())
    probs64 = bf16_ties(torch.softmax(torch.from_numpy(
        rng.standard_normal((65536, 64), dtype=np.float32)), 1).numpy())
    unfused = SortConfig(fuse_ranking=False)
    # Appending to an already sorted column (time-series keys): ascending
    # int32 with 1 % of the positions swapped with their right neighbour.
    near = np.arange(n24, dtype=np.int32)
    swap = rng.integers(0, n24 - 1, n24 // 100)
    near[swap], near[swap + 1] = near[swap + 1], near[swap]
    xn = torch.from_numpy(near)
    f64 = rng.standard_normal(n24)
    special = rng.integers(0, n24, 4 * (n24 // 100))
    f64[special[0::4]] = np.nan
    f64[special[1::4]] = np.inf
    f64[special[2::4]] = -np.inf
    f64[special[3::4]] = -0.0
    f64[: n24 // 100] = 0.0
    xf64 = torch.from_numpy(f64)
    radix_probed = probed(x32, "radix")
    merge_probed = probed(xn, "merge")
    radix2 = SortConfig(strategy="radix", radix_bits=2)
    merge_cfg = SortConfig(strategy="merge")
    radix_cfg = SortConfig(strategy="radix")

    def total_order(x):
        # float32 / float64 total order (NaN last, -0.0 < +0.0) as an
        # integer key of the same width.
        i = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
        return torch.where(i < 0, i ^ torch.iinfo(i.dtype).max, i)

    def check_total_order(out, x):
        return torch.equal(out.long(), torch.sort(total_order(x), stable=True).indices)

    def sort_probed(x):
        return bucket_sort.sort(x, probe.probed_config(x))

    def check_sort(out, x):
        return torch.equal(out, torch.sort(x, stable=True).values)

    def check_argsort(out, x):
        return torch.equal(out.long(), torch.sort(x, stable=True).indices)

    def library_kv(x, v):
        ref = torch.sort(x, stable=True)
        return ref.values, v[ref.indices]

    def check_kv(out, x, v):
        want = library_kv(x, v)
        return torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])

    def check_topk(k):
        # Stable descending order breaks ties toward the smaller index.
        def check(out, x):
            want = torch.sort(x, dim=-1, descending=True, stable=True)
            return (torch.equal(out[0], want.values[..., :k])
                    and torch.equal(out[1].long(), want.indices[..., :k]))
        return check

    def topk_case(name, fn, x, k, launches, *cfg):
        return Case(name, lambda a: fn(a, k, *cfg), (x,), check_topk(k),
                    lambda a: torch.topk(a, k, dim=-1), launches(x, k, *cfg))

    return [
        Case("sort int32 2^26", bucket_sort.sort, (x32,), check_sort,
             lambda x: torch.sort(x, stable=True), sort_launches(x32)),
        Case("argsort int32 2^26", bucket_sort.argsort, (x32,), check_argsort,
             lambda x: torch.sort(x, stable=True), sort_launches(x32)),
        Case("argsort float32 2^24 NaN/inf/-0.0", bucket_sort.argsort, (xf,),
             check_total_order, lambda x: torch.sort(x, stable=True),
             sort_launches(xf)),
        Case("sort_kv int64 2^24", bucket_sort.sort_kv, (x64, v64), check_kv,
             library_kv, sort_launches(x64)),
        Case("sort_batched int32 (256, 65536)", bucket_sort.sort_batched, (xb,),
             lambda out, x: torch.equal(
                 out, torch.sort(x, dim=1, stable=True).values),
             lambda x: torch.sort(x, dim=1, stable=True), sort_launches(xb)),
        Case("sort int32 2^24 fuse_ranking=False",
             lambda x: bucket_sort.sort(x, unfused), (xu,), check_sort,
             lambda x: torch.sort(x, stable=True), sort_launches(xu, unfused)),
        topk_case("topk_batched float32 (256, 151936) k=50",
                  partial_sort.topk_batched, logits, 50, partial_launches),
        topk_case("topk float32 2^24 k=1024", partial_sort.topk, column, 1024,
                  partial_launches),
        topk_case("ops.topk float32 (65536, 128) k=8", ops.topk, probs128, 8,
                  router_launches),
        topk_case("ops.topk float32 (65536, 64) k=6", ops.topk, probs64, 6,
                  router_launches),
        # The radix and merge strategies (K5, K6), two picked by the probe.
        Case("sort int32 2^26 probed: radix", sort_probed, (x32,), check_sort,
             lambda x: torch.sort(x, stable=True), sort_launches(x32, radix_probed)),
        Case("sort_kv int64 2^24 radix radix_bits=2",
             lambda x, v: bucket_sort.sort_kv(x, v, radix2), (x64, v64),
             check_kv, library_kv, sort_launches(x64, radix2)),
        Case("sort int32 2^24 nearly sorted probed: merge", sort_probed, (xn,),
             check_sort, lambda x: torch.sort(x, stable=True),
             sort_launches(xn, merge_probed)),
        Case("argsort float64 2^24 NaN/inf/-0.0 merge",
             lambda x: bucket_sort.argsort(x, merge_cfg), (xf64,),
             check_total_order, lambda x: torch.sort(x, stable=True),
             sort_launches(xf64, merge_cfg)),
        topk_case("topk_batched float32 (256, 151936) k=50 radix",
                  partial_sort.topk_batched, logits, 50, partial_launches,
                  radix_cfg),
    ]


def counted(fn, totals):
    """Run fn() with the launch counts set to 0 just before it and read
    just after; add them to ``totals``.  Returns (result, counts)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for k, c in counts.items():
        totals[k] += c
    return out, counts


def expect_launches(name, counts, want):
    got = {k: c for k, c in counts.items() if c}
    want = {k: c for k, c in want.items() if c}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, plan {want}")


@contextlib.contextmanager
def library_sorts(calls):
    """Count every call of torch's sorts and top-k while the block runs."""
    patched = [(owner, name, getattr(owner, name))
               for owner in (torch, torch.Tensor)
               for name in ("sort", "argsort", "topk", "msort")
               if hasattr(owner, name)]

    def wrap(fn, name):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for owner, name, fn in patched:
        setattr(owner, name, wrap(fn, name))
    try:
        yield calls
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)


def timed_with_peak(fn, reps=3):
    """(median ms, peak device bytes above what was held before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(fn, reps)
    return ms, torch.cuda.max_memory_allocated() - base


def segmented_phase(rng, totals):
    """segment_sort / segment_argsort against one stable torch.sort of the
    (segment, key) composite, which sorts each segment stably."""
    from repro_torch.core import DEFAULT_CONFIG, bucket_sort, build_plan
    from repro_torch.core.plan import plan_launches

    csr = rng.integers(0, 513, 65536)
    csr[:4] = (0, 1, 0, 512)  # empty, one-entry and full rows for sure
    cases = (
        ("CSR column indices: 65536 rows of 0-512", csr,
         lambda n: rng.integers(0, 1 << 20, n, dtype=np.int32)),
        ("64 segments of 2^16-2^18 keys", rng.integers(1 << 16, (1 << 18) + 1, 64),
         lambda n: rng.integers(-(2**31), 2**31, n, dtype=np.int32)),
    )
    for name, lens, keys in cases:
        off = np.concatenate([[0], np.cumsum(lens)])
        n = int(off[-1])
        x = torch.from_numpy(keys(n)).cuda()
        seg = torch.repeat_interleave(torch.arange(len(lens), device="cuda"),
                                      torch.from_numpy(lens).cuda())

        def library():
            return torch.sort((seg << 32) | (x.long() + 2**31), stable=True)

        want = library().indices
        plan = build_plan(int(lens.max()), torch.int32, DEFAULT_CONFIG,
                          rows=len(lens))
        t0 = time.perf_counter()
        bucket_sort._segment_layout(n, off)  # the host's share of a call
        layout_ms = (time.perf_counter() - t0) * 1e3
        perm, counts = counted(lambda: bucket_sort.segment_argsort(x, off), totals)
        expect_launches(f"segment_argsort {name}", counts, plan_launches(plan))
        out, counts = counted(lambda: bucket_sort.segment_sort(x, off), totals)
        expect_launches(f"segment_sort {name}", counts, plan_launches(plan))
        if not (torch.equal(perm.long(), want) and torch.equal(out, x[want])):
            raise AssertionError(f"segmented {name}: differs from torch.sort")
        del perm, out, want
        ms, peak = timed_with_peak(lambda: bucket_sort.segment_sort(x, off))
        arg_ms, arg_peak = timed_with_peak(
            lambda: bucket_sort.segment_argsort(x, off))
        print(json.dumps({
            "segmented": name, "n": n, "segments": len(lens),
            "longest": int(lens.max()), "empty": int((lens == 0).sum()),
            "plan_levels": plan.num_levels, "equal": True, "launches": counts,
            "ms": ms, "mkeys_per_s": n / ms / 1e3,
            "peak_bytes_above_input": peak,
            "argsort_ms": arg_ms, "argsort_peak_bytes_above_input": arg_peak,
            "library_ms": time_ms(library, 3), "host_layout_ms": layout_ms,
        }))


def checked_phase(x32, logits, totals):
    """The 2^26 int32 sort with check "bounds" and "full" against "off",
    and the serving top-k with check "full"."""
    from repro_torch.core import (
        DEFAULT_CONFIG,
        SortConfig,
        bucket_sort,
        build_plan,
        build_topk_plan,
        guard,
        partial_sort,
    )
    from repro_torch.core.plan import plan_launches, topk_launches

    guard.clear_degradation_log()
    x = x32.cuda()
    base = bucket_sort.sort(x)
    if not torch.equal(base, torch.sort(x, stable=True).values):
        raise AssertionError("checked phase: sort differs from torch.sort")
    off_ms = time_ms(lambda: bucket_sort.sort(x), 3)
    plan = build_plan(x.shape[0], x.dtype, DEFAULT_CONFIG)
    for check in ("bounds", "full"):
        cfg = SortConfig(check=check)
        out, counts = counted(lambda: bucket_sort.sort(x, cfg), totals)
        expect_launches(f"sort check={check}", counts, plan_launches(plan))
        if not torch.equal(out, base):
            raise AssertionError(f"sort with check={check} differs from off")
        del out
        ms, peak = timed_with_peak(lambda: bucket_sort.sort(x, cfg))
        print(json.dumps({
            "checked": "sort int32 2^26", "check": check, "equal": True,
            "ms": ms, "off_ms": off_ms, "check_ms": ms - off_ms,
            "peak_bytes_above_input": peak}))
    del x, base
    y = logits.cuda()
    cfg = SortConfig(check="full")
    base = partial_sort.topk_batched(y, 50)
    out, counts = counted(lambda: partial_sort.topk_batched(y, 50, cfg), totals)
    tplan = build_topk_plan(y.shape[1], 50, y.dtype, cfg, rows=y.shape[0])
    expect_launches("topk_batched check=full", counts,
                    collections.Counter(k for k, *_ in topk_launches(tplan)))
    if not (torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])):
        raise AssertionError("topk_batched with check=full differs from off")
    print(json.dumps({
        "checked": "topk_batched float32 (256, 151936) k=50", "check": "full",
        "equal": True, "ms": time_ms(lambda: partial_sort.topk_batched(y, 50, cfg), 5),
        "off_ms": time_ms(lambda: partial_sort.topk_batched(y, 50), 5)}))
    if guard.degradation_log():
        raise AssertionError(f"checked runs degraded: {guard.degradation_log()}")


def doctored_plan(n):
    """A plan for n int32 keys whose top capacity is shrunk to 128, below
    the true bucket fills, with a direct child on the shrunk rows (at
    n = 2^19 the sound plan's direct child is 16,384 wide, the widest
    row sort)."""
    from repro_torch.core import SortConfig, build_plan

    plan = build_plan(n, torch.int32, SortConfig(direct_max=1 << 14))
    root = plan.root
    if root.kind != "bucket" or root.bucket_plan.kind != "direct":
        raise AssertionError(f"unexpected plan shape: {plan.describe()}")
    child = dataclasses.replace(root.bucket_plan, length=128, lp=128)
    return dataclasses.replace(
        plan, root=dataclasses.replace(root, cap=128, bucket_plan=child))


def faults_phase(totals):
    """Injected kernel.launch faults on the card: one is retried with the
    same plan, two raise; a shrunk capacity raises under check="bounds";
    no library sort runs."""
    from repro_torch.core import DEFAULT_CONFIG, bucket_sort, build_plan, faults, guard
    from repro_torch.core.plan import plan_launches

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(-(2**31), 2**31 - 1, (1 << 20,), generator=gen,
                      device="cuda", dtype=torch.int32)
    want = torch.sort(x, stable=True).values
    plan = build_plan(x.shape[0], x.dtype, DEFAULT_CONFIG)
    guard.clear_degradation_log()
    faults.reset()
    raised, doctored = None, None
    with library_sorts([]) as calls, warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        with faults.inject("kernel.launch", on_hit=1, count=1):
            out, counts = counted(lambda: bucket_sort.sort(x), totals)
        retried = [ev.action for ev in guard.degradation_log()]
        guard.clear_degradation_log()
        with faults.inject("kernel.launch", on_hit=1, count=2):
            try:
                bucket_sort.sort(x)
            except guard.SortRuntimeError as e:
                raised = e
        raised_log = [ev.action for ev in guard.degradation_log()]
        try:
            bucket_sort.sort_planned(x[: 1 << 19], doctored_plan(1 << 19),
                                     check="bounds")
        except guard.SortRuntimeError as e:
            doctored = e
    faults.reset()
    guard.clear_degradation_log()
    # The fault fires before the first launch, so the retry's launches
    # are the plan's: the same plan ran once more.
    expect_launches("sort under one fault", counts, plan_launches(plan))
    line = {
        "faults": "sort int32 2^20, kernel.launch on hit 1",
        "one_fault": {"equal": torch.equal(out, want), "log": retried},
        "two_faults": None if raised is None else {
            "site": raised.site, "invariant": raised.invariant,
            "cause": type(raised.__cause__).__name__,
            "root_cause": type(raised.__cause__.__cause__).__name__,
            "log": raised_log},
        "cap_below_fills": None if doctored is None else {
            "site": doctored.site, "invariant": doctored.invariant,
            "detail": doctored.detail},
        "library_sorts": len(calls),
    }
    print(json.dumps(line))
    if not line["one_fault"]["equal"] or retried != ["retry"]:
        raise AssertionError("one fault: no retry of the same plan, or wrong result")
    if raised is None or not raised.site.endswith(":tile_sort") or (
            "/top:bucket(" not in raised.site) or raised_log != ["retry"] or (
            line["two_faults"]["root_cause"] != "FaultInjected"):
        raise AssertionError("two faults: no SortRuntimeError naming node and kernel")
    if doctored is None or doctored.invariant != "bucket_fill <= cap":
        raise AssertionError("a capacity below the fills was not reported")
    if calls:
        raise AssertionError(f"a library sort ran in the chain: {calls}")


def make_distribution(name: str, n: int, rng) -> np.ndarray:
    """The input distributions of the paper's comparison, those of
    Leischner et al. and a bucket killer: a copy of the benchmarks'
    generators (benchmarks/common.py), kept here so the script stands
    alone."""
    if name == "uniform":
        return rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    if name == "gaussian":
        return (rng.normal(0, 2**29, n)).astype(np.int32)
    if name == "zipf":
        return (rng.zipf(1.3, n) % (2**31 - 1)).astype(np.int32)
    if name == "sorted":
        return np.sort(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))
    if name == "reverse":
        return np.sort(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))[::-1].copy()
    if name == "all-equal":
        return np.full(n, 123456789, np.int32)
    if name == "bucket-killer":
        return rng.choice(np.array([3, 7, 11], np.int32), n)
    raise KeyError(name)


DISTRIBUTIONS = ("uniform", "gaussian", "zipf", "sorted", "reverse",
                 "all-equal", "bucket-killer")


def comparison_phase(rng, totals):
    """The paper's comparison on the card: the deterministic sort against
    the randomized sample sort, merge sort and torch.sort, 2^26 int32 keys
    under each distribution.  Measurements only."""
    from repro_torch.core import DEFAULT_CONFIG, baselines, bucket_sort, build_plan, guard
    from repro_torch.core.plan import plan_launches
    from repro_torch.core.sort_config import round_up

    n, n_merge = 1 << 26, 1 << 24
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = build_plan(n, torch.int32, DEFAULT_CONFIG)
    s, lp = DEFAULT_CONFIG.s, round_up(n, DEFAULT_CONFIG.tile)
    times = collections.defaultdict(dict)
    for name in DISTRIBUTIONS:
        x = torch.from_numpy(make_distribution(name, n, rng)).cuda()
        want = torch.sort(x, stable=True)
        # Deterministic: the top round's fills against the static capacity.
        (srt, perm, stats), counts = counted(
            lambda: bucket_sort.sort_with_stats(x), totals)
        expect_launches(f"sort_with_stats {name}", counts, plan_launches(plan))
        if not (torch.equal(srt, want.values) and torch.equal(perm.long(), want.indices)):
            raise AssertionError(f"deterministic sort of {name} differs")
        top = stats[0]
        det = {"max_fill": int(top["totals"].max()), "cap": top["capacity"],
               "ms": time_ms(lambda: bucket_sort.sort_with_stats(x), 3)}
        if det["max_fill"] > det["cap"]:
            raise AssertionError(f"{name}: bucket fill above the deterministic cap")
        del srt, perm, stats
        # Randomized, factor 4 and four attempts: the retries it took.
        guard.clear_degradation_log()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", guard.DegradationWarning)
            (rs, rp, (mf, ovf)), counts = counted(
                lambda: baselines.randomized_sample_sort(x, gen, with_stats=True),
                totals)
            attempts = 1 + len(guard.degradation_log())
            expect_launches(f"randomized_sample_sort {name}", counts,
                            {"tile_sort": 2 * attempts, "splitter_ranks": attempts})
            if int(ovf) or not (torch.equal(rs, want.values)
                                and torch.equal(rp.long(), want.indices)):
                raise AssertionError(f"randomized sample sort of {name} differs")
            del rs, rp
            rand = {"capacity_factor": 4.0, "max_attempts": 4,
                    "cap": round_up(int(4.0 * 2 ** (attempts - 1) * lp / s), 128),
                    "max_fill": int(mf), "overflow": int(ovf),
                    "attempts": attempts,
                    "ms": time_ms(lambda: baselines.randomized_sample_sort(x, gen), 3)}
            guard.clear_degradation_log()
            # One attempt, observational: the overflow as it comes.
            (_, _, (mf1, ovf1)), _ = counted(
                lambda: baselines.randomized_sample_sort(
                    x, gen, with_stats=True, max_attempts=1), totals)
            single = {"capacity_factor": 4.0, "max_attempts": 1,
                      "max_fill": int(mf1), "overflow": int(ovf1),
                      "ms": time_ms(lambda: baselines.randomized_sample_sort(
                          x, gen, max_attempts=1), 3)}
        xm = x[:n_merge]
        (ms_keys, ms_perm), counts = counted(lambda: baselines.merge_sort(xm), totals)
        expect_launches(f"merge_sort {name}", counts, {"tile_sort": 1})
        wm = torch.sort(xm, stable=True)
        if not (torch.equal(ms_keys, wm.values) and torch.equal(ms_perm.long(), wm.indices)):
            raise AssertionError(f"merge sort of {name} differs")
        del ms_keys, ms_perm, wm, want
        merge = {"n": n_merge, "ms": time_ms(lambda: baselines.merge_sort(xm), 3)}
        library = {"ms": time_ms(lambda: torch.sort(x, stable=True), 5)}
        for alg, rec in (("deterministic", det), ("randomized", rand),
                         ("randomized_single_shot", single), ("merge_sort", merge),
                         ("torch_sort", library)):
            times[alg][name] = rec["ms"]
        print(json.dumps({
            "comparison": name, "n": n, "deterministic": det,
            "randomized": rand, "randomized_single_shot": single,
            "merge_sort": merge, "torch_sort": library}))
        del x
    print(json.dumps({"comparison_spread": {
        alg: {"min_ms": min(t.values()), "max_ms": max(t.values()),
              "max_over_min": max(t.values()) / min(t.values()),
              "slowest": max(t, key=t.get)}
        for alg, t in times.items()}}))


# The grids of the cost model's fitted constants (core/cost_model.py),
# each from no weight to one that dominates its channel.
FIT_GRID = {
    "GLUE_FACTOR": (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
                    16.0, 24.0, 32.0),
    "OP_BYTE_EQUIV": (0.0, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0),
    "LAUNCH_BYTE_EQUIV": (0.0, 1e5, 1e6, 1e7, 1e8),
}


def fit_cost_constants(channels, times_us) -> dict:
    """The point of ``FIT_GRID`` whose totals fit the measured times best:
    least squares of log(time) - log(k * total) with k, the byte-equivalents'
    time, fitted in closed form; with its error and the Spearman rho of its
    totals against the times."""
    from repro_torch.core import cost_model

    logt = np.log(np.asarray(times_us, float))
    best = None
    for g, o, l in itertools.product(*FIT_GRID.values()):
        tot = np.array([c["hbm_bytes"] + g * c["glue_bytes"] + o * c["op_units"]
                        + l * c["launches"] for c in channels])
        r = logt - np.log(tot)
        err = float(np.sqrt(np.mean((r - r.mean()) ** 2)))
        if best is None or err < best[0]:
            best = (err, (g, o, l), tot)
    err, consts, tot = best
    return {**dict(zip(FIT_GRID, consts)), "rms_log_error": err,
            "rho": cost_model.spearman(tot, times_us)}


def calibration(n, dtype, totals, seed=0):
    """Every candidate of the autotuner's space around DEFAULT_CONFIG at n
    keys of dtype, on the tuner's own seeded data: each run once (its
    launches counted and held to its plan, its output to stable
    torch.sort, its peak memory read), then all timed by the tuner's
    measurement (``autotune`` with no budget: medians of 3 after one
    warm-up).  Returns one dict a candidate."""
    from repro_torch.core import DEFAULT_CONFIG, autotune, bucket_sort, build_plan, cost_model
    from repro_torch.core.plan import plan_launches

    x = autotune._sample_input(n, dtype, 1, seed, "cuda")
    want = torch.sort(x, stable=True).values
    rows = []
    for cand in autotune.candidate_space(DEFAULT_CONFIG, n):
        plan = build_plan(n, dtype, cand.cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, counts = counted(
            lambda: bucket_sort.sort_planned(x, plan, device=x.device), totals)
        peak = torch.cuda.max_memory_allocated() - base
        expect_launches(f"candidate {cand.label}", counts, plan_launches(plan))
        if not torch.equal(out, want):
            raise AssertionError(f"candidate {cand.label}: differs from torch.sort")
        del out
        node = plan.root
        while node.kind == "bucket":
            node = node.bucket_plan
        rows.append({"label": cand.label, "levels": plan.num_levels,
                     "direct": [node.rows, node.lp], "launches": sum(counts.values()),
                     "peak_bytes_above_input": peak,
                     "channels": cost_model.estimate(plan).as_dict()})
    del x, want
    res, _ = counted(lambda: autotune.autotune(
        n, dtype, DEFAULT_CONFIG, device="cuda", measure_budget=None, seed=seed),
        totals)
    if res.failed or [c.label for c in res.candidates] != [r["label"] for r in rows]:
        raise AssertionError(f"calibration: candidates failed {res.failed}")
    for row, score in zip(rows, res.candidates):
        row.update(predicted=score.predicted, us=score.us_per_call)
    return rows


def rank_report(name, rows) -> dict:
    """Spearman rho of predicted against measured, the measured winner,
    and whether it is among the five cheapest predicted or the base (the
    tuner's default budget)."""
    from repro_torch.core import cost_model

    pred = [r["predicted"] for r in rows]
    meas = [r["us"] for r in rows]
    five = sorted(range(len(rows)), key=lambda i: (pred[i], i))[:5]
    win = int(np.argmin(meas))
    return {"calibration_rank": name, "rho": cost_model.spearman(pred, meas),
            "measured_winner": rows[win]["label"],
            "winner_in_five_cheapest_or_base": win in five or win == 0,
            "five_cheapest_predicted": [rows[i]["label"] for i in five],
            "best_us": meas[win], "base_us": meas[0], "speedup": meas[0] / meas[win]}


def tuned_sort(x, store_dir, totals) -> dict:
    """sort(x, SortConfig(plan="autotune")) against a fresh store: the cold
    call tunes (five candidates measured) and runs the winner, a warm call
    measures nothing and runs the same plan object, the store alone gives
    an equal plan, and a plan file written by save_plan runs it too; no
    library sort or top-k runs in any of them."""
    from repro_torch.core import SortConfig, autotune, bucket_sort, build_plan, cost_model, faults
    from repro_torch.core.plan import plan_launches

    n = x.shape[0]
    cfg = SortConfig(plan="autotune")
    want = torch.sort(x, stable=True).values
    cands = autotune.candidate_space(cfg, n)
    plans = [build_plan(n, x.dtype, c.cfg) for c in cands]
    chosen = autotune._select_measured(
        [cost_model.estimate(p).total for p in plans], 5, [0])
    key = autotune.cache_key(build_plan(n, x.dtype, cfg), x.device)

    def resolve(c):
        return bucket_sort.resolve_plan(n, x.dtype, c, device=x.device)

    autotune.clear_memo()
    faults.reset()
    with library_sorts([]) as calls:
        t0 = time.perf_counter()
        out, cold = counted(lambda: bucket_sort.sort(x, cfg), totals)
        cold_s = time.perf_counter() - t0
        cold_measured = faults.hits("autotune.measure")
        winner = resolve(cfg)
        faults.reset()
        warm_out, warm = counted(lambda: bucket_sort.sort(x, cfg), totals)
        warm_same = resolve(cfg) is winner
        autotune.clear_memo()
        stored_equal = resolve(cfg) == winner
        store_measured = faults.hits("autotune.measure")
        path = os.path.join(store_dir, "winner.json")
        autotune.save_plan(winner, path)
        fcfg = SortConfig(plan=path)
        file_out, from_file = counted(lambda: bucket_sort.sort(x, fcfg), totals)
        file_equal = resolve(fcfg) == winner
    rec = json.load(open(autotune.cache_path()))["plans"][key]
    want_cold = collections.Counter()
    for i in chosen:
        for k, c in plan_launches(plans[i]).items():
            want_cold[k] += 4 * c  # a warm-up and three timed runs
    want_cold.update(plan_launches(winner))
    expect_launches("cold tune and sort", cold, want_cold)
    expect_launches("warm sort", warm, plan_launches(winner))
    expect_launches("plan-file sort", from_file, plan_launches(winner))
    equal = all(torch.equal(o, want) for o in (out, warm_out, file_out))
    del out, warm_out, file_out, want
    ms, peak = timed_with_peak(lambda: bucket_sort.sort(x, cfg))
    base_ms, base_peak = timed_with_peak(lambda: bucket_sort.sort(x))
    line = {
        "autotune": f"sort {str(x.dtype).removeprefix('torch.')} n={n} plan=autotune", "cold_s": cold_s,
        "candidates": len(cands), "measured": cold_measured,
        "measured_labels": [cands[i].label for i in chosen],
        "winner": rec["label"], "levels": winner.num_levels,
        "best_us": rec["best_us"], "default_us": rec["default_us"],
        "speedup": rec["speedup"], "equal": equal, "launches": dict(warm),
        "warm_measurements": faults.hits("autotune.measure"),
        "warm_same_plan": warm_same, "store_equal_plan": stored_equal,
        "store_measurements": store_measured, "plan_file_equal_plan": file_equal,
        "library_sorts": len(calls), "ms": ms, "default_ms": base_ms,
        "peak_bytes_above_input": peak, "default_peak_bytes_above_input": base_peak,
    }
    print(json.dumps(line))
    if not equal:
        raise AssertionError("plan=autotune: differs from stable torch.sort")
    if cold_measured != len(chosen) or line["warm_measurements"] or store_measured:
        raise AssertionError(f"plan=autotune measured {cold_measured} cold, "
                             f"{line['warm_measurements']} warm, {store_measured} "
                             f"from the store; expected {len(chosen)}, 0, 0")
    if not (warm_same and stored_equal and file_equal):
        raise AssertionError("plan=autotune: warm, stored or file plan differs")
    if calls:
        raise AssertionError(f"a library sort ran in plan=autotune: {calls}")
    return line


def autotune_phase(rng, totals):
    """The cost model and the autotuner on the card: the 11 candidates at
    2^26 int32 measured (rho, the winner, a fit of the constants), the
    same space at 2^24 int64 held out (rho with the committed constants),
    then ``plan="autotune"`` at 2^20 and 2^26 int32 against fresh stores
    in temporary directories."""
    from repro_torch.core import autotune

    rows = calibration(1 << 26, torch.int32, totals)
    for i, r in enumerate(rows):
        print(json.dumps({"calibration": "int32 2^26", "index": i, **r}))
    report = rank_report("int32 2^26", rows)
    report["fit"] = fit_cost_constants([r["channels"] for r in rows],
                                       [r["us"] for r in rows])
    print(json.dumps(report))
    held = calibration(1 << 24, torch.int64, totals)
    for i, r in enumerate(held):
        print(json.dumps({"calibration": "int64 2^24 held out", "index": i, **r}))
    print(json.dumps(rank_report("int64 2^24 held out", held)))
    old = os.environ.get(autotune._CACHE_ENV)
    try:
        for n in (1 << 20, 1 << 26):
            with tempfile.TemporaryDirectory() as tmp:
                os.environ[autotune._CACHE_ENV] = os.path.join(tmp, "plans.json")
                x = torch.from_numpy(
                    rng.integers(-(2**31), 2**31, n, dtype=np.int32)).cuda()
                tuned_sort(x, tmp, totals)
                del x
    finally:
        if old is None:
            os.environ.pop(autotune._CACHE_ENV, None)
        else:
            os.environ[autotune._CACHE_ENV] = old
        autotune.clear_memo()


# ----------------------------------------------------------------------
# The distributed sort: D rank processes on this one card, one gloo group
# ----------------------------------------------------------------------

# (name, log2 n, dtype, ranks, descending): 2^26 is the largest power of
# two under the payload budget n * 16 < 2^31.
DIST_CASES = (
    ("sort int32 2^26 over D=4", 26, "int32", 4, False),
    ("sort int64 2^24 over D=4", 24, "int64", 4, False),
    ("sort int32 2^26 over D=2", 26, "int32", 2, False),
    ("sort float32 2^24 descending over D=2, NaN/+-inf/-0.0", 24, "float32", 2,
     True),
)
DIST_FAULT_N = 1 << 22
DIST_TUNE_N = 1 << 24


class PhaseEvents:
    """The ``phase`` hook of the distributed sort: CUDA events around each
    phase on the rank's stream, summed by phase name (the device timeline
    between them, idle gaps included)."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.spans.append((name, a, b))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for name, a, b in self.spans:
            out[name] += a.elapsed_time(b)
        return dict(out)


def gloo_cuda_probe(group) -> dict:
    """Whether gloo's collectives take CUDA tensors as they are, which the
    distributed sort relies on: tried on a few elements, on every rank
    alike."""
    import torch.distributed as dist

    d = dist.get_world_size(group)
    out = {}
    x = torch.arange(4 * d, dtype=torch.int32, device="cuda")
    for name, fn in (
        ("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=group)),
        ("all_gather", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(d)], x, group=group)),
        ("all_reduce", lambda: dist.all_reduce(x.clone(), group=group)),
    ):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # a refusal is the answer sought
            out[name] = f"refused: {type(e).__name__}: {str(e)[:120]}"
    return out


def _dist_case(rank, world, case, reps=3):
    """One case on this rank: a counted run (counts set to 0 just before,
    read just after), then ``reps`` timed runs, each started from a
    barrier."""
    import torch.distributed as dist

    from repro_torch.core import SortConfig, distributed_sort
    from repro_torch.core.plan import plan_launches
    from repro_torch.kernels import ops

    x = np.load(case["path"], mmap_mode="r")
    n = x.shape[0]
    nl = n // world
    shard = torch.from_numpy(np.array(x[rank * nl:(rank + 1) * nl])).cuda()
    run, plan = distributed_sort.make_sharded_sort(
        None, n, SortConfig(descending=case["desc"]), dtype=shard.dtype)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    k, v, c, mw = run(shard)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    count = int(c)
    out = dict(keys=k[:count].cpu(), vals=v[:count].cpu(), count=count,
               max_within=int(mw), c_pair=plan.c_pair, out_cap=plan.out_cap,
               launches=counts, plan_launches=dict(plan_launches(plan)),
               peak_bytes_above_shard=peak,
               exchange_bytes=plan.exchange_elements * plan.bytes_per_element,
               collective_bytes=plan.collective_elements * plan.bytes_per_element,
               route=f"{dist.get_backend()} with {shard.device.type} tensors",
               walls=[], phases=[])
    del k, v
    for _ in range(reps):
        events = PhaseEvents()
        dist.barrier()
        t0 = time.perf_counter()
        run(shard, phase=events)
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["phases"].append(events.ms())
    return out


def _dist_faults(rank, world, path):
    """collective.exchange armed on rank 1 only: once (every rank retries,
    the result stands), then at every hit (every rank raises)."""
    from repro_torch.core import distributed_sort, faults, guard

    x = torch.from_numpy(np.load(path))
    nl = x.shape[0] // world
    shard = x[rank * nl:(rank + 1) * nl].cuda()
    run, _ = distributed_sort.make_sharded_sort(None, x.shape[0])
    out = {}
    with warnings.catch_warnings(), library_sorts([]) as calls:
        warnings.simplefilter("ignore", guard.DegradationWarning)
        for label, count in (("once", 1), ("always", 10**6)):
            guard.clear_degradation_log()
            arm = (faults.inject("collective.exchange", on_hit=1, count=count)
                   if rank == 1 else contextlib.nullcontext())
            res = dict(error=None)
            try:
                with arm:
                    k, v, c, _ = run(shard)
                res.update(keys=k[:int(c)].cpu(), vals=v[:int(c)].cpu())
            except guard.SortRuntimeError as e:
                res["error"] = dict(site=e.site, invariant=e.invariant,
                                    cause=type(e.__cause__).__name__)
            res["log"] = [ev.action for ev in guard.degradation_log()]
            res["stats"] = dict(run.last_stats)
            out[label] = res
        out["library_sorts"] = list(calls)
    faults.reset()
    return out


def _dist_autotune(rank, world, path, store):
    """SortConfig(plan="autotune") against a fresh store: the cold tune,
    its measured candidates and winner; a warm call; a plan file."""
    import torch.distributed as dist

    from repro_torch.core import SortConfig, autotune, distributed_sort
    from repro_torch.core.plan import plan_launches, shard_plan_json
    from repro_torch.kernels import ops

    os.environ[autotune._CACHE_ENV] = store
    autotune.clear_memo()
    x = torch.from_numpy(np.load(path))
    n = x.shape[0]
    nl = n // world
    shard = x[rank * nl:(rank + 1) * nl].cuda()
    measured = []
    real = autotune._measure_shard_candidate

    def spy(run, xs, label, comm, **kw):
        us, err = real(run, xs, label, comm, **kw)
        measured.append(dict(label=label, us=us, error=err))
        return us, err

    autotune._measure_shard_candidate = spy
    cfg = SortConfig(plan="autotune")
    try:
        t0 = time.perf_counter()
        run, plan = distributed_sort.make_sharded_sort(
            None, n, cfg, dtype=shard.dtype, device=shard.device)
        cold_s = time.perf_counter() - t0
        n_cold = len(measured)
        run2, warm = distributed_sort.make_sharded_sort(
            None, n, cfg, dtype=shard.dtype, device=shard.device)
        ops.reset_launch_counts()
        k, v, c, _ = run2(shard)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        with open(store) as f:
            label = next(r["label"] for key, r in json.load(f)["plans"].items()
                         if key.startswith("shard|"))
        file = os.path.join(os.path.dirname(store), "shard_plan.json")
        if rank == 0:
            autotune.save_shard_plan(plan, file)
        dist.barrier()
        run3, filed = distributed_sort.make_sharded_sort(
            None, n, SortConfig(plan=file), dtype=shard.dtype)
        k3, v3, c3, _ = run3(shard)
    finally:
        autotune._measure_shard_candidate = real
        autotune.clear_memo()
    return dict(
        cold_s=cold_s, measured=measured[:n_cold],
        warm_measurements=len(measured) - n_cold, winner=label,
        plan=shard_plan_json(plan), warm_same=warm is plan,
        file_equal=filed == plan, launches=counts,
        plan_launches=dict(plan_launches(plan)),
        keys=k[:int(c)].cpu(), vals=v[:int(c)].cpu(),
        file_keys=k3[:int(c3)].cpu(), file_vals=v3[:int(c3)].cpu())


def dist_rank(rank, world, spec):
    """One rank process of the distributed phase, on cuda:0."""
    torch.cuda.set_device(0)
    out = {"probe": gloo_cuda_probe(None) if spec.get("probe") else None}
    out["cases"] = [_dist_case(rank, world, case) for case in spec["cases"]]
    if spec.get("fault_path"):
        out["faults"] = _dist_faults(rank, world, spec["fault_path"])
    if spec.get("tune_path"):
        out["autotune"] = _dist_autotune(rank, world, spec["tune_path"],
                                         spec["store"])
    return out


def _stable(x: torch.Tensor, descending: bool):
    """Stable torch.sort of x in the codec's total order (NaN last
    ascending, -0.0 before 0.0): sort the order-preserving int64 image."""
    from repro_torch.core.key_codec import codec_for

    words = codec_for(x.dtype, descending).encode(x)
    key = words[0].long()  # biased int32 words: signed order is the order
    if len(words) == 2:
        key = key * 2**32 + (words[1].long() + 2**31)
    idx = torch.sort(key, stable=True).indices
    return x[idx], idx


def _check_gathered(name, x, parts, descending):
    """The ranks' valid prefixes, in rank order, against stable torch.sort
    of the whole array on the card."""
    keys = torch.cat([p["keys"] for p in parts]).cuda()
    vals = torch.cat([p["vals"] for p in parts]).cuda()
    want_k, want_i = _stable(x, descending)
    same = (keys.view(torch.uint8).equal(want_k.view(torch.uint8))
            and torch.equal(vals.long(), want_i))
    if not same:
        raise AssertionError(f"{name}: differs from stable torch.sort")


def distributed_phase(rng, totals):
    """The distributed sort over D in {2, 4} rank processes sharing this
    card, one gloo group (gloo copies CUDA tensors through host memory): every
    case checked in this process against stable torch.sort on the card,
    its launches held to the ShardPlan's walk on every rank, timed (the
    last rank's wall, per-phase ms, max over ranks), beside the
    single-process sort of the same keys; then the fault chain and
    plan="autotune" over D=2.  These are D ranks on one card, not a
    multi-GPU result."""
    from repro_torch.core import SortConfig, bucket_sort, distributed_sort
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = {}
        for i, (name, log2n, dtype, d, desc) in enumerate(DIST_CASES):
            n = 1 << log2n
            if dtype == "float32":
                x = (rng.standard_normal(n) * 1e6).astype(np.float32)
                x[rng.integers(0, n, 8)] = [np.nan, np.inf, -np.inf, -0.0, 0.0,
                                            np.nan, 1.5, -1.5]
            else:
                info = np.iinfo(dtype)
                x = rng.integers(info.min, info.max, n, dtype=dtype)
            path = os.path.join(tmp, f"case{i}.npy")
            np.save(path, x)
            inputs[i] = dict(path=path, desc=desc, name=name, d=d)
        fault_path = os.path.join(tmp, "faults.npy")
        xf = rng.integers(-(2**31), 2**31, DIST_FAULT_N, dtype=np.int32)
        np.save(fault_path, xf)
        tune_path = os.path.join(tmp, "tune.npy")
        xt = rng.integers(-(2**31), 2**31, DIST_TUNE_N, dtype=np.int32)
        np.save(tune_path, xt)
        results = {}
        for d in (4, 2):
            spec = dict(cases=[c for c in inputs.values() if c["d"] == d])
            if d == 2:
                spec.update(probe=True, fault_path=fault_path,
                            tune_path=tune_path,
                            store=os.path.join(tmp, "store", "plans.json"))
            t0 = time.perf_counter()
            results[d] = run_ranks(dist_rank, d, spec, timeout_s=300,
                                   deadline_s=900)
            print(f"distributed D={d}: {d} rank processes ran in "
                  f"{time.perf_counter() - t0:.1f} s")

        for d, ranks in results.items():
            cases = [c for c in inputs.values() if c["d"] == d]
            for j, case in enumerate(cases):
                parts = [r["cases"][j] for r in ranks]
                x = torch.from_numpy(np.load(case["path"])).cuda()
                _check_gathered(case["name"], x, parts, case["desc"])
                for p in parts:
                    if p["max_within"] >= p["c_pair"]:
                        raise AssertionError(f"{case['name']}: max_within "
                                             f"{p['max_within']} >= c_pair")
                    expect_launches(case["name"], p["launches"],
                                    p["plan_launches"])
                    for k_, c_ in p["launches"].items():
                        totals[k_] += c_
                if sum(p["count"] for p in parts) != x.numel():
                    raise AssertionError(f"{case['name']}: counts do not sum to n")
                cfg = SortConfig(descending=case["desc"])
                single_ms = time_ms(
                    lambda: bucket_sort.sort(x, cfg, device=x.device), 3)
                torch_ms = time_ms(lambda: torch.sort(x, stable=True,
                                                      descending=case["desc"]), 3)
                walls = [max(p["walls"][i] for p in parts) for i in range(3)]
                phases = {name: max(statistics.median(ph[name] for ph in p["phases"])
                                    for p in parts)
                          for name in distributed_sort.PHASES}
                print(json.dumps({
                    "distributed": case["name"], "d": d, "n": x.numel(),
                    "equal": True, "route": parts[0]["route"],
                    "wall_ms": statistics.median(walls) * 1e3,
                    "phase_ms_max_over_ranks": phases,
                    "exchange_bytes_per_rank": parts[0]["exchange_bytes"],
                    "collective_bytes_per_rank": parts[0]["collective_bytes"],
                    "peak_bytes_above_shard": [p["peak_bytes_above_shard"]
                                               for p in parts],
                    "counts": [p["count"] for p in parts],
                    "max_within": [p["max_within"] for p in parts],
                    "c_pair": parts[0]["c_pair"],
                    "launches_per_rank": {k_: c_ for k_, c_ in
                                          parts[0]["launches"].items() if c_},
                    "single_process_sort_ms": single_ms,
                    "torch_sort_ms": torch_ms,
                }))
                del x

        ranks = results[2]
        print(json.dumps({"gloo_cuda_probe": ranks[0]["probe"]}))
        tl = [r["autotune"] for r in ranks]
        xt_t = torch.from_numpy(xt).cuda()
        _check_gathered("autotune", xt_t, tl, False)
        _check_gathered("autotune plan file", xt_t,
                        [dict(keys=t["file_keys"], vals=t["file_vals"])
                         for t in tl], False)
        for t in tl:
            expect_launches("autotune", t["launches"], t["plan_launches"])
            for k_, c_ in t["launches"].items():
                totals[k_] += c_
        print(json.dumps({
            "distributed_autotune": "sort int32 2^24 over D=2 plan=autotune",
            "cold_s": [t["cold_s"] for t in tl],
            "measured": tl[0]["measured"], "winner": tl[0]["winner"],
            "same_plan_on_every_rank": len({t["plan"] for t in tl}) == 1,
            "same_measured_on_every_rank": len({json.dumps(t["measured"])
                                                for t in tl}) == 1,
            "warm_measurements": [t["warm_measurements"] for t in tl],
            "warm_same_plan": [t["warm_same"] for t in tl],
            "plan_file_equal_plan": [t["file_equal"] for t in tl],
            "equal": True,
        }))
        if len({t["plan"] for t in tl}) != 1 or any(
                t["warm_measurements"] or not t["warm_same"] or not t["file_equal"]
                for t in tl):
            raise AssertionError("distributed autotune: ranks disagree, or a "
                                 "warm call measured, or the file differs")
        xf_t = torch.from_numpy(xf).cuda()
        fl = [r["faults"] for r in ranks]
        _check_gathered("fault once", xf_t, [f["once"] for f in fl], False)
        line = {"distributed_faults": "sort int32 2^22 over D=2, "
                "collective.exchange on rank 1 only",
                "once": {"log": [f["once"]["log"] for f in fl],
                         "stats": [f["once"]["stats"] for f in fl],
                         "equal": True},
                "always": {"errors": [f["always"]["error"] for f in fl],
                           "log": [f["always"]["log"] for f in fl]},
                "library_sorts": sum(len(f["library_sorts"]) for f in fl)}
        print(json.dumps(line))
        for f in fl:
            if f["once"]["log"] != ["retry"] or f["always"]["log"] != ["retry"]:
                raise AssertionError("distributed faults: every rank must log "
                                     "one retry")
            err = f["always"]["error"]
            if err is None or not err["site"].startswith(
                    "collective.exchange[D=2]:ShardPlan("):
                raise AssertionError("distributed faults: the double fault did "
                                     "not raise a SortRuntimeError on every rank")
        if line["library_sorts"]:
            raise AssertionError("distributed faults: a library sort ran")


# ----------------------------------------------------------------------
# Serving: Qwen3-MoE-30B-A3B at full width and depth
# ----------------------------------------------------------------------

SERVE_ARCH = "qwen3-moe-30b-a3b"
SERVE_RUN = dict(requests=8, prompt_len=1024, gen=16, topk=8, temperature=0.8)
SERVE_DISPATCHES = ("sample_sort", "xla_sort", "onehot")
SMOKE_DECODE_STEPS = 4
# Card against CPU at smoke size, float32 with TF32 off on both: the same
# ops, summed in other orders over two layers (the CPU parity tests hold
# the port to the reference within the same 1e-4).
SMOKE_TOL = 1e-4


def serving_launches(cfg, requests, prompt_len, gen, topk) -> dict:
    """Launches per kernel one serve calls for, from the plans: per layer
    of the prefill and of each of the gen - 1 decode steps the router (K4,
    "sample_sort" only) and the dispatch argsort (the sample sort's walk,
    "sample_sort" only); the sampler's top-k walk at each of gen steps."""
    from repro_torch.core import build_plan, build_topk_plan
    from repro_torch.core.plan import kernel_launches, topk_launches
    from repro_torch.launch import serve
    from repro_torch.models import moe

    walk = []
    if cfg.moe.dispatch == "sample_sort":
        k = cfg.moe.top_k
        for tokens, times in ((requests * prompt_len, 1), (requests, gen - 1)):
            plan = build_plan(tokens * k, torch.int32, moe._DISPATCH_SORT_CFG)
            walk += times * cfg.n_layers * (
                [("topk",)] + kernel_launches(plan.root))
    tplan = build_topk_plan(cfg.padded_vocab, topk, getattr(torch, cfg.dtype),
                            serve.sampler_config(), rows=requests)
    walk += gen * topk_launches(tplan)
    return dict(collections.Counter(name for name, *_ in walk))


def training_launches(cfg, tokens: int) -> dict:
    """Launches per kernel one train step of ``tokens`` tokens calls for,
    from the plans: per layer the router (K4) and the dispatch argsort's
    walk ("sample_sort" only; the plan of the serving prefill's layer at
    the same token count), in the forward and once more in the recompute
    under remat "full" or "dots"; the backward launches none."""
    from repro_torch.core import build_plan
    from repro_torch.core.plan import kernel_launches
    from repro_torch.models import moe

    if cfg.moe.dispatch != "sample_sort":
        return {}
    plan = build_plan(tokens * cfg.moe.top_k, torch.int32, moe._DISPATCH_SORT_CFG)
    passes = 1 if cfg.remat == "none" else 2
    walk = passes * cfg.n_layers * ([("topk",)] + kernel_launches(plan.root))
    return dict(collections.Counter(name for name, *_ in walk))


class SortSpans:
    """CUDA events around every router top-k (``moe._topk_gates``),
    dispatch rank (``moe._rank_in_expert_sort`` / ``_onehot``) and sampler
    call (``serve.sample_topk``) while :meth:`patched` is on, and a device
    flag that every logits row the sampler is given is finite."""

    def __init__(self):
        self.spans = []  # (kind, leading dim of the input, start, end)
        self.finite = None

    @contextlib.contextmanager
    def patched(self):
        from repro_torch.launch import serve
        from repro_torch.models import moe

        targets = [(moe, "_topk_gates", "router"),
                   (moe, "_rank_in_expert_sort", "dispatch"),
                   (moe, "_rank_in_expert_onehot", "dispatch"),
                   (serve, "sample_topk", "sampler")]
        saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]

        def wrap(fn, kind):
            def call(x, *args, **kwargs):
                if kind == "sampler":
                    ok = torch.isfinite(x).all()
                    self.finite = ok if self.finite is None else self.finite & ok
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(x, *args, **kwargs)
                b.record()
                self.spans.append((kind, x.shape[0], a, b))
                return out
            return call

        for (owner, name, kind), (_, _, fn) in zip(targets, saved):
            setattr(owner, name, wrap(fn, kind))
        try:
            yield self
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)

    def ms(self, kind, rows=None, skip=0) -> float:
        """Summed ms of the spans of ``kind`` (whose input has ``rows``
        leading rows, if given), leaving out the first ``skip``."""
        spans = [(a, b) for k, r, a, b in self.spans
                 if k == kind and (rows is None or r == rows)][skip:]
        return sum(a.elapsed_time(b) for a, b in spans)


def check_router_and_dispatch(model, tokens, cfg):
    """Layer 0's router ids and dispatch permutation on the card, at the
    prefill's and a decode step's shapes, equal the library references: a
    stable descending torch.sort and torch.argsort(stable=True).  These
    launches compare, so they are not counted."""
    from repro_torch.core import bucket_sort
    from repro_torch.models import moe

    k, layer = cfg.moe.top_k, model.layers[0]
    with torch.inference_mode():
        for rows in (tokens, tokens[:, :1]):
            x = layer.ln2(model.embed(rows, cfg), cfg).reshape(-1, cfg.d_model)
            logits = x.float() @ layer.moe.router.float()
            _, ids = moe._topk_gates(logits, k, "sample_sort")
            _, order = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                                  descending=True, stable=True)
            if not torch.equal(ids.long(), order[:, :k]):
                raise AssertionError(f"router ids on {tuple(logits.shape)} differ "
                                     "from a stable descending torch.sort")
            flat = ids.reshape(-1)
            perm = bucket_sort.argsort(flat, moe._DISPATCH_SORT_CFG, device=flat.device)
            if not torch.equal(perm.long(), torch.argsort(flat, stable=True)):
                raise AssertionError(f"dispatch permutation of {flat.numel()} ids "
                                     "differs from torch.argsort(stable=True)")
    print(f"serving: layer 0's router ids and dispatch permutation equal the "
          f"library's at {tokens.numel()} and {tokens.shape[0]} tokens")


def serve_once(model, tokens, cfg, dispatch, seed, totals, init_s):
    """One counted, timed ``serve.generate`` with ``dispatch``; its
    ``{"serving": ...}`` line.  Returns (tokens, prefill logits) on the
    host."""
    from repro_torch.launch import serve
    from repro_torch.models import api, meta

    run = SERVE_RUN
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    n_pre = run["requests"] * run["prompt_len"]
    spans, calls = SortSpans(), []
    # A short uncounted serve first, so that the timed one finds the
    # library's kernels loaded and its workspaces allocated.
    serve.generate(model, tokens, cfg, gen=2, topk=run["topk"],
                   temperature=run["temperature"],
                   generator=torch.Generator(device=tokens.device).manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=tokens.device).manual_seed(seed + 1)
    with spans.patched(), library_sorts(calls):
        out, counts = counted(lambda: serve.generate(
            model, tokens, cfg, gen=run["gen"], topk=run["topk"],
            temperature=run["temperature"], generator=gen), totals)
    peak = torch.cuda.max_memory_allocated()
    want = serving_launches(cfg, run["requests"], run["prompt_len"], run["gen"],
                            run["topk"])
    expect_launches(f"serve {dispatch}", counts, want)
    if dispatch == "sample_sort" and calls:
        raise AssertionError(f"serve sample_sort called library sorts {calls}")
    if not bool(spans.finite) or not bool(torch.isfinite(out.prefill_logits).all()):
        raise AssertionError(f"serve {dispatch}: a logit is not finite")
    toks = out.tokens.cpu()
    if toks.shape != (run["requests"], run["gen"]) or not bool(
            ((toks >= 0) & (toks < cfg.padded_vocab)).all()):
        raise AssertionError(f"serve {dispatch}: token ids {toks}")
    steps = run["gen"] - 1
    k = cfg.moe.top_k
    decode_ms = out.decode_s * 1e3 / steps
    router_pre = spans.ms("router", n_pre)
    dispatch_pre = spans.ms("dispatch", n_pre * k)
    router_dec = spans.ms("router", run["requests"]) / steps
    dispatch_dec = spans.ms("dispatch", run["requests"] * k) / steps
    sampler_dec = spans.ms("sampler", skip=1) / steps
    params = sum(p.numel() for p in model.parameters())
    print(json.dumps({"serving": {
        "arch": cfg.name, "dispatch": dispatch, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype,
        "params": params, "template_params": meta.count_params(api.template(cfg)),
        "param_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
        **run, "cold_init_s": init_s,
        "prefill_ms": out.prefill_s * 1e3, "decode_ms_per_token": decode_ms,
        "peak_gb": peak / 1e9, "launches": counts,
        "sort_ms_prefill": {"router": router_pre, "dispatch": dispatch_pre,
                            "share": (router_pre + dispatch_pre) / (out.prefill_s * 1e3)},
        "sort_ms_per_decode_token": {
            "router": router_dec, "dispatch": dispatch_dec, "sampler": sampler_dec,
            "share": (router_dec + dispatch_dec + sampler_dec) / decode_ms},
        "first_sample_ms": spans.ms("sampler") - spans.ms("sampler", skip=1),
        "tokens_row0": toks[0].tolist(),
    }}))
    return toks, out.prefill_logits.cpu()


def profile_serving(model, tokens, cfg):
    """:func:`device_profile` of one prefill and of one decode step with
    its sampling."""
    from repro_torch.launch import serve
    from repro_torch.models import api

    s = SERVE_RUN["prompt_len"]
    gen = torch.Generator(device=tokens.device).manual_seed(0)

    def prefill():
        return api.prefill(model, {"tokens": tokens}, cfg, s + 1)

    _, caches = prefill()
    tok = torch.zeros((tokens.shape[0], 1), dtype=torch.int32, device=tokens.device)

    def decode():
        logits, _ = api.decode_step(model, tok, caches, s, cfg)
        return serve.sample_topk(logits, SERVE_RUN["topk"], SERVE_RUN["temperature"], gen)

    for name, fn in (("prefill", prefill), ("decode step + sampling", decode)):
        print(json.dumps({"serving_profile": {
            "arch": cfg.name, "dispatch": cfg.moe.dispatch, "step": name,
            **device_profile(fn, top_n=12)}}))


def smoke_card_vs_cpu(seed):
    """The smoke config, float32, the same weights on both devices:
    prefill and SMOKE_DECODE_STEPS greedy decode steps on the card
    (kernels) and on the CPU (plain versions) agree within SMOKE_TOL, and
    the greedy tokens are equal."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api, meta
    from repro_torch.models.transformer import CausalLM

    cfg = configs.get_smoke(SERVE_ARCH)
    params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(seed), "cpu")
    models = {"cpu": CausalLM(cfg, params),
              "card": CausalLM(cfg, tree_map(lambda t: t.to("cuda"), params))}
    prompt = torch.from_numpy(serve.prompts(cfg, 4, 32))
    cache_len = prompt.shape[1] + SMOKE_DECODE_STEPS
    logits, toks = {}, {}
    for name, model in models.items():
        dev = "cuda" if name == "card" else "cpu"
        lg, caches = api.prefill(model, {"tokens": prompt.to(dev)}, cfg, cache_len)
        steps, tok = [lg.cpu()], [lg.argmax(-1)]
        for i in range(SMOKE_DECODE_STEPS):
            lg, caches = api.decode_step(model, tok[-1][:, None], caches,
                                         prompt.shape[1] + i, cfg)
            steps.append(lg.cpu())
            tok.append(lg.argmax(-1))
        logits[name], toks[name] = steps, torch.stack([t.cpu() for t in tok], 1)
    err = max(float((a - b).abs().max()) for a, b in zip(logits["card"], logits["cpu"]))
    ok = all(torch.allclose(a, b, rtol=SMOKE_TOL, atol=SMOKE_TOL)
             for a, b in zip(logits["card"], logits["cpu"]))
    if not ok or not torch.equal(toks["card"], toks["cpu"]):
        raise AssertionError(f"smoke serve: card and CPU differ (max abs {err})")
    print(json.dumps({"serving_smoke_card_vs_cpu": {
        "arch": cfg.name, "steps": 1 + SMOKE_DECODE_STEPS, "max_abs_err": err,
        "tolerance": SMOKE_TOL, "greedy_tokens_equal": True}}))


def raw_bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers, for bit-for-bit comparisons."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def tree_map(fn, tree):
    """fn over the tensors of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def serving_phase(totals, seed):
    """Qwen3-MoE-30B-A3B at full width and depth (bfloat16, random weights
    drawn on the card from ``seed``) served through ``serve.generate`` once
    with each dispatch: launches held to the plans, the three prefill
    logits and sampled tokens bit-identical, the sampler's top-k held to
    the plain version; then the smoke config on the card against the CPU.
    The model is freed before the phase ends."""
    from repro_torch import configs
    from repro_torch.core.key_codec import codec_for
    from repro_torch.core.partial_sort import topk_batched
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import api

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    try:
        run, cfg = SERVE_RUN, configs.get_config(SERVE_ARCH).model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.from_numpy(
            serve.prompts(cfg, run["requests"], run["prompt_len"])).cuda()
        check_router_and_dispatch(model, tokens, cfg)
        served = {d: serve_once(model, tokens, cfg, d, seed, totals, init_s)
                  for d in SERVE_DISPATCHES}
        base_toks, base_logits = served["sample_sort"]
        for d, (toks, logits) in served.items():
            if not (torch.equal(toks, base_toks)
                    and torch.equal(raw_bits(logits), raw_bits(base_logits))):
                raise AssertionError(f"serve {d} differs from sample_sort")
        logits = base_logits.cuda()
        vals, idx = topk_batched(logits, run["topk"], serve.sampler_config(), device="cuda")
        codec = codec_for(logits.dtype, descending=True)
        tw, ti = ref.topk_desc(codec.encode(logits), run["topk"])
        err = max_abs_err((raw_bits(vals), idx), (raw_bits(codec.decode(tw)), ti))
        if err:
            raise AssertionError("the sampler's top-k differs from its plain version")
        print(json.dumps({"serving_identity": {
            "dispatches": list(SERVE_DISPATCHES), "prefill_logits_bit_identical": True,
            "tokens_identical": True, "sampler_topk_max_abs_err": err}}))
        profile_serving(model, tokens, cfg)
        del model, tokens, logits, vals, idx, served
        gc.collect()
        torch.cuda.empty_cache()
        smoke_card_vs_cpu(seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# Training: Qwen3-MoE-30B-A3B at full width, depth cut
# ----------------------------------------------------------------------

# Full width, 4 of 48 layers (3,077,588,992 parameters: the train state
# of all 48 is about 360 GB); train_4k's sequence, batch 2.  A checkpoint
# of that state is 30.8 GB, so the phase writes one, keeping its disk
# writes bounded: the straight run and the resumed driver save none
# (ckpt_every 0), the run they are compared with saves at step
# ckpt_every and stops there.
TRAIN_LAYERS = 4
TRAIN_RUN = dict(batch=2, seq=4096, steps=6, ckpt_every=3)
TRAIN_CLI = ("--arch", SERVE_ARCH, "--smoke", "--steps", "20", "--batch", "8",
             "--seq", "128")
# The resumed run after its first step, and the dispatches' gradient
# norms: the backward's scatter-adds may round differently from run to
# run (PERF.md §5); the resumed step and the dispatches' losses are held
# bit for bit.
TRAIN_RESUME_TOL = 1e-3
TRAIN_GNORM_RTOL = 1e-4
# Card against CPU, the smoke config in float32, TF32 off, one step:
# the loss within 1e-5; the parameters within 2 lr (an AdamW step moves
# an element by at most about lr, and a near-zero gradient may flip its
# sign).
TRAIN_SMOKE_LOSS_TOL = 1e-5


class TrainSpans:
    """CUDA events around each train step, and inside it around the
    forward (``api.loss_fn``), the backward (``Tensor.backward``) and the
    optimizer (``clip_by_global_norm`` and ``adamw_update``) while
    :meth:`patched` is on."""

    def __init__(self):
        self.spans = []  # (kind, start, end)

    def span(self, kind, fn):
        def call(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.spans.append((kind, a, b))
            return out
        return call

    @contextlib.contextmanager
    def patched(self):
        from repro_torch.launch import steps
        from repro_torch.models import api

        targets = [(api, "loss_fn", "forward"), (torch.Tensor, "backward", "backward"),
                   (steps, "clip_by_global_norm", "optimizer"),
                   (steps, "adamw_update", "optimizer")]
        saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
        for (owner, name, kind), (_, _, fn) in zip(targets, saved):
            setattr(owner, name, self.span(kind, fn))
        try:
            yield self
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)

    def per_step(self, kind) -> list[float]:
        """ms of ``kind`` a step, in step order (the spans between two
        "step" spans summed)."""
        out, acc = [], 0.0
        for k, a, b in self.spans:
            if k == "step":
                out.append(acc if kind != "step" else a.elapsed_time(b))
                acc = 0.0
            elif k == kind:
                acc += a.elapsed_time(b)
        return out


def train_driver(cfg, opt, path, seed, ckpt_every, spans=None, log=print):
    """A ``TrainDriver`` over ``launch/steps.build_train_step`` on the card,
    the weights drawn there from ``seed``, the data ``SyntheticDataset``
    (seed 0), as ``launch/train.py`` assembles it."""
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api, meta
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainDriver

    run = TRAIN_RUN
    step = build_train_step(cfg, opt)
    if spans is not None:
        step = spans.span("step", step)

    def step_fn(state, batch):
        params, opt_state, metrics = step(*state, batch)
        return (params, opt_state), metrics

    def init_state():
        params = meta.init_params(api.template(cfg),
                                  torch.Generator(device="cuda").manual_seed(seed), "cuda")
        return (params, adamw_init(params, opt))

    ds = SyntheticDataset(cfg.vocab, run["seq"], run["batch"], seed=0)
    return TrainDriver(step_fn, init_state, ds, ckpt_dir=str(path),
                       ckpt_every=ckpt_every, log_every=1, log_fn=log)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def train_cli(tmp: Path) -> dict:
    """``python -m repro_torch.launch.train`` with TRAIN_CLI on the card in
    a subprocess; its last loss must be finite."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
         "--ckpt-dir", str(tmp / "cli")],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)
    wall = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train] done: loss")]
    if proc.returncode or not done:
        raise AssertionError(f"launch.train failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    first, last = (float(x) for x in done[-1].split("loss ")[1].split(" -> "))
    if not math.isfinite(last):
        raise AssertionError(f"launch.train's last loss is {last}")
    return {"args": list(TRAIN_CLI), "wall_s": wall, "first_loss": first,
            "last_loss": last, "train_lines": sum(ln.startswith("[train]")
                                                  for ln in proc.stdout.splitlines())}


def train_smoke_card_vs_cpu(seed) -> dict:
    """The smoke config, float32, the same weights and batch on both
    devices: one ``build_train_step`` step on the card (kernels) and on
    the CPU (plain versions)."""
    from repro_torch import configs
    from repro_torch.config import OptimizerConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api, meta
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    cfg = configs.get_smoke(SERVE_ARCH)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=1)
    cpu = meta.init_params(api.template(cfg), torch.Generator().manual_seed(seed), "cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    batch = SyntheticDataset(cfg.vocab, 64, 4, seed=0).batch_at(0)
    out = {}
    for name, params in (("cpu", cpu), ("card", card)):
        _, _, m = build_train_step(cfg, opt)(params, adamw_init(params, opt), batch)
        out[name] = float(m["loss"])
    loss_err = abs(out["card"] - out["cpu"])
    param_err = max(float((a.cpu() - b).abs().max())
                    for (_, a), (_, b) in zip(leaves(card), leaves(cpu)))
    if loss_err > TRAIN_SMOKE_LOSS_TOL or param_err > 2 * opt.lr:
        raise AssertionError(f"smoke train step: card and CPU differ (loss {loss_err}, "
                             f"params {param_err})")
    return {"arch": cfg.name, "loss_cpu": out["cpu"], "loss_card": out["card"],
            "loss_abs_err": loss_err, "loss_tolerance": TRAIN_SMOKE_LOSS_TOL,
            "param_max_abs_err": param_err, "param_bound": 2 * opt.lr}


def training_phase(totals, seed):
    """Qwen3-MoE-30B-A3B at full width and TRAIN_LAYERS layers trained on the
    card through ``launch/train``'s parts: a straight run of TRAIN_RUN
    steps (launches held to the plans, every loss finite, timed and
    profiled), a run stopped at the first checkpoint and resumed by a new
    driver, one step with each other dispatch, the CLI in a subprocess,
    and the smoke config's step on the card against the CPU."""
    from repro_torch import configs
    from repro_torch.config import OptimizerConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api, meta
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    arch = configs.get_config(SERVE_ARCH)
    cfg = dataclasses.replace(arch.model, n_layers=TRAIN_LAYERS)
    run = TRAIN_RUN
    tokens = run["batch"] * run["seq"]
    opt = OptimizerConfig(total_steps=run["steps"], warmup_steps=1,
                          moment_dtype=arch.moment_dtype)
    per_step = training_launches(cfg, tokens)
    # The forward pass at these slots walks the serving prefill's plan.
    fwd = {k: v // 2 for k, v in per_step.items()}
    want_fwd = training_launches(dataclasses.replace(cfg, remat="none"), tokens)
    if fwd != want_fwd or set(per_step) != {"topk", "tile_sort", "splitter_partition"}:
        raise AssertionError(f"training plan launches {per_step}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    free_card()
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    tmp = Path(tmp_dir.name)
    try:
        # The straight run.
        spans, sorts, calls = TrainSpans(), SortSpans(), []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spans.patched(), sorts.patched(), library_sorts(calls):
            (state, hist), counts = counted(
                lambda: train_driver(cfg, opt, tmp / "straight", seed, 0, spans).run(
                    run["steps"]), totals)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        expect_launches("train", counts, {k: v * run["steps"] for k, v in per_step.items()})
        if calls:
            raise AssertionError(f"training called library sorts {calls}")
        losses = [h["loss"] for h in hist]
        if len(losses) != run["steps"] or not all(map(math.isfinite, losses)):
            raise AssertionError(f"training losses {losses}")
        params, opt_state = state
        n_params = sum(t.numel() for _, t in leaves(params))
        batch = SyntheticDataset(cfg.vocab, run["seq"], run["batch"], seed=0).batch_at(0)
        profile = device_profile(lambda: build_train_step(cfg, opt)(params, opt_state, batch),
                                 top_n=12)
        del state, params, opt_state
        free_card()

        step_ms = spans.per_step("step")[1:]
        parts = {k: statistics.median(spans.per_step(k)[1:])
                 for k in ("forward", "backward", "optimizer")}
        med = statistics.median(step_ms)
        k = cfg.moe.top_k
        router = [a.elapsed_time(b) for kind, r, a, b in sorts.spans if kind == "router"]
        dispatch = [a.elapsed_time(b) for kind, r, a, b in sorts.spans if kind == "dispatch"]
        per = len(router) // run["steps"]
        router_ms = statistics.median(sum(router[i:i + per]) for i in range(per, len(router), per))
        dispatch_ms = statistics.median(
            sum(dispatch[i:i + per]) for i in range(per, len(dispatch), per))
        print(json.dumps({"training": {
            "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "experts": cfg.moe.n_experts, "top_k": k, "vocab": cfg.vocab,
            "params": n_params, "template_params": meta.count_params(api.template(cfg)),
            "param_dtype": cfg.param_dtype, "moment_dtype": opt.moment_dtype,
            "remat": cfg.remat, "dispatch": cfg.moe.dispatch, **run,
            "tokens_per_step": tokens, "routed_slots": tokens * k,
            "step_ms_median": med, "step_ms": spans.per_step("step"),
            "tokens_per_s": tokens / med * 1e3, "peak_gb": peak / 1e9,
            "run_wall_s": wall,
            "ms": parts, "share": {kk: v / med for kk, v in parts.items()},
            "router_ms": router_ms, "dispatch_ms": dispatch_ms,
            "sort_share": (router_ms + dispatch_ms) / med,
            "launches_per_step": per_step, "launches": counts,
            "losses": losses, "gnorms": [h["gnorm"] for h in hist],
            "driver_dt_s": [h["dt"] for h in hist],
        }}))
        print(json.dumps({"training_profile": {"arch": cfg.name, "step": "train step",
                                               **profile}}))

        # Stopped after the first checkpoint, resumed by a new driver.
        (part, h1), c1 = counted(lambda: train_driver(
            cfg, opt, tmp / "resume", seed, run["ckpt_every"], log=lambda *_: None).run(
                run["ckpt_every"]), totals)
        del part
        free_card()
        logs = []
        t0 = time.perf_counter()
        (rest, h2), c2 = counted(lambda: train_driver(
            cfg, opt, tmp / "resume", seed, 0, log=logs.append).run(run["steps"]), totals)
        resume_s = time.perf_counter() - t0
        del rest
        free_card()
        shutil.rmtree(tmp / "resume")
        n1, n2 = run["ckpt_every"], run["steps"] - run["ckpt_every"]
        expect_launches("train, first part", c1, {k: v * n1 for k, v in per_step.items()})
        expect_launches("train, resumed", c2, {k: v * n2 for k, v in per_step.items()})
        first = h2[0]
        if (not any("resuming from checkpoint step 3" in ln for ln in logs)
                or first["step"] != n1 or first["loss"] != hist[n1]["loss"]):
            raise AssertionError(f"resumed step {first} differs from the straight run's "
                                 f"{hist[n1]}")
        later = max(abs(a["loss"] - b["loss"]) for a, b in zip(h2[1:], hist[n1 + 1:]))
        if later > TRAIN_RESUME_TOL or [h["loss"] for h in h1] != losses[:n1]:
            raise AssertionError(f"resumed run: later losses differ by {later}, first part "
                                 f"{[h['loss'] for h in h1]} against {losses[:n1]}")
        print(json.dumps({"training_resume": {
            "stopped_after_step": n1, "resumed_step_loss": first["loss"],
            "straight_step_loss": hist[n1]["loss"], "bit_equal": True,
            "first_part_bit_equal": True, "later_max_abs_diff": later,
            "tolerance": TRAIN_RESUME_TOL, "resumed_run_s": resume_s}}))

        # Step 0 with each other dispatch, from the same weights.
        steps0 = {"sample_sort": (hist[0]["loss"], hist[0]["gnorm"])}
        for d in SERVE_DISPATCHES[1:]:
            cfg_d = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=d))
            params = meta.init_params(api.template(cfg_d),
                                      torch.Generator(device="cuda").manual_seed(seed), "cuda")
            (_, _, m), cd = counted(lambda: build_train_step(cfg_d, opt)(
                params, adamw_init(params, opt), batch), totals)
            expect_launches(f"train step {d}", cd, {})
            steps0[d] = (float(m["loss"]), float(m["gnorm"]))
            del params, m
            free_card()
        base_loss, base_gnorm = steps0["sample_sort"]
        gn_err = max(abs(g - base_gnorm) / base_gnorm for _, g in steps0.values())
        if any(loss != base_loss for loss, _ in steps0.values()) or gn_err > TRAIN_GNORM_RTOL:
            raise AssertionError(f"step 0 differs across dispatches: {steps0}")
        print(json.dumps({"training_dispatches": {
            "step0": {d: {"loss": v[0], "gnorm": v[1]} for d, v in steps0.items()},
            "losses_bit_identical": True, "gnorm_max_rel_diff": gn_err,
            "gnorm_tolerance": TRAIN_GNORM_RTOL}}))

        print(json.dumps({"training_cli": train_cli(tmp)}))
        print(json.dumps({"training_smoke_card_vs_cpu": train_smoke_card_vs_cpu(seed)}))
    finally:
        tmp_dir.cleanup()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        free_card()


def main() -> int:
    start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--memory", action="store_true",
                        help="run the memory probe instead of the checks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops

    gpu = gpu_line()
    print(gpu)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})")

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.memory:
        memory_by_step(torch.from_numpy(
            rng.integers(-(2**31), 2**31, 1 << 26, dtype=np.int32)).cuda())
        fit = memory_ceiling(
            (1 << 27, 1 << 28, 5 << 26, 3 << 27, 1 << 29), gen)
        print(json.dumps({"largest_n_that_fits": fit}))
        print(gpu)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    cases = main_path_cases(rng)
    check_kernels({ln for case in cases for ln in case.launches}, gen)

    # Main path: counts set to 0 just before each run and read just after.
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for case in cases:
        dev_args = tuple(a.cuda() for a in case.args)
        ops.reset_launch_counts()
        out = case.fn(*dev_args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: sum(1 for x in case.launches if x[0] == k) for k in counts}
        if not case.check(out, *dev_args):
            raise AssertionError(f"{case.name}: differs from stable torch.sort")
        if counts != want:
            raise AssertionError(f"{case.name}: launches {counts}, plan {want}")
        for k, c in counts.items():
            totals[k] += c
        print(f"main path {case.name}: equal to stable torch.sort, "
              f"launches {counts}")
        del out, dev_args
    for k, c in totals.items():
        if c == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    for case in cases:
        dev_args = tuple(a.cuda() for a in case.args)
        n = dev_args[0].numel()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(lambda: case.fn(*dev_args), 3)
        peak = torch.cuda.max_memory_allocated()
        lib_ms = time_ms(lambda: case.library(*dev_args), 3)
        print(json.dumps({
            "main_path": case.name, "n": n, "ms": ms,
            "mkeys_per_s": n / ms / 1e3,
            "peak_bytes": peak, "peak_bytes_above_inputs": peak - base,
            "library_ms": lib_ms,
            "library_mkeys_per_s": n / lib_ms / 1e3,
        }))
        del dev_args

    profile_main_path(cases[0])
    profile_main_path(cases[6])  # the batched top-k of the serving case
    profile_main_path(cases[10])  # the 2^26 sort through K5

    # Guarded execution, the segmented sort and the baselines, each run
    # counted as the main path's are.
    segmented_phase(rng, totals)
    checked_phase(cases[0].args[0], cases[6].args[0], totals)
    faults_phase(totals)
    comparison_phase(rng, totals)
    autotune_phase(rng, totals)
    distributed_phase(rng, totals)
    serving_phase(totals, args.seed)
    training_phase(totals, args.seed)

    rows = [kernel_row(*entry, gen, totals[entry[0]])
            for entry in kernel_table()]
    print(json.dumps({"script_wall_s": time.perf_counter() - start}))
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
