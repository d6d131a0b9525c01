"""Card-only tests of the CUDA kernels and the main path on them.

Marked ``gpu``; each takes the ``cuda`` fixture, which skips when no
card is present (decided when the test runs, never at import).  On a
machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_chip.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.Generator(device="cuda").manual_seed(0)


def tiles(gen, m, t, nw):
    words = tuple(
        torch.randint(-8, 8, (m, t), generator=gen, device="cuda",
                      dtype=torch.int32) for _ in range(nw)
    )
    vals = torch.argsort(torch.rand((m, t), generator=gen, device="cuda"),
                         dim=1).to(torch.int32)
    return words, vals


# Every power-of-two row width, so that the in-thread, shuffle and
# shared-memory strides of the register network meet at every boundary.
WIDTHS = [1 << k for k in range(1, 15)]


def full_range_payloads(gen, words):
    """Payloads over the whole int32 range, repeats allowed: negative ones
    exercise the packed key's bias."""
    return torch.randint(-(2**31), 2**31 - 1, words[0].shape, generator=gen,
                         device="cuda", dtype=torch.int32)


@pytest.mark.parametrize("payloads", ["permutation", "full_range"])
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,s", sorted(
    {(2, 0), (64, 8), (4096, 64), (8192, 64), (16384, 0)}
    | {(t, s) for t in WIDTHS for s in (0, min(64, t))}))
def test_tile_sort_kernel_equals_plain_version(cuda, t, s, nw, payloads):
    from repro_torch.kernels import bitonic

    words, vals = tiles(cuda, max(1, (1 << 20) // t), t, nw)
    if payloads == "full_range":
        vals = full_range_payloads(cuda, words)
    before = bitonic.LAUNCHES.count
    if s:
        got = bitonic.sort_tiles_sample_kv(words, vals, num_samples=s)
    else:
        got = bitonic.sort_tiles_kv(words, vals)
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES.count == before + 1
    pw, pv = bitonic.bitonic_network_rows(words, vals)
    assert len(got[0]) == nw
    assert all(torch.equal(a, b) for a, b in zip(got[0], pw))
    assert torch.equal(got[1], pv)
    if s:
        assert torch.equal(got[3], bitonic.take_samples(pv, s))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("t,num_splitters", [
    (4096, 63), (4096, 7), (64, 3), (2, 1), (32, 7), (32, 40), (16384, 63),
    (4096, 1), (1024, 100), (8, 5),
])
def test_splitter_partition_kernel_equals_plain_version(cuda, t, num_splitters, nw):
    """K2 on sorted tiles with sorted splitters drawn from them (repeats
    among them), payloads moved by -1, 0 or 1; T <= 32 is one window."""
    from repro_torch.kernels import bitonic, ref, splitter

    m = max(1, (1 << 20) // t) + 1  # the last CTA's tiles partly masked
    sk, sv = bitonic.sort_tiles_kv(*tiles(cuda, m, t, nw))
    pick = torch.sort(torch.randint(0, t, (m, num_splitters), generator=cuda,
                                    device="cuda"), dim=1).values
    sp = tuple(torch.gather(w, 1, pick) for w in sk)
    spv = torch.gather(sv, 1, pick) + torch.randint(
        -1, 2, pick.shape, generator=cuda, device="cuda", dtype=torch.int32)
    before = splitter.LAUNCHES.count
    got = splitter.splitter_partition_cuda(sk, sv, sp, spv)
    torch.cuda.synchronize()
    assert splitter.LAUNCHES.count == before + 1
    want = splitter.splitter_partition(sk, sv, sp, spv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ref.splitter_partition(sk, sv, sp, spv)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_main_path_equals_stable_torch_sort(cuda, dtype):
    from repro_torch.core import bucket_sort
    from repro_torch.kernels import ops

    x = torch.randint(-1000, 1000, (300_000,), generator=cuda, device="cuda").to(dtype)
    ops.reset_launch_counts()
    perm = bucket_sort.argsort(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["tile_sort"] > 0 and counts["splitter_partition"] > 0
    assert torch.equal(perm.long(), torch.sort(x, stable=True).indices)
    assert torch.equal(bucket_sort.sort(x), torch.sort(x, stable=True).values)


def ranks_splitters(gen, words, vals, num_splitters, order):
    """Splitters drawn from the tiles (payloads moved by -1, 0 or 1),
    sorted or not; "repeated" repeats each of them, unsorted."""
    m, t = vals.shape
    if order == "repeated":
        pick = torch.randint(0, t, (m, (num_splitters + 1) // 2), generator=gen,
                             device="cuda").repeat_interleave(2, 1)[:, :num_splitters]
        pick = torch.gather(pick, 1, torch.argsort(torch.rand(
            pick.shape, generator=gen, device="cuda"), dim=1))
        return (tuple(torch.gather(w, 1, pick) for w in words),
                torch.gather(vals, 1, pick))
    pick = torch.randint(0, t, (m, num_splitters), generator=gen, device="cuda")
    if order == "sorted":
        pick = torch.sort(pick, dim=1).values
    sp = tuple(torch.gather(w, 1, pick) for w in words)
    return sp, torch.gather(vals, 1, pick) + torch.randint(
        -1, 2, pick.shape, generator=gen, device="cuda", dtype=torch.int32)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("order", ["sorted", "unsorted", "repeated"])
@pytest.mark.parametrize("t,num_splitters", [
    (4096, 63), (64, 3), (256, 1100), (4096, 1), (1024, 100), (2, 5),
    (16384, 63),
])
def test_splitter_ranks_kernel_equals_plain_version(cuda, t, num_splitters, order, nw):
    """K3 right on unsorted tiles and unsorted or repeated splitters, and
    on more splitters than it stages in shared memory at once (1024)."""
    from repro_torch.kernels import bitonic, ref, splitter

    m = max(1, (1 << 18) // t)
    words, vals = tiles(cuda, m, t, nw)
    if order == "sorted":
        words, vals = bitonic.sort_tiles_kv(words, vals)
    sp, spv = ranks_splitters(cuda, words, vals, num_splitters, order)
    before = splitter.RANKS_LAUNCHES.count
    got = splitter.splitter_ranks_cuda(words, vals, sp, spv)
    torch.cuda.synchronize()
    assert splitter.RANKS_LAUNCHES.count == before + 1
    assert torch.equal(got, splitter.splitter_ranks(words, vals, sp, spv))
    assert torch.equal(got, ref.splitter_ranks(words, vals, sp, spv))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("order", ["sorted", "unsorted", "repeated"])
@pytest.mark.parametrize("num_splitters", [1, 7])
def test_splitter_ranks_kernel_splits_a_lone_tile(cuda, num_splitters, order, nw):
    """One tile of 2^22 elements is cut across CTAs whose partial ranks
    add up in the output."""
    from repro_torch.kernels import ref, splitter

    t = 1 << 22
    assert splitter.ranks_geometry(1, t)[0] > 1
    words, vals = tiles(cuda, 1, t, nw)
    if order == "sorted":
        words, vals = ref.sort_tiles_kv(words, vals)
    sp, spv = ranks_splitters(cuda, words, vals, num_splitters, order)
    before = splitter.RANKS_LAUNCHES.count
    got = splitter.splitter_ranks_cuda(words, vals, sp, spv)
    torch.cuda.synchronize()
    assert splitter.RANKS_LAUNCHES.count == before + 1
    assert torch.equal(got, splitter.splitter_ranks(words, vals, sp, spv))
    assert torch.equal(got, ref.splitter_ranks(words, vals, sp, spv))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("c,k", sorted(
    {(1, 1), (16, 6), (128, 8), (1024, 1), (16384, 50)}
    | {(c, k) for c in [1] + WIDTHS for k in (1, min(8, c), c)}))
def test_topk_kernel_equals_plain_version(cuda, c, k, nw):
    """Every power-of-two row width, so that a row lies in one thread, in
    one warp's registers or across warps; k of 1, 8 and the whole row."""
    from repro_torch.kernels import ref, topk

    rows = max(3, (1 << 18) // c) + 1  # not a multiple of the rows per CTA
    words, _ = tiles(cuda, rows, c, nw)
    before = topk.LAUNCHES.count
    got = topk.topk_desc_cuda(words, k)
    torch.cuda.synchronize()
    assert topk.LAUNCHES.count == before + 1
    for want in (topk.topk_desc(words, k), ref.topk_desc(words, k)):
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1])


def test_top_k_entry_points_equal_stable_descending_sort(cuda):
    """topk_batched, topk and ops.topk on the card against stable
    descending torch.sort, whose ties go to the smaller index."""
    from repro_torch.core import partial_sort
    from repro_torch.kernels import ops

    x = torch.randn((8, 151_936), generator=cuda, device="cuda")
    x = x.to(torch.bfloat16).float()  # ties
    want = torch.sort(x, dim=1, descending=True, stable=True)
    ops.reset_launch_counts()
    v, i = partial_sort.topk_batched(x, 50)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["tile_sort"] == 3 and counts["splitter_ranks"] == 1
    assert torch.equal(v, want.values[:, :50])
    assert torch.equal(i.long(), want.indices[:, :50])
    v, i = partial_sort.topk_batched(x[:, :1], 1)  # one column: K1 at T = 2
    assert torch.equal(v, x[:, :1]) and not i.any()
    flat = x.reshape(-1)[: 1 << 20]
    v, i = partial_sort.topk(flat, 1024)
    want = torch.sort(flat, descending=True, stable=True)
    assert torch.equal(v, want.values[:1024])
    assert torch.equal(i.long(), want.indices[:1024])
    r = x[:, :128].reshape(-1, 64)
    v, i = ops.topk(r, 6)
    want = torch.sort(r, dim=1, descending=True, stable=True)
    assert torch.equal(v, want.values[:, :6])
    assert torch.equal(i.long(), want.indices[:, :6])


def test_unfused_ranking_sort_equals_stable_torch_sort(cuda):
    from repro_torch.core import SortConfig, bucket_sort
    from repro_torch.kernels import ops

    x = torch.randint(-1000, 1000, (300_000,), generator=cuda, device="cuda",
                      dtype=torch.int32)
    ops.reset_launch_counts()
    out = bucket_sort.sort(x, SortConfig(fuse_ranking=False))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["splitter_ranks"] > 0 and counts["splitter_partition"] == 0
    assert torch.equal(out, torch.sort(x, stable=True).values)


@pytest.mark.parametrize("strategy", ["bitonic", "radix", "merge"])
def test_unfused_sampling_sort_equals_stable_torch_sort(cuda, strategy):
    """fuse_sampling=False at 2^20: the 16,384 samples sliced from the
    sorted tiles (256 tiles x 64) reach the sample level's tile sort
    unpadded, as the slice left them."""
    from repro_torch.core import SortConfig, bucket_sort

    x = torch.randint(-(2**31), 2**31 - 1, (1 << 20,), generator=cuda,
                      device="cuda", dtype=torch.int32)
    cfg = SortConfig(fuse_sampling=False, fuse_ranking=False, strategy=strategy)
    assert torch.equal(bucket_sort.sort(x, cfg), torch.sort(x, stable=True).values)


def test_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import ops

    words, vals = tiles(cuda, 1, 32768, 1)
    with pytest.raises(ValueError, match="power of two"):
        ops.sort_tiles(words, vals)
    words, vals = tiles(cuda, 64, 64, 1)
    with pytest.raises(ValueError, match="contiguous int32"):
        ops.sort_tiles(words[0].t().contiguous().t(), vals)
    with pytest.raises(ValueError, match="contiguous int32"):
        ops.sort_tiles(words[0].long(), vals)


@pytest.mark.parametrize("kernel", ["tile_sort", "merge_sort"])
@pytest.mark.parametrize("t", [2, 4096])
def test_row_sort_kernels_take_rows_not_16_byte_aligned(cuda, t, kernel):
    """Rows that start one row into their storage: at T = 2 the pointers
    are 8 bytes off 16, and the kernels load and store them one element
    at a time instead of with 16-byte accesses."""
    from repro_torch.kernels import bitonic, merge

    words, vals = tiles(cuda, 2049, t, 1)
    words, vals = (words[0][1:],), vals[1:]
    assert (vals.data_ptr() % 16 == 8) == (t == 2) and vals.is_contiguous()
    if kernel == "tile_sort":
        got = bitonic.sort_tiles_sample_kv(words, vals, num_samples=2)
        want = bitonic.bitonic_network_rows(words, vals)
    else:
        got = merge.sort_tiles_sample_kv(words, vals, num_samples=2, merge_run=2)
        want = merge.merge_sort_rows(words, vals, merge_run=2)
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[3], want[1][:, t // 2 - 1::t // 2])


def random_payload_tiles(gen, m, t, nw):
    """Random key words and random (not unique) payloads: K5 and K6 are
    defined for any payload, and so are their plain versions."""
    words = tuple(
        torch.randint(-(2**31), 2**31 - 1, (m, t), generator=gen, device="cuda",
                      dtype=torch.int32) for _ in range(nw)
    )
    vals = torch.randint(-(2**31), 2**31 - 1, (m, t), generator=gen,
                         device="cuda", dtype=torch.int32)
    return words, vals


@pytest.mark.parametrize("data", ["duplicates", "random",
                                  "duplicates_random_payloads"])
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("radix_bits", [1, 2, 4])
@pytest.mark.parametrize("t,s", sorted(
    {(2, 0), (16, 4), (64, 8), (4096, 64), (16384, 0)}
    | {(t, 0 if k % 2 else min(16, t)) for k, t in enumerate(WIDTHS)}))
def test_radix_sort_kernel_equals_plain_version(cuda, t, s, radix_bits, nw, data):
    """The kernel ranks 8-bit digits whatever radix_bits says; a stable
    sort has one result.  Random payloads under duplicate keys show that
    it is stable: it compares the key words only."""
    from repro_torch.kernels import radix

    make = tiles if data.startswith("duplicates") else random_payload_tiles
    # Odd row counts for narrow rows: fewer rows share a CTA.
    words, vals = make(cuda, max(1, (1 << 17) // t) + (t < 64), t, nw)
    if data == "duplicates_random_payloads":
        vals = full_range_payloads(cuda, words)
    before = radix.LAUNCHES.count
    if s:
        got = radix.sort_tiles_sample_kv(words, vals, num_samples=s,
                                         radix_bits=radix_bits)
    else:
        got = radix.sort_tiles_kv(words, vals, radix_bits=radix_bits)
    torch.cuda.synchronize()
    assert radix.LAUNCHES.count == before + 1
    pw, pv = radix.radix_sort_rows(words, vals, radix_bits=radix_bits)
    assert all(torch.equal(a, b) for a, b in zip(got[0], pw))
    assert torch.equal(got[1], pv)
    if s:
        assert torch.equal(got[3], pv[:, t // s - 1::t // s])


@pytest.mark.parametrize("data", ["duplicates", "random",
                                  "duplicates_random_payloads"])
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("merge_run", [2, 64, 512, 32768])
@pytest.mark.parametrize("t,s", sorted(
    {(2, 0), (16, 4), (64, 8), (4096, 64), (16384, 0), (16384, 64)}
    | {(t, 0 if k % 2 else min(16, t)) for k, t in enumerate(WIDTHS)}))
def test_merge_sort_kernel_equals_plain_version(cuda, t, s, merge_run, nw, data):
    """merge_run 32768 is at least every T: K6 is then K1.  Random
    payloads under duplicate keys show that the merge compares the key
    words only."""
    from repro_torch.kernels import merge

    make = tiles if data.startswith("duplicates") else random_payload_tiles
    words, vals = make(cuda, max(1, (1 << 17) // t) + (t < 64), t, nw)
    if data == "duplicates_random_payloads":
        vals = full_range_payloads(cuda, words)
    before = merge.LAUNCHES.count
    if s:
        got = merge.sort_tiles_sample_kv(words, vals, num_samples=s,
                                         merge_run=merge_run)
    else:
        got = merge.sort_tiles_kv(words, vals, merge_run=merge_run)
    torch.cuda.synchronize()
    assert merge.LAUNCHES.count == before + 1
    pw, pv = merge.merge_sort_rows(words, vals, merge_run=merge_run)
    assert all(torch.equal(a, b) for a, b in zip(got[0], pw))
    assert torch.equal(got[1], pv)
    if s:
        assert torch.equal(got[3], pv[:, t // s - 1::t // s])


@pytest.mark.parametrize("strategy", ["radix", "merge"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_strategy_main_path_equals_stable_torch_sort(cuda, dtype, strategy):
    from repro_torch.core import SortConfig, bucket_sort, partial_sort
    from repro_torch.kernels import ops

    cfg = SortConfig(strategy=strategy)
    x = torch.randint(-1000, 1000, (300_000,), generator=cuda, device="cuda").to(dtype)
    ops.reset_launch_counts()
    perm = bucket_sort.argsort(x, cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    sorter = "radix_sort" if strategy == "radix" else "merge_sort"
    assert counts[sorter] > 0 and counts["tile_sort"] == 0
    assert torch.equal(perm.long(), torch.sort(x, stable=True).indices)
    unfused = SortConfig(strategy=strategy, fuse_sampling=False)
    assert torch.equal(bucket_sort.sort(x, unfused), torch.sort(x, stable=True).values)
    y = x[: 8 * 20_000].reshape(8, -1).float()
    v, i = partial_sort.topk_batched(y, 50, cfg)
    want = torch.sort(y, dim=1, descending=True, stable=True)
    assert torch.equal(v, want.values[:, :50])
    assert torch.equal(i.long(), want.indices[:, :50])


def test_router_top_k_of_rows_wider_than_a_cta(cuda):
    """ops.topk of rows that pad past 16,384 columns: the executor sorts
    them (K1 and K2), no longer a ValueError."""
    from repro_torch.kernels import ops

    x = torch.randn((4, 20_000), generator=cuda, device="cuda")
    x = x.to(torch.bfloat16).float()  # ties
    ops.reset_launch_counts()
    v, i = ops.topk(x, 9)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["topk"] == 0 and counts["tile_sort"] > 0
    want = torch.sort(x, dim=1, descending=True, stable=True)
    assert torch.equal(v, want.values[:, :9])
    assert torch.equal(i.long(), want.indices[:, :9])


def count_library_sorts(monkeypatch):
    """Every call of torch's sorts and top-k from here on, by name."""
    calls = []
    for owner in (torch, torch.Tensor):
        for name in ("sort", "argsort", "topk"):
            def counted(*args, _fn=getattr(owner, name), _name=name, **kwargs):
                calls.append(_name)
                return _fn(*args, **kwargs)
            monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("check", ["bounds", "full"])
def test_checked_sorts_on_the_card(cuda, check):
    from repro_torch.core import SortConfig, bucket_sort, guard, partial_sort

    x = torch.randint(-1000, 1000, (300_000,), generator=cuda, device="cuda",
                      dtype=torch.int32)
    y = torch.randn((8, 151_936), generator=cuda, device="cuda")
    y = y.to(torch.bfloat16).float()  # ties
    want = torch.sort(x, stable=True)
    want_k = torch.sort(y, dim=1, descending=True, stable=True)
    guard.clear_degradation_log()
    cfg = SortConfig(check=check)
    srt, perm, stats = bucket_sort.sort_with_stats(x, cfg)
    assert torch.equal(srt, want.values)
    assert torch.equal(perm.long(), want.indices)
    assert stats and all(int(st["totals"].max()) <= st["capacity"] for st in stats)
    v, i = partial_sort.topk_batched(y, 50, cfg)
    assert torch.equal(v, want_k.values[:, :50])
    assert torch.equal(i.long(), want_k.indices[:, :50])
    assert guard.degradation_log() == ()


def test_card_chain_retries_the_plan_then_raises(cuda, monkeypatch):
    """On the card a failed kernel is retried once with the same plan, then
    raised as a SortRuntimeError naming the node and the kernel; no rung
    reaches a library sort (ROADMAP.md D8)."""
    from repro_torch.core import bucket_sort, faults, guard, partial_sort
    from repro_torch.kernels import ops

    x = torch.randint(-(2**31), 2**31 - 1, (1 << 20,), generator=cuda,
                      device="cuda", dtype=torch.int32)
    y = torch.randn((8, 151_936), generator=cuda, device="cuda")
    want = torch.sort(x, stable=True).values
    want_k = torch.sort(y, dim=1, descending=True, stable=True)
    guard.clear_degradation_log()
    faults.reset()
    calls = count_library_sorts(monkeypatch)
    try:
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=1):
                ops.reset_launch_counts()
                out = bucket_sort.sort(x)
                torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert [ev.action for ev in guard.degradation_log()] == ["retry"]
        assert ops.launch_counts()["splitter_partition"] > 0
        guard.clear_degradation_log()
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=2):
                with pytest.raises(guard.SortRuntimeError) as ei:
                    bucket_sort.sort(x)
        err = ei.value
        assert "/top:bucket(" in err.site and err.site.endswith(":tile_sort")
        assert isinstance(err.__cause__, guard.SortRuntimeError)
        assert isinstance(err.__cause__.__cause__, faults.FaultInjected)
        assert len(guard.degradation_log()) == 1
        guard.clear_degradation_log()
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=1):
                v, i = partial_sort.topk_batched(y, 50)
        assert torch.equal(v, want_k.values[:, :50])
        assert torch.equal(i.long(), want_k.indices[:, :50])
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=2):
                with pytest.raises(guard.SortRuntimeError, match="tile_sort"):
                    partial_sort.topk_batched(y, 50)
    finally:
        faults.reset()
        guard.clear_degradation_log()
    assert calls == []


def test_card_reports_a_capacity_below_the_fills(cuda):
    from repro_torch.core import SortConfig, bucket_sort, build_plan, guard

    x = torch.randint(-(2**31), 2**31 - 1, (1 << 19,), generator=cuda,
                      device="cuda", dtype=torch.int32)
    # The widest direct child a row sort takes: 16,384 = cap.
    plan = build_plan(1 << 19, torch.int32, SortConfig(direct_max=1 << 14))
    root = plan.root
    assert root.kind == "bucket" and root.bucket_plan.kind == "direct"
    child = dataclasses.replace(root.bucket_plan, length=128, lp=128)
    bad = dataclasses.replace(
        plan, root=dataclasses.replace(root, cap=128, bucket_plan=child))
    with pytest.raises(guard.SortRuntimeError) as ei:
        bucket_sort.sort_planned(x, bad, check="bounds")
    assert ei.value.invariant == "bucket_fill <= cap" and "cap=128" in ei.value.site
    torch.cuda.synchronize()  # the context survived: nothing read past a row
    assert torch.equal(bucket_sort.sort_planned(x, plan, check="full"),
                       torch.sort(x).values)


def test_segmented_sort_equals_per_segment_torch_sort(cuda):
    import numpy as np

    from repro_torch.core import DEFAULT_CONFIG, bucket_sort, build_plan
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    lens = rng.integers(0, 3000, 200)
    lens[:4] = (0, 1, 20_000, 9000)  # empty, one key, past direct_max
    off = np.concatenate([[0], np.cumsum(lens)])
    x = torch.randint(-1000, 1000, (int(off[-1]),), generator=cuda,
                      device="cuda", dtype=torch.int32)
    seg = torch.repeat_interleave(torch.arange(200, device="cuda"),
                                  torch.from_numpy(lens).cuda())
    want = torch.sort((seg << 32) | (x.long() + 2**31), stable=True).indices
    ops.reset_launch_counts()
    perm = bucket_sort.segment_argsort(x, off)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    plan = build_plan(20_000, torch.int32, DEFAULT_CONFIG, rows=200)
    assert plan.num_levels == 1
    assert counts["tile_sort"] == 3 and counts["splitter_partition"] == 1
    assert torch.equal(perm.long(), want)
    assert torch.equal(bucket_sort.segment_sort(x, off), x[want])
    with pytest.raises(ValueError, match="host data"):
        bucket_sort.segment_sort(x, torch.from_numpy(off).cuda())


def test_randomized_baseline_runs_its_kernels(cuda):
    """The randomized sample sort's round on the card (K1 for the tiles and
    the sample row, K3 for the ranks) equals its plain version on the CPU
    given the same sample positions; merge_sort runs K1 once."""
    from repro_torch.core import SortConfig, baselines, codec_for
    from repro_torch.kernels import ops

    x = torch.randint(-1000, 1000, (1 << 20,), generator=cuda, device="cuda",
                      dtype=torch.int32)
    want = torch.sort(x, stable=True)
    ops.reset_launch_counts()
    srt, perm, (mf, ovf) = baselines.randomized_sample_sort(
        x, torch.Generator(device="cuda").manual_seed(0), with_stats=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert int(ovf) == 0 and counts["tile_sort"] == 2
    assert counts["splitter_ranks"] == 1
    assert torch.equal(srt, want.values) and torch.equal(perm.long(), want.indices)
    for factor in (4.0, 0.5):  # 0.5 overflows: dropped elements
        kw = codec_for(torch.int32).encode(x[: 1 << 16])
        idx = torch.randint(0, 1 << 16, (8 * 64,), generator=cuda, device="cuda")
        card = baselines._randomized_canonical(kw, idx, SortConfig(), factor, True)
        cpu = baselines._randomized_canonical(
            tuple(w.cpu() for w in kw), idx.cpu(), SortConfig(), factor, True)
        assert torch.equal(card[0][0].cpu(), cpu[0][0])
        assert torch.equal(card[1].cpu(), cpu[1])
        assert [int(a) for a in card[2]] == [int(a) for a in cpu[2]]
    ops.reset_launch_counts()
    srt, perm = baselines.merge_sort(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tile_sort"] == 1
    assert torch.equal(srt, want.values) and torch.equal(perm.long(), want.indices)


@pytest.mark.parametrize("log2n", [20, 26])
def test_autotuned_sort_on_the_card(cuda, log2n, tmp_path, monkeypatch):
    """sort(x, plan="autotune") against a fresh store: the cold call
    measures the five cheapest predicted candidates (the base among them)
    on the card and runs the winner; a warm call measures nothing and runs
    the same plan object; a plan file written by save_plan runs an equal
    plan; the output equals stable torch.sort and no library sort runs."""
    from repro_torch.core import SortConfig, autotune, bucket_sort, faults
    from repro_torch.core.plan import plan_launches
    from repro_torch.kernels import ops

    monkeypatch.setenv("REPRO_TORCH_SORT_PLAN_CACHE", str(tmp_path / "plans.json"))
    autotune.clear_memo()
    faults.reset()
    x = torch.randint(-(2**31), 2**31 - 1, (1 << log2n,), generator=cuda,
                      device="cuda", dtype=torch.int32)
    want = torch.sort(x, stable=True).values
    cfg = SortConfig(plan="autotune")
    calls = count_library_sorts(monkeypatch)
    assert torch.equal(bucket_sort.sort(x, cfg), want)
    assert faults.hits("autotune.measure") == 5
    winner = bucket_sort.resolve_plan(x.shape[0], x.dtype, cfg, device="cuda")
    faults.reset()
    ops.reset_launch_counts()
    assert torch.equal(bucket_sort.sort(x, cfg), want)
    torch.cuda.synchronize()
    assert {k: c for k, c in ops.launch_counts().items() if c} == dict(
        plan_launches(winner))
    assert faults.hits("autotune.measure") == 0
    assert bucket_sort.resolve_plan(x.shape[0], x.dtype, cfg, device="cuda") is winner
    path = str(tmp_path / "winner.json")
    autotune.save_plan(winner, path)
    assert torch.equal(bucket_sort.sort(x, SortConfig(plan=path)), want)
    assert autotune.load_plan(path) == winner
    assert calls == []
    autotune.clear_memo()


def test_cost_model_ranks_the_calibration_slice(cuda):
    """The cost model's acceptance on the card: over the 11 candidates
    around DEFAULT_CONFIG at 2^26 int32 keys, each measured (median of 3
    after a warm-up), Spearman rho of predicted against measured is at
    least 0.6, and the measured winner is among the five cheapest
    predicted candidates or is the base."""
    from repro_torch.core import DEFAULT_CONFIG, autotune, cost_model

    res = autotune.autotune(1 << 26, torch.int32, DEFAULT_CONFIG, device="cuda",
                            measure_budget=None)
    assert not res.failed and len(res.candidates) == 11
    pred = [c.predicted for c in res.candidates]
    meas = [c.us_per_call for c in res.candidates]
    rho = cost_model.spearman(pred, meas)
    table = [(c.label, c.predicted, c.us_per_call) for c in res.candidates]
    assert rho >= 0.6, (rho, table)
    five = sorted(range(len(pred)), key=lambda i: (pred[i], i))[:5]
    winner = min(range(len(meas)), key=meas.__getitem__)
    assert winner in five or winner == 0, table


def test_two_rank_sort_on_the_card(cuda, tmp_path):
    """Two rank processes on cuda:0 and one gloo group (gloo copies the
    CUDA tensors through host memory): each run's valid prefixes, in rank order,
    equal stable torch.sort of the whole array on the card, its payloads
    the permutation, max_within < c_pair and the launches the ShardPlan's
    walk.  Then collective.exchange failing on rank 0 at every hit: one
    retry, then a SortRuntimeError on both ranks naming the site and the
    plan, with no host sort and no library sort (ROADMAP.md D8)."""
    import numpy as np
    import torch_ranks

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh

    _build.build()
    rng = np.random.default_rng(0)
    inputs = dict(
        a=rng.integers(-(2**31), 2**31 - 1, 1 << 20, dtype=np.int64).astype(np.int32),
        b=rng.integers(-50, 50, 1 << 18, dtype=np.int64))
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = mesh.run_ranks(torch_ranks.card_sort, 2, dict(
        data=str(tmp_path / "inputs.npz"), cells=[("a", False), ("b", True)],
        fault=True), timeout_s=120, deadline_s=600)
    for name, desc in (("a", False), ("b", True)):
        outs = [r[torch_ranks.cell_id(name, desc)] for r in ranks]
        keys = np.concatenate([o["keys"][:o["count"]] for o in outs])
        vals = np.concatenate([o["vals"][:o["count"]] for o in outs])
        want = torch.sort(torch.from_numpy(inputs[name]).cuda(), stable=True,
                          descending=desc)
        assert torch.equal(torch.from_numpy(keys).cuda(), want.values)
        assert torch.equal(torch.from_numpy(vals).cuda().long(), want.indices)
        for o in outs:
            assert o["max_within"] < o["c_pair"]
            assert o["launches_equal"]
    for r in ranks:
        fault = r["fault"]
        assert fault["error"] is not None, "the double fault did not raise"
        assert fault["error"]["site"].startswith("collective.exchange[D=2]:ShardPlan(")
        assert fault["log"] == ["retry"] and fault["calls"] == []


# ----------------------------------------------------------------------
# Serving: the attention + MoE decoder on the card
# ----------------------------------------------------------------------


def test_smoke_serve_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The smoke config (float32) with the same weights on both devices:
    prefill and four greedy decode steps through the kernels on the card
    and the plain versions on the CPU agree within 1e-4 with TF32 off (the
    same ops summed in other orders over two layers), and the greedy
    tokens are equal."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api, meta
    from repro_torch.models.transformer import CausalLM

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"):
        cfg = configs.get_smoke(arch)
        params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
        card = CausalLM(cfg, _tree_to(params, "cuda"))
        host = CausalLM(cfg, params)
        prompt = torch.from_numpy(serve.prompts(cfg, 4, 40))
        lc, cc = api.prefill(card, {"tokens": prompt.cuda()}, cfg, 44)
        lh, ch = api.prefill(host, {"tokens": prompt}, cfg, 44)
        for i in range(5):
            torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
            tc, th = lc.argmax(-1), lh.argmax(-1)
            assert torch.equal(tc.cpu(), th)
            if i < 4:
                lc, cc = api.decode_step(card, tc[:, None], cc, 40 + i, cfg)
                lh, ch = api.decode_step(host, th[:, None], ch, 40 + i, cfg)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_dispatches_are_bit_identical_on_the_card(cuda):
    """Qwen3-MoE-30B-A3B at full width, two layers deep, bfloat16: a serve
    with each dispatch (K4 and the sample sort; a stable library sort and
    argsort; the one-hot rank) gives bit-identical prefill logits and the
    same sampled tokens; the 16,384 prefill ids take a bucket round."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api

    full = configs.get_config("qwen3-moe-30b-a3b").model
    tokens = torch.from_numpy(serve.prompts(full, 2, 1024)).cuda()
    model, outs = None, {}
    for dispatch in ("sample_sort", "xla_sort", "onehot"):
        cfg = dataclasses.replace(full, n_layers=2, moe=dataclasses.replace(
            full.moe, dispatch=dispatch))
        if model is None:
            model = api.init_model(cfg, torch.Generator("cuda").manual_seed(0))
        outs[dispatch] = serve.generate(
            model, tokens, cfg, gen=4, topk=8, temperature=0.8,
            generator=torch.Generator("cuda").manual_seed(1))
    base = outs["sample_sort"]
    assert bool(torch.isfinite(base.prefill_logits).all())
    for out in outs.values():
        assert torch.equal(out.prefill_logits.view(torch.int16),
                           base.prefill_logits.view(torch.int16))
        assert torch.equal(out.tokens, base.tokens)


def test_new_entry_points_default_to_cuda():
    """device=None means "cuda": on a card the model, its caches and the
    interop land there; without one each raises (this runs on the CPU)."""
    from repro_torch import configs, interop
    from repro_torch.launch import serve
    from repro_torch.models import api, meta

    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    host = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = interop.params_to_jax(host)
    tpl = api.template(cfg)
    if not torch.cuda.is_available():
        for call in (lambda: api.init_model(cfg, torch.Generator()),
                     lambda: meta.init_params(tpl, torch.Generator()),
                     lambda: api.init_cache(cfg, 2, 8),
                     lambda: interop.params_from_jax(tree, cfg),
                     lambda: serve.main(["--arch", cfg.name[:-len("-smoke")], "--smoke"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        return
    model = api.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    assert all(p.is_cuda for p in model.parameters())
    assert all(c["k"].is_cuda for c in api.init_cache(cfg, 2, 8))
    assert all(p.is_cuda for p in interop.params_from_jax(tree, cfg).parameters())


def test_serving_faults_retry_then_raise_on_the_card(cuda, monkeypatch):
    """A serve's dispatch sort is guarded as every sort on the card is
    (ROADMAP.md D8): a failed launch is retried once with the same plan,
    and the serve's tokens are those of a clean serve; a second failure
    raises a SortRuntimeError out of the serve.  No library sort runs."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import faults, guard
    from repro_torch.launch import serve
    from repro_torch.models import api

    full = configs.get_config("qwen3-moe-30b-a3b").model
    cfg = dataclasses.replace(full, n_layers=1)
    model = api.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(serve.prompts(cfg, 2, 1024)).cuda()

    def run():
        return serve.generate(model, tokens, cfg, gen=3, topk=8, temperature=0.8,
                              generator=torch.Generator("cuda").manual_seed(1)).tokens

    clean = run()
    calls = count_library_sorts(monkeypatch)
    guard.clear_degradation_log()
    faults.reset()
    try:
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=1):
                assert torch.equal(run(), clean)
        assert [ev.action for ev in guard.degradation_log()] == ["retry"]
        guard.clear_degradation_log()
        with pytest.warns(guard.DegradationWarning):
            with faults.inject("kernel.launch", on_hit=1, count=2):
                with pytest.raises(guard.SortRuntimeError, match="tile_sort"):
                    run()
    finally:
        faults.reset()
        guard.clear_degradation_log()
    assert calls == []


def _train_steps(cfg, params, n, opt=None, seq=128, batch=2):
    """n build_train_step steps from ``params`` (updated in place);
    returns the metrics of each as floats."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw_init

    opt = opt or OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=n)
    ds = SyntheticDataset(cfg.vocab, seq, batch, seed=0)
    step = build_train_step(cfg, opt)
    state = adamw_init(params, opt)
    out = []
    for i in range(n):
        _, _, m = step(params, state, ds.batch_at(i))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_smoke_train_step_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The smoke configs (float32), the same weights and batch on both
    devices, TF32 off: one train step through the kernels on the card and
    the plain versions on the CPU; losses within 1e-5, parameters within
    2 lr (an AdamW step moves an element by at most about lr)."""
    from repro_torch import configs
    from repro_torch.models import api, meta
    from repro_torch.tree import leaves

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"):
        cfg = configs.get_smoke(arch)
        host = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
        card = _tree_to(host, "cuda")
        (mc,), (mh,) = _train_steps(cfg, card, 1), _train_steps(cfg, host, 1)
        assert abs(mc["loss"] - mh["loss"]) <= 1e-5
        for (path, a), (_, b) in zip(leaves(card), leaves(host)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-3, msg=str(path))


def test_train_step_launches_and_dispatches_on_the_card(cuda):
    """Qwen3-MoE-30B-A3B at full width, two layers, remat "full", 2 x
    1,024 tokens (16,384 routed slots: a bucket round): a step launches
    K4, K1 and K2 as chip_smoke.training_launches reckons from the plans,
    the forward's twice; the three dispatches give the same step-0 loss
    bit for bit."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, meta

    full = configs.get_config("qwen3-moe-30b-a3b").model
    cfg = dataclasses.replace(full, n_layers=2)
    losses = {}
    for d in ("sample_sort", "xla_sort", "onehot"):
        cfg_d = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=d))
        params = meta.init_params(api.template(cfg_d), torch.Generator("cuda").manual_seed(0))
        ops.reset_launch_counts()
        (m,) = _train_steps(cfg_d, params, 1, seq=1024)
        torch.cuda.synchronize()
        got = {k: c for k, c in ops.launch_counts().items() if c}
        assert got == _chip_smoke().training_launches(cfg_d, 2 * 1024)
        losses[d] = m["loss"]
        del params
        torch.cuda.empty_cache()
    assert len(set(losses.values())) == 1, losses


def test_resumed_training_on_the_card_is_bit_equal(cuda, tmp_path):
    """The smoke config on the card: a driver stopped at its step-2
    checkpoint and resumed by a new one gives the straight run's losses,
    bit for bit at the resumed step."""
    from repro_torch import configs
    from repro_torch.config import OptimizerConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api, meta
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainDriver

    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)

    def run(path, total):
        step = build_train_step(cfg, opt)

        def init():
            p = meta.init_params(api.template(cfg), torch.Generator("cuda").manual_seed(0))
            return (p, adamw_init(p, opt))

        def step_fn(state, batch):
            p, o, m = step(*state, batch)
            return (p, o), m

        return TrainDriver(step_fn, init, SyntheticDataset(cfg.vocab, 64, 2), ckpt_dir=str(path),
                           ckpt_every=2, log_every=1, log_fn=lambda *_: None).run(total)[1]

    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 4)
    assert resumed[0]["step"] == 2 and resumed[0]["loss"] == straight[2]["loss"]
    assert abs(resumed[1]["loss"] - straight[3]["loss"]) <= 1e-3


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
