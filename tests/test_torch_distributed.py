"""The port's distributed sort on gloo CPU ranks (``core/distributed_sort.py``).

Each spawn of ``repro_torch.launch.mesh.run_ranks`` runs d rank
processes on one gloo group, meeting through a ``FileStore`` in a
temporary directory (no TCP port to collide between workers), with a
finite group timeout and a deadline on the join.  Every cell is held
against a stable lexicographic sort of the codec's words with the global
index (``kernels/ref.lex_order``): the ranks' valid prefixes, in rank
order, must be the sorted keys bit for bit and their payloads the
permutation; counts sum to n, max_within stays below c_pair, the kernel
dispatches equal the ShardPlan's launch walk, and nothing degrades.
Cells: d = 2 (five dtypes, both orders, four distributions), d = 4, and
a (4, 2) mesh sorted along both axes (d = 8) and along one (d = 4).
Also the fault chain (a fault on one rank only), ``plan="autotune"`` and
the validation messages.  Bit parity with the JAX package is
``tests/test_torch_distributed_parity.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch_ranks  # noqa: E402

from repro_torch.core.key_codec import codec_for  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

N = 4096
DTYPES = ["int32", "uint32", "float32", "int64", "float64"]
DISTS = ["uniform", "equal", "zipf", "nearly-sorted"]
DEADLINE_S = 300
TIMEOUT_S = 60

D2_CELLS = [(f"{dt}-{di}", desc) for dt in DTYPES for di in DISTS
            for desc in (False, True)]
D4_CELLS = [("int32-uniform", False), ("int32-equal", True),
            ("float64-zipf", False), ("uint32-nearly-sorted", True),
            ("float32-uniform", True), ("int64-zipf", False)]
MESH_CELLS = [("int64-uniform", False), ("float32-nearly-sorted", True),
              ("int32-equal", False), ("uint32-zipf", True)]


def cell_id(cell):
    return torch_ranks.cell_id(*cell)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Every input, drawn once from a seed, in an .npz the ranks read;
    also keys on few values, every seventh the largest of its dtype (whose
    canonical word is the pad word)."""
    rng = np.random.default_rng(42)
    arrays = {f"{dt}-{di}": torch_ranks.make_input(dt, di, N, rng)
              for dt in DTYPES for di in DISTS}
    for dt in ("int32", "uint32"):
        x = rng.integers(0, 50, N).astype(dt)
        x[::7] = np.iinfo(dt).max
        arrays[f"{dt}-max"] = x
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    np.savez(path, **arrays)
    return str(path), arrays


def spawn(fn, d, spec):
    return mesh.run_ranks(fn, d, spec, timeout_s=TIMEOUT_S,
                          deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def d2(data):
    return spawn(torch_ranks.sort_cells, 2,
                 dict(data=data[0], runs=[("data", D2_CELLS)]))


@pytest.fixture(scope="module")
def d4(data):
    return spawn(torch_ranks.sort_cells, 4,
                 dict(data=data[0], runs=[("data", D4_CELLS)]))


@pytest.fixture(scope="module")
def mesh_runs(data):
    """A (4, 2) mesh ("data", "model"): the 2-axis sort (d = 8), and the
    1-axis sort along "data" (d = 4; the two lines sort the same keys)."""
    return spawn(torch_ranks.sort_cells, 8, dict(
        data=data[0], mesh=((4, 2), ("data", "model")),
        runs=[(("data", "model"), MESH_CELLS), ("data", MESH_CELLS)]))


def oracle(x: np.ndarray, desc: bool):
    """(sorted keys, permutation): a stable sort on (codec words, index)."""
    t = torch.from_numpy(x)
    words = codec_for(t.dtype, desc).encode(t)
    idx = torch.arange(len(x), dtype=torch.int32)
    perm = ref.lex_order(tuple(w[None] for w in words) + (idx[None],))[0]
    return t[perm].numpy(), perm.numpy().astype(np.int32)


def check_cell(ranks, name, desc, x, axis="data", strategy="bitonic"):
    """The ranks' outputs of one cell against the oracle."""
    outs = [r[torch_ranks.run_key(axis, name, desc, strategy)] for r in ranks]
    keys = np.concatenate([o["keys"][:o["count"]] for o in outs])
    vals = np.concatenate([o["vals"][:o["count"]] for o in outs])
    want_keys, want_perm = oracle(x, desc)
    assert sum(o["count"] for o in outs) == len(x)
    np.testing.assert_array_equal(keys.view(np.uint8), want_keys.view(np.uint8))
    np.testing.assert_array_equal(vals, want_perm)
    for o in outs:
        assert o["max_within"] < o["c_pair"]
        assert o["launches_equal"], "kernel launches differ from the plan's walk"
        assert o["log"] == [] and o["stats"] == {"degraded": False, "retries": 0}


@pytest.mark.parametrize("cell", D2_CELLS, ids=cell_id)
def test_two_ranks_sort_every_dtype_order_and_distribution(d2, data, cell):
    check_cell(d2, cell[0], cell[1], data[1][cell[0]])


@pytest.mark.parametrize("cell", D4_CELLS, ids=cell_id)
def test_four_ranks(d4, data, cell):
    check_cell(d4, cell[0], cell[1], data[1][cell[0]])


@pytest.mark.parametrize("cell", MESH_CELLS, ids=cell_id)
def test_two_axis_sort_over_a_4x2_mesh(mesh_runs, data, cell):
    check_cell(mesh_runs, cell[0], cell[1], data[1][cell[0]],
               ("data", "model"))


@pytest.mark.parametrize("line", [0, 1])
@pytest.mark.parametrize("cell", MESH_CELLS, ids=cell_id)
def test_one_axis_sort_of_a_4x2_mesh(mesh_runs, data, cell, line):
    """Ranks 0, 2, 4, 6 form one "data" line, 1, 3, 5, 7 the other."""
    check_cell(mesh_runs[line::2], cell[0], cell[1], data[1][cell[0]])


STRATEGY_CELLS = [("int32-max", False), ("uint32-max", False),
                  ("int32-max", True), ("float64-zipf", False)]


@pytest.fixture(scope="module")
def by_strategy(data):
    return spawn(torch_ranks.sort_cells, 2, dict(
        data=data[0], runs=[("data", STRATEGY_CELLS, "radix"),
                            ("data", STRATEGY_CELLS, "merge")]))


@pytest.mark.parametrize("strategy", ["radix", "merge"])
@pytest.mark.parametrize("cell", STRATEGY_CELLS, ids=cell_id)
def test_radix_and_merge_shard_sorts_stay_stable(by_strategy, data, cell,
                                                 strategy):
    """Keys on few values, the largest among them: the shard sorts with
    the config's strategy, the phases on concatenated runs on (words,
    payload), so no pad enters the valid prefix and ties keep index order
    (the JAX package's sort fails here: ROADMAP.md R5)."""
    check_cell(by_strategy, cell[0], cell[1], data[1][cell[0]],
               strategy=strategy)


def test_mesh_lines_are_row_major():
    shape, names = (4, 2), ("data", "model")
    assert list(mesh._line_ranks(shape, names, ("data",))) == [[0, 2, 4, 6],
                                                              [1, 3, 5, 7]]
    assert list(mesh._line_ranks(shape, names, ("model",))) == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert list(mesh._line_ranks(shape, names, names)) == [list(range(8))]
    assert list(mesh._line_ranks((2, 2, 2), ("p", "d", "m"), ("p", "m"))) == [
        [0, 1, 4, 5], [2, 3, 6, 7]]


@pytest.fixture(scope="module")
def chain(data):
    """collective.exchange armed on rank 2 of 4 only: once, then always."""
    return spawn(torch_ranks.fault_chain, 4, dict(
        data=data[0], cell="int32-uniform", fault_rank=2, counts=[1, 10**6]))


def test_a_fault_on_one_rank_retries_on_every_rank(chain, data):
    ranks = [{"c": r[1]} for r in chain]
    for r in chain:
        assert r[1]["log"] == ["retry"]
        assert r[1]["stats"] == {"degraded": False, "retries": 1}
    check_cell_loose(ranks, "c", data[1]["int32-uniform"])


def test_a_lasting_fault_on_one_rank_degrades_every_rank_on_the_cpu(chain, data):
    """The CPU rung: every rank gathers the keys and sorts them stably."""
    for r in chain:
        assert r[10**6]["log"] == ["retry", "fallback"]
        assert r[10**6]["stats"] == {"degraded": True, "retries": 1}
        assert r[10**6]["max_within"] == 0
        assert r[10**6]["count"] == N // 4
    check_cell_loose([{"c": r[10**6]} for r in chain], "c",
                     data[1]["int32-uniform"])
    for r in chain:  # a call after the fault is gone runs the mesh path
        assert r["healed"]["stats"] == {"degraded": False, "retries": 0}
    check_cell_loose([{"c": r["healed"]} for r in chain], "c",
                     data[1]["int32-uniform"])


def check_cell_loose(ranks, name, x):
    """Keys and payloads of the valid prefixes against the oracle."""
    keys = np.concatenate([r[name]["keys"][:r[name]["count"]] for r in ranks])
    vals = np.concatenate([r[name]["vals"][:r[name]["count"]] for r in ranks])
    want_keys, want_perm = oracle(x, False)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(vals, want_perm)


@pytest.fixture(scope="module")
def tuned(data, tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "plans.json"
    return spawn(torch_ranks.tune, 2, dict(
        data=data[0], cell="int32-zipf", store=str(store)))


def test_autotune_gives_every_rank_the_same_plan(tuned, data):
    first = tuned[0]
    assert first["measured"][0] == "base" and len(first["measured"]) >= 2
    for r in tuned:
        assert r["plan"] == first["plan"]
        assert r["measured"] == first["measured"]
        assert r["later_measured"] == []
        assert r["warm_same"] and r["stored_equal"] and r["file_equal"]
        assert r["cold"]["launches_equal"] and r["filed"]["launches_equal"]
    check_cell_loose([{"c": r["cold"]} for r in tuned], "c", data[1]["int32-zipf"])
    check_cell_loose([{"c": r["filed"]} for r in tuned], "c", data[1]["int32-zipf"])


@pytest.fixture(scope="module")
def messages():
    return spawn(torch_ranks.validation, 2, {})


@pytest.mark.parametrize("case,match", [
    ("single", "spans d=1 rank(s); need d >= 2"),
    ("divisible", "must be divisible by the axis device count"),
    ("budget", "exceeds the int32 payload budget"),
    ("oversample", "oversample must be a power of two"),
    ("pair_align", "pair_align must be a power of two >= 8"),
    ("dtype", "does not match the shard plan's dtype"),
    ("shape", "keys_local must be this rank's (1024,) shard"),
])
def test_validation_names_the_argument(messages, case, match):
    for r in messages:
        assert r[case] is not None and match in r[case], r[case]


def sleeper(rank, world, seconds):
    import time

    time.sleep(seconds)


def test_run_ranks_kills_ranks_past_the_deadline():
    with pytest.raises(TimeoutError, match="still running"):
        mesh.run_ranks(sleeper, 2, 120, deadline_s=3)


def test_the_example_script_sorts_over_two_ranks():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, str(root / "examples" / "torch_sharded_sort.py")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "sharded sort OK" in r.stdout
