"""Bit parity of the port's distributed sort with the JAX package's.

One JAX subprocess (8 forced host devices, ``SortConfig(impl="xla")``
(ROADMAP.md R1), ``jax_enable_x64`` (R2), as ``tests/test_distributed.py``
runs it) sorts every cell on meshes of 2 and 4 devices, on a (4, 2) mesh
along both axes and along "data", and runs the reference's last rung
(``_degraded_host_sort``) on two cells; it asserts that
``repro.core.degradation_log()`` stays empty and writes its outputs to
an ``.npz``.  Meanwhile the port sorts the same inputs on gloo CPU ranks,
one spawn per mesh.  Every rank's whole (out_cap,) output, pads
included, its count and max_within must equal the reference's chunk bit
for bit; so must the CPU rung's chunks, reached with
``collective.exchange`` failing on one rank.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch_ranks  # noqa: E402

from repro_torch.launch import mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4096
DTYPES = ["int32", "uint32", "float32", "int64", "float64"]
DISTS = ["uniform", "equal", "zipf", "nearly-sorted"]
D2 = [(f"{dt}-{di}", desc) for dt in DTYPES for di in DISTS
      for desc in (False, True)]
D4 = [("int32-zipf", False), ("int32-uniform", False),
      ("float64-uniform", True), ("float64-nearly-sorted", True)]
TWO_AXIS = [("int64-uniform", False), ("int64-equal", False),
            ("float32-uniform", True), ("float32-zipf", True)]
ONE_AXIS = [("uint32-uniform", True), ("uint32-nearly-sorted", True),
            ("int32-equal", False), ("int32-uniform", False)]
DEGRADED = [("int32-uniform", False), ("float64-zipf", True)]
# (name, mesh shape, axis names, sort axis, cells, degraded cells)
MESHES = [
    ("d2", (2,), ("data",), "data", D2, DEGRADED),
    ("d4", (4,), ("data",), "data", D4, []),
    ("d8", (4, 2), ("data", "model"), ("data", "model"), TWO_AXIS, []),
    ("d8-data", (4, 2), ("data", "model"), "data", ONE_AXIS, []),
]
DEADLINE_S = 300

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.core import clear_degradation_log, degradation_log
    from repro.core.distributed_sort import _degraded_host_sort, make_sharded_sort
    from repro.core.sort_config import SortConfig
    from repro.launch.mesh import make_mesh

    spec = json.loads(sys.argv[1])
    data = np.load(spec["data"])
    out = {}
    for name, shape, names, axis, cells, degraded in spec["meshes"]:
        m = make_mesh(tuple(shape), tuple(names))
        axis = axis if isinstance(axis, str) else tuple(axis)
        for key, desc, rung in ([c + [False] for c in cells]
                                + [c + [True] for c in degraded]):
            x = data[key]
            cfg = SortConfig(tile=256, s=16, direct_max=512, impl="xla",
                             descending=desc)
            clear_degradation_log()
            run, plan = make_sharded_sort(m, axis, len(x), cfg,
                                          dtype=jnp.dtype(x.dtype))
            cell = f"{key}-{'desc' if desc else 'asc'}"
            if rung:
                res = _degraded_host_sort(jnp.asarray(x), plan)
                tag = f"{name}/degraded/{cell}"
            else:
                res = run(jnp.asarray(x))
                tag = f"{name}/{cell}"
            assert degradation_log() == (), degradation_log()
            for part, a in zip(("keys", "vals", "counts", "mw"), res):
                out[f"{tag}/{part}"] = np.asarray(a)
    np.savez(spec["out"], **out)
    print("OK", len(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's ranks by mesh)."""
    tmp = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(7)
    inputs = {f"{dt}-{di}": torch_ranks.make_input(dt, di, N, rng)
              for dt in DTYPES for di in DISTS}
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    spec = dict(data=str(tmp / "inputs.npz"), out=str(tmp / "ref.npz"),
                meshes=MESHES)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(spec)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for name, shape, names, axis, cells, degraded in MESHES:
            world = int(np.prod(shape))
            port[name] = mesh.run_ranks(
                torch_ranks.sort_cells, world,
                dict(data=spec["data"], runs=[(axis, cells)],
                     degraded=degraded,
                     mesh=(shape, names) if len(shape) > 1 else None),
                timeout_s=60, deadline_s=DEADLINE_S)
        out, err = ref.communicate(timeout=DEADLINE_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    return inputs, dict(np.load(spec["out"])), port


def group_ranks(name, ranks):
    """The ranks of one sorted line, in group order (line 0 for the
    1-axis sort of the (4, 2) mesh)."""
    return ranks[0::2] if name == "d8-data" else ranks


CASES = [(name, axis, key, desc, False)
         for name, _, _, axis, cells, degraded in MESHES
         for key, desc in cells] + [
    ("d2", "data", key, desc, True) for key, desc in DEGRADED]


@pytest.mark.parametrize(
    "name,axis,key,desc,degraded", CASES,
    ids=[f"{c[0]}-{'degraded-' if c[4] else ''}{torch_ranks.cell_id(c[2], c[3])}"
         for c in CASES])
def test_ranks_equal_the_references_chunks_bit_for_bit(runs, name, axis, key,
                                                       desc, degraded):
    inputs, ref, port = runs
    cell = torch_ranks.cell_id(key, desc)
    tag = f"{name}/degraded/{cell}" if degraded else f"{name}/{cell}"
    rkey = f"degraded/{cell}" if degraded else torch_ranks.run_key(axis, key, desc)
    outs = [r[rkey] for r in group_ranks(name, port[name])]
    keys = np.concatenate([o["keys"] for o in outs])
    vals = np.concatenate([o["vals"] for o in outs])
    assert keys.dtype == inputs[key].dtype
    np.testing.assert_array_equal(keys.view(np.uint8),
                                  ref[f"{tag}/keys"].view(np.uint8))
    np.testing.assert_array_equal(vals, ref[f"{tag}/vals"])
    np.testing.assert_array_equal([o["count"] for o in outs], ref[f"{tag}/counts"])
    np.testing.assert_array_equal([o["max_within"] for o in outs], ref[f"{tag}/mw"])
    for o in outs:
        # Two attempts that stop before the exchange launch less than a walk.
        assert o["launches_equal"] != degraded
        assert o["log"] == (["retry", "fallback"] if degraded else [])


def test_the_other_line_of_the_mesh_sorts_alike(runs):
    """Ranks 1, 3, 5, 7 sort the same keys along "data" as 0, 2, 4, 6."""
    ranks = runs[2]["d8-data"]
    for key, desc in ONE_AXIS:
        rkey = torch_ranks.run_key("data", key, desc)
        for a, b in zip(ranks[0::2], ranks[1::2]):
            np.testing.assert_array_equal(a[rkey]["keys"].view(np.uint8),
                                          b[rkey]["keys"].view(np.uint8))
            np.testing.assert_array_equal(a[rkey]["vals"], b[rkey]["vals"])
