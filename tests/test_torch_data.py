"""The port's data pipeline, checkpoints and training driver against the
JAX package's, on the CPU.

* ``SyntheticDataset.batch_at`` and ``MemmapDataset.batch_at``:
  bit-equal over several seeds, steps and shards.
* The ``DataLoader``'s prefetch thread checks the fault site
  ``pipeline.producer``; a fault there reaches the consumer as a
  ``ProducerError`` chained to the fault, after the batches made before.
* Checkpoints: each package reads what the other wrote, bit-equal; the
  port writes a bfloat16 leaf byte for byte as the reference does and
  reads the reference's, which the reference itself cannot
  (ROADMAP.md Queue 3 R9); the port's train state holds the reference's
  keys.
* The driver: the reference's crash-and-restart test, ported, and a
  resumed run of the smoke model equal to a straight one.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import config as RC  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.runtime import driver as jdriver  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import OptimizerConfig, ParallelConfig  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, meta  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

SEEDS = [0, 1, 7, 2**31 + 5]
STEPS = [0, 1, 5, 1000, 2**20 + 3]


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_batches_are_the_references(seed, step):
    for vocab, seq, batch in ((512, 32, 2), (151936, 17, 3)):
        got = pipe.SyntheticDataset(vocab, seq, batch, seed=seed).batch_at(step)
        want = jpipe.SyntheticDataset(vocab, seq, batch, seed=seed).batch_at(step)
        assert list(got) == ["tokens", "targets"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("n_shards", [1, 3])
def test_memmap_batches_are_the_references(tmp_path, n_shards):
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32).tofile(path)
    for shard in range(n_shards):
        a = pipe.MemmapDataset(path, 15, 4, shard, n_shards)
        b = jpipe.MemmapDataset(path, 15, 4, shard, n_shards)
        for step in (0, 1, 9, 40):
            for k, v in b.batch_at(step).items():
                assert np.array_equal(a.batch_at(step)[k], v)


def test_memmap_refuses_a_small_file(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.zeros(20, np.int32).tofile(path)
    with pytest.raises(ValueError, match="windows"):
        pipe.MemmapDataset(path, 15, 4)


# ------------------------------------------------------------ the loader
def test_loader_yields_the_stream_from_its_start_step():
    ds = pipe.SyntheticDataset(100, 8, 2, seed=3)
    loader = pipe.DataLoader(ds, start_step=5, prefetch=2)
    try:
        for step in range(5, 12):
            b = next(loader)
            assert np.array_equal(b["tokens"], ds.batch_at(step)["tokens"])
        assert loader.step == 12
    finally:
        loader.close()
    loader.close()  # idempotent
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


@pytest.mark.parametrize("on_hit", [1, 4])
def test_producer_fault_surfaces_as_producer_error(on_hit):
    """pipeline.producer fires on its on_hit-th batch: the batches made
    before it arrive in order, then the consumer gets a ProducerError
    chained to the injected fault."""
    ds = pipe.SyntheticDataset(100, 8, 2, seed=0)
    with faults.inject("pipeline.producer", on_hit=on_hit) as rule:
        loader = pipe.DataLoader(ds, prefetch=2)
        try:
            got = []
            with pytest.raises(pipe.ProducerError) as err:
                for _ in range(on_hit + 5):
                    got.append(next(loader))
        finally:
            loader.close()
    assert rule.fired == 1
    assert len(got) == on_hit - 1
    for step, b in enumerate(got):
        assert np.array_equal(b["tokens"], ds.batch_at(step)["tokens"])
    e = err.value
    assert e.site == "pipeline.producer" and e.step == on_hit - 1
    assert isinstance(e.__cause__, faults.FaultInjected)
    assert "pipeline.producer" in str(e)
    assert not loader._thread.is_alive()


def test_a_failing_dataset_surfaces_as_producer_error():
    class Broken(pipe.SyntheticDataset):
        def batch_at(self, step):
            if step == 2:
                raise OSError("disk gone")
            return super().batch_at(step)

    loader = pipe.DataLoader(Broken(100, 8, 2), prefetch=1)
    try:
        next(loader), next(loader)
        with pytest.raises(pipe.ProducerError, match="disk gone") as err:
            next(loader)
        assert isinstance(err.value.__cause__, OSError) and err.value.step == 2
    finally:
        loader.close()


# ---------------------------------------------------------- checkpoints
def state_numpy(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((3, 4)).astype(dtype),
              "b": {"c": rng.standard_normal((5,)).astype(dtype)}}
    return (params, {"m": {"w": np.zeros((3, 4), np.float32),
                           "b": {"c": np.ones((5,), np.float32)}},
                     "step": np.int32(7)})


def to_port(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return map_tree(conv, tree)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    state = state_numpy()
    ck.save(str(tmp_path), 4, to_port(state))
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype), state)
    got = jck.restore(str(tmp_path), 4, like)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(state)[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b)), pa
    assert jck.latest_step(str(tmp_path)) == 4


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    state = state_numpy(1)
    jck.save(str(tmp_path), 9, jax.tree.map(jnp.asarray, state))
    assert ck.latest_step(str(tmp_path)) == 9
    got = ck.restore(str(tmp_path), 9, to_port(state), device="cpu")
    for (pa, a), (_, b) in zip(leaves(got), leaves(to_port(state))):
        assert a.dtype == b.dtype and torch.equal(a, b), pa


def test_bfloat16_checkpoints_cross_and_r9(tmp_path):
    """The port writes a bfloat16 leaf as the reference's numpy does (the
    same file bytes, manifest dtype "bfloat16"), and restores the
    reference's bit for bit; the reference cannot restore either (R9)."""
    state = state_numpy(2, dtype=ml_dtypes.bfloat16)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_dir, 3, jax.tree.map(jnp.asarray, state))
    ck.save(port_dir, 3, to_port(state))
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            man = json.load(f)
        assert man["dtypes"]["0/w"] == "bfloat16" and man["dtypes"]["1/step"] == "int32"
    for name in sorted(os.listdir(os.path.join(ref_dir, "step_00000003"))):
        with open(os.path.join(ref_dir, "step_00000003", name), "rb") as a, \
                open(os.path.join(port_dir, "step_00000003", name), "rb") as b:
            assert a.read() == b.read(), name
    got = ck.restore(ref_dir, 3, to_port(state), device="cpu")
    assert got[0]["w"].dtype == torch.bfloat16
    for (pa, a), (_, b) in zip(leaves(got), leaves(to_port(state))):
        assert np.array_equal(bits(a), bits(b)), pa
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype), state)
    with pytest.raises(TypeError):  # R9: the reference's own bf16 restore
        jck.restore(ref_dir, 3, like)


def test_train_state_holds_the_references_keys(tmp_path):
    """The port's (params, opt_state) checkpoint of a smoke model has the
    keys, shapes and dtypes of the reference's for the same config."""
    from repro.models import api as jax_api
    from repro.models import meta as jax_meta
    from repro.optim import adamw_init as jax_adamw_init

    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
    opt = OptimizerConfig(moment_dtype="bfloat16")
    ck.save(str(tmp_path / "port"), 1, (params, adamw_init(params, opt)))
    d = dataclasses.asdict(cfg)
    d["layer_pattern"] = tuple(RC.LayerSlot(**s) for s in d["layer_pattern"])
    d["moe"] = RC.MoEConfig(**d["moe"])
    ref_cfg = RC.ModelConfig(**d)
    jp = jax_meta.init_params(jax_api.template(ref_cfg), jax.random.PRNGKey(0))
    jck.save(str(tmp_path / "ref"), 1, (jp, jax_adamw_init(jp, RC.OptimizerConfig(
        **dataclasses.asdict(opt)))))
    mans = []
    for d in ("port", "ref"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            mans.append(json.load(f))
    assert mans[0] == mans[1]
    assert "0/period/slot0/moe/wg" in mans[0]["keys"] and "1/step" in mans[0]["keys"]
    assert "1/m/period/slot0/moe/wg" in mans[0]["keys"]


def test_restore_checks_keys_and_shapes(tmp_path):
    state = to_port(state_numpy())
    ck.save(str(tmp_path), 1, state)
    with pytest.raises(KeyError, match="no leaf"):
        ck.restore(str(tmp_path), 1, {"zzz": torch.zeros(1)})
    bad = to_port(state_numpy())
    bad[0]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 1, bad)
    meta_like = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    got = ck.restore(str(tmp_path), 1, meta_like)
    assert all(t.device.type == "cpu" for _, t in leaves(got))


def test_latest_step_and_gc_ignore_partials(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ck.save(d, s, {"x": torch.full((2,), s)})
    os.makedirs(os.path.join(d, "step_00000009.tmp.1.2"))
    os.makedirs(os.path.join(d, "step_00000008"))  # no manifest: incomplete
    assert ck.latest_step(d) == 4 == jck.latest_step(d)
    ck.gc_keep_k(d, 2)
    assert ck.latest_step(d) == 4
    assert not os.path.exists(os.path.join(d, "step_00000001"))
    assert os.path.exists(os.path.join(d, "step_00000003"))
    ck.gc_keep_k(d, 2, stale_tmp_secs=-1)
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp.1.2"))
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    """The async save copies the tensors first: an in-place update right
    after ``save`` does not reach the checkpoint."""
    d = str(tmp_path / "ck")
    acp = ck.AsyncCheckpointer(d, keep=2)
    x = torch.zeros(4, dtype=torch.int32)
    for s in (10, 20, 30):
        x.fill_(s)
        acp.save(s, {"x": x})
        x.fill_(-1)
    acp.wait()
    assert ck.latest_step(d) == 30
    assert int(ck.restore(d, 30, {"x": x})["x"][0]) == 30
    assert sorted(os.listdir(d)) == ["step_00000020", "step_00000030"]


def test_async_checkpointer_surfaces_errors_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    acp = ck.AsyncCheckpointer(str(blocker), keep=1)
    acp.save(1, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        acp.wait()
    acp.wait()  # raised once


# --------------------------------------------------------------- runtime
def toy_driver(path, ckpt_every=5):
    def init_state():
        return {"w": torch.tensor(0.0), "step": torch.tensor(0, dtype=torch.int32)}

    def step_fn(state, batch):
        w = state["w"] + float(batch["tokens"].mean())
        return {"w": w, "step": state["step"] + 1}, {"loss": w}

    ds = pipe.SyntheticDataset(vocab=10, seq_len=4, batch=2, seed=1)
    return driver.TrainDriver(
        step_fn, init_state, ds, ckpt_dir=os.path.join(str(path), "ck"),
        ckpt_every=ckpt_every, log_every=100, log_fn=lambda *_: None,
    )


def test_driver_crash_restart_deterministic(tmp_path):
    """The reference's test, ported: a crash at step 12 and a restart
    that resumes from step 10's checkpoint end where a clean run does."""
    class Boom(RuntimeError):
        pass

    drv = toy_driver(tmp_path)

    def injector(step):
        if step == 12:
            raise Boom()

    with pytest.raises(Boom):
        drv.run(20, fault_injector=injector)
    state, _ = toy_driver(tmp_path).run(20)
    state_clean, _ = toy_driver(str(tmp_path) + "_clean").run(20)
    np.testing.assert_allclose(float(state["w"]), float(state_clean["w"]), rtol=1e-6)
    assert int(state["step"]) == 20


def test_resumed_training_equals_a_straight_run(tmp_path):
    """The smoke model: 4 straight steps, and 2 steps, a new driver that
    resumes from their checkpoint and runs 2 more, give the same losses
    and parameters, bit for bit on the CPU."""
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    ds = pipe.SyntheticDataset(cfg.vocab, 16, 2, seed=0)

    def run(path, total):
        step = steps.build_train_step(cfg, opt)

        def step_fn(state, batch):
            params, opt_state, m = step(*state, batch)
            return (params, opt_state), m

        def init():
            p = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
            return (p, adamw_init(p, opt))

        return driver.TrainDriver(step_fn, init, ds, ckpt_dir=str(path), ckpt_every=2,
                                  log_every=1, log_fn=lambda *_: None).run(total)

    straight, hist = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed, hist2 = run(tmp_path / "b", 4)
    assert [h["step"] for h in hist2] == [2, 3]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[2:]]
    for (p, a), (_, b) in zip(leaves(straight), leaves(resumed)):
        assert torch.equal(a, b), p
    assert ck.latest_step(str(tmp_path / "b")) == 4


def test_straggler_monitor(tmp_path):
    hb = str(tmp_path / "hb.json")
    mon = driver.StragglerMonitor(window=20, z_thresh=3.0, heartbeat_path=hb)
    ref = jdriver.StragglerMonitor(window=20, z_thresh=3.0)
    for i in range(15):
        dt = 0.10 + 0.001 * (i % 3)
        assert not mon.record(i, dt) and not ref.record(i, dt)
    assert mon.record(15, 1.0) and ref.record(15, 1.0)  # 10x outlier
    assert mon.flagged == ref.flagged and mon.flagged[0][0] == 15
    with open(hb) as f:
        beat = json.load(f)
    assert beat["step"] == 15 and beat["process"] == 0


@pytest.mark.parametrize("n", [1, 16, 256, 512, 1024])
def test_elastic_mesh_fit_equals_the_reference(n):
    for shape, axes in (((2, 16, 16), ("pod", "data", "model")),
                        ((16, 16), ("data", "model")), ((4, 1), ("data", "model"))):
        if n % dict(zip(axes, shape))["model"]:
            with pytest.raises(ValueError):
                driver.fit_parallel_to_devices(ParallelConfig(shape, axes), n)
            continue
        got = driver.fit_parallel_to_devices(ParallelConfig(shape, axes), n)
        want = jdriver.fit_parallel_to_devices(RC.ParallelConfig(shape, axes), n)
        assert got.mesh_shape == want.mesh_shape and int(np.prod(got.mesh_shape)) == n
