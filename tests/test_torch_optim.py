"""The port's optimizer against the JAX package's, on the CPU.

The same seeded numpy parameters, gradients and moments go to both
sides.  ``cosine_warmup``, ``clip_by_global_norm`` and ``adamw_update``
agree within 1e-6 (relative; float32 ops in the same order, the
libraries' ``cos``, ``pow`` and reductions may round the last bit
otherwise), bfloat16 storage within one bfloat16 step (2^-7 relative:
the float32 results round to the nearest bfloat16 on both sides, so a
last-bit difference can flip one rounding).  ``compress_grads_int8``:
int8 values equal, scales within 1e-7, residuals within 1e-6.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as RC  # noqa: E402
from repro import optim as J  # noqa: E402
from repro.optim.compress import compress_grads_int8 as j_compress  # noqa: E402
from repro.optim.compress import decompress_grads_int8 as j_decompress  # noqa: E402
from repro_torch import optim as P  # noqa: E402
from repro_torch.config import OptimizerConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

SHAPES = {"a": (7, 5), "b": {"c": (3, 4, 6), "d": (11,)}, "e": ()}
BF16_RTOL = 2.0 ** -7


def tree_of(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: tree_of(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def rand_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tree_of(lambda s: (rng.standard_normal(s) * scale).astype(np.float32))


def to_torch(tree, dtype=torch.float32):
    return map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


def to_jax(tree, dtype=jnp.float32):
    return map_tree(lambda a: jnp.asarray(np.array(a, np.float32)).astype(dtype), tree)


def close(got: torch.Tensor, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def ref_opt(cfg: OptimizerConfig):
    return RC.OptimizerConfig(**dataclasses.asdict(cfg))


def test_configs_equal_the_reference():
    from repro_torch.config import ParallelConfig, TrainConfig

    assert dataclasses.asdict(OptimizerConfig()) == dataclasses.asdict(RC.OptimizerConfig())
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(RC.TrainConfig())
    assert dataclasses.asdict(ParallelConfig()) == dataclasses.asdict(RC.ParallelConfig())
    assert ParallelConfig(mesh_axes=("pod", "data", "model"), mesh_shape=(2, 2, 2)
                          ).batch_axes == ("pod", "data")


@pytest.mark.parametrize("warmup,total", [(100, 10000), (1, 6), (0, 3)])
@pytest.mark.parametrize("step", [0, 1, 2, 5, 99, 100, 101, 3000, 9999, 10000, 20000])
def test_cosine_warmup_equals_the_reference(step, warmup, total):
    got = P.cosine_warmup(step, 3e-4, warmup, total)
    want = J.cosine_warmup(jnp.int32(step), 3e-4, warmup, total)
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got, want, rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_init_equals_the_reference(moment_dtype):
    cfg = OptimizerConfig(moment_dtype=moment_dtype)
    got = P.adamw_init(to_torch(rand_tree(0)), cfg)
    want = J.adamw_init(to_jax(rand_tree(0)), ref_opt(cfg))
    assert [p for p, _ in leaves(got)] == [
        tuple(getattr(k, "key", k) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for (_, a), (_, b) in zip(leaves(got), jax.tree_util.tree_flatten_with_path(want)[0]):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        assert not bool(a.any())


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_equals_the_reference(max_norm):
    g = rand_tree(1, scale=3.0)
    scale, gnorm = P.clip_by_global_norm(to_torch(g), max_norm)
    clipped, want_norm = J.clip_by_global_norm(to_jax(g), max_norm)
    close(gnorm, want_norm, rtol=1e-6)
    for (_, t), (_, c) in zip(leaves(to_torch(g)), leaves(clipped)):
        close(t * scale, c, rtol=1e-6, atol=1e-7)
    assert (float(scale) == 1.0) == (max_norm > float(gnorm))


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_adamw_steps_equal_the_reference(param_dtype, moment_dtype, clip):
    """Three steps, the same gradients given to both sides each step."""
    cfg = OptimizerConfig(lr=1e-2, moment_dtype=moment_dtype)
    pdt = getattr(torch, param_dtype)
    params = to_torch(rand_tree(2), pdt)
    jparams = to_jax(rand_tree(2), jnp.dtype(param_dtype))
    state = P.adamw_init(params, cfg)
    jstate = J.adamw_init(jparams, ref_opt(cfg))
    for i in range(3):
        g = rand_tree(10 + i, scale=2.0)
        lr = P.cosine_warmup(i, cfg.lr, 1, 3)
        jlr = J.cosine_warmup(jnp.int32(i), cfg.lr, 1, 3)
        grads, jgrads = to_torch(g, pdt), to_jax(g, jnp.dtype(param_dtype))
        scale = None
        if clip is not None:
            scale, _ = P.clip_by_global_norm(grads, clip)
            jgrads, _ = J.clip_by_global_norm(jgrads, clip)
        out = P.adamw_update(params, grads, state, cfg, lr, grad_scale=scale)
        assert out[0] is params and out[1] is state
        jparams, jstate = J.adamw_update(jparams, jgrads, jstate, ref_opt(cfg), jlr)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    tol = {"float32": 1e-6, "bfloat16": BF16_RTOL}
    for (path, t), (_, w) in zip(leaves(params), leaves(jparams)):
        assert t.dtype == pdt
        close(t, w, rtol=tol[param_dtype], atol=1e-7, msg=str(path))
    for name in ("m", "v"):
        for (path, t), (_, w) in zip(leaves(state[name]), leaves(jstate[name])):
            assert str(t.dtype)[6:] == moment_dtype
            close(t, w, rtol=tol[moment_dtype], atol=1e-7, msg=f"{name} {path}")


def test_adamw_update_slices_large_leaves(monkeypatch):
    """A leaf updated in slices of its first axis is updated bit for bit
    as a whole (elementwise arithmetic)."""
    cfg = OptimizerConfig(lr=1e-2, moment_dtype="bfloat16")
    tree = {"w": (np.random.default_rng(4).standard_normal((9, 4, 3))).astype(np.float32)}
    results = []
    for chunk in (1 << 26, 12, 5):
        monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", chunk)
        params = to_torch(tree, torch.bfloat16)
        state = P.adamw_init(params, cfg)
        grads = to_torch({"w": tree["w"] * 0.3}, torch.bfloat16)
        scale, gnorm = P.clip_by_global_norm(grads, 0.1)
        P.adamw_update(params, grads, state, cfg, torch.tensor(1e-2), grad_scale=scale)
        results.append((params["w"], state["m"]["w"], state["v"]["w"], gnorm))
    for other in results[1:]:
        for a, b in zip(results[0][:3], other[:3]):
            assert torch.equal(a, b)
        close(other[3], results[0][3], rtol=1e-6)


def test_adamw_rejects_mismatched_gradients():
    params = to_torch(rand_tree(0))
    state = P.adamw_init(params, OptimizerConfig())
    grads = to_torch(rand_tree(0))
    grads["a"] = torch.zeros(3)
    with pytest.raises(ValueError, match="does not match"):
        P.adamw_update(params, grads, state, OptimizerConfig(), 1e-3)
    del grads["a"]
    with pytest.raises(ValueError, match="3 gradients .* for 4 parameters"):
        P.adamw_update(params, grads, state, OptimizerConfig(), 1e-3)
    assert int(state["step"]) == 0  # refused before any write


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grads_int8_equals_the_reference(seed, with_residual):
    g = rand_tree(seed, scale=0.01 * (seed + 1))
    res = rand_tree(seed + 50, scale=1e-4) if with_residual else None
    q, s, r = P.compress_grads_int8(to_torch(g), None if res is None else to_torch(res))
    jq, js, jr = j_compress(to_jax(g), None if res is None else to_jax(res))
    for (path, a), (_, b) in zip(leaves(q), leaves(jq)):
        assert a.dtype == torch.int8
        assert np.array_equal(a.numpy(), np.asarray(b)), path
    for (path, a), (_, b) in zip(leaves(s), leaves(js)):
        close(a, b, rtol=1e-7, msg=str(path))
    for (path, a), (_, b) in zip(leaves(r), leaves(jr)):
        close(a, b, rtol=1e-6, atol=1e-9, msg=str(path))
    d = P.decompress_grads_int8(q, s)
    jd = j_decompress(jq, js)
    for (path, a), (_, b) in zip(leaves(d), leaves(jd)):
        close(a, b, rtol=1e-6, atol=1e-9, msg=str(path))


def test_compress_takes_bfloat16_gradients():
    g = rand_tree(3, scale=0.1)
    q, s, _ = P.compress_grads_int8(to_torch(g, torch.bfloat16))
    jq, js, _ = j_compress(map_tree(lambda a: jnp.asarray(a.astype(ml_dtypes.bfloat16)), g))
    for (_, a), (_, b) in zip(leaves(q), leaves(jq)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for (_, a), (_, b) in zip(leaves(s), leaves(js)):
        close(a, b, rtol=1e-7)
