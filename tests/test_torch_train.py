"""The port's training path against the JAX package's, on the CPU.

Seeded numpy batches and the reference's own weights (``init_params``
with a ``PRNGKey``, brought across with ``interop``) go through
``repro.models`` / ``repro.launch.steps`` (JAX on the CPU, its sorts on
the pure-jnp path, as ``tests/test_models.py`` runs them) and through
``repro_torch`` with every tensor on the CPU (the kernels' plain
versions).  Tolerances, all float32:

* ``lm_loss`` 1e-5 (rtol and atol), under every ``remat``;
* gradients leaf by leaf within rtol 1e-4 plus an atol of 1e-6 and a
  share of the leaf's largest gradient: 2e-5 for one layer, 2e-3 for
  the whole model.  An absolute 1e-6 does not hold for float32 gradients
  of this size on either side: at the reference's weights (R7) they
  reach 10^3 in a layer and 40 in the model, and the first layer's pass
  through the second's peaky softmax backward amplifies rounding
  (measured: up to 1.1e-5 of the leaf's largest gradient for one layer,
  9e-4 for the model over eight seeds; the reference's own float32
  gradient lies 2.3e-5 of it from a float64 evaluation).  The port's
  ``sample_sort`` is held against the reference's ``xla_sort`` on every
  leaf; against the reference's ``sample_sort`` only on the leaves no
  gate gradient reaches (the unembedding, the final norm, the last
  layer's experts): the reference's K4 codec cuts the gates' gradient
  (ROADMAP.md Queue 3 R8), which changes every leaf upstream of a
  router; the port takes the gates by gather (D21);
* ``chunked_attention``'s gradient 1e-5;
* three ``build_train_step`` steps: losses 1e-4, parameters within
  2 * lr * steps (an AdamW step moves an element by at most about lr,
  and a near-zero gradient may flip its sign).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as RC  # noqa: E402
from repro.core import clear_degradation_log, degradation_log  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import meta as jax_meta  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.config import (  # noqa: E402
    LayerSlot,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import api, meta, moe  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
REMATS = ["none", "full", "dots"]
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LAYER_REL, MODEL_REL = 2e-5, 2e-3


@pytest.fixture(autouse=True)
def _no_degradation():
    """Neither side's sorts may take a degradation chain."""
    clear_degradation_log()
    port_guard.clear_degradation_log()
    yield
    assert degradation_log() == ()
    assert port_guard.degradation_log() == ()


def to_ref(cfg: ModelConfig) -> RC.ModelConfig:
    """The reference's ModelConfig with the same fields."""
    d = dataclasses.asdict(cfg)
    d["layer_pattern"] = tuple(RC.LayerSlot(**s) for s in d["layer_pattern"])
    for key, cls in (("moe", RC.MoEConfig), ("mla", RC.MLAConfig),
                     ("ssm", RC.SSMConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return RC.ModelConfig(**d)


def smoke(arch, **over) -> ModelConfig:
    cfg = configs.get_smoke(arch)
    moe_over = over.pop("dispatch", None)
    if moe_over is not None:
        over["moe"] = dataclasses.replace(cfg.moe, dispatch=moe_over)
    return dataclasses.replace(cfg, **over)


def ref_params(cfg: ModelConfig, seed: int = 0):
    tpl = jax_api.template(to_ref(cfg))
    return jax.tree.map(np.asarray, jax_meta.init_params(tpl, jax.random.PRNGKey(seed)))


def batch_for(cfg: ModelConfig, b=2, s=32, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss_and_grads(cfg, params_np, batch):
    """The port's loss and gradient tree (stacked, the template's shape)
    through ``build_train_step``'s binding, without the update."""
    model = interop.params_from_jax(params_np, cfg, "cpu").requires_grad_(True)
    loss = api.loss_fn(model, tbatch(batch), cfg)
    loss.backward()
    grads = {}
    for path, period, p in model.param_slices():
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if period is None:
            node[path[-1]] = p.grad.numpy()
        else:
            node.setdefault(path[-1], []).append(p.grad.numpy())
    return float(loss.detach()), {"/".join(p): (np.stack(g) if isinstance(g, list) else g)
                         for p, g in _flat(grads)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def ref_loss_and_grads(cfg, params_np, batch):
    rcfg = to_ref(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.value_and_grad(lambda p: jax_api.loss_fn(p, jb, rcfg))(
        jax.tree.map(jnp.asarray, params_np))
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return float(loss), {"/".join(k.key for k in path): np.asarray(leaf)
                         for path, leaf in flat}


def assert_grad_close(got, want, rel, key):
    """|got - want| <= GRAD_RTOL |want| + GRAD_ATOL + rel max|want|."""
    atol = GRAD_ATOL + rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=key)


def _chip_smoke():
    """chip_smoke.py, loaded from the repository root."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_equals_the_reference(arch, remat):
    cfg = smoke(arch, remat=remat)
    params = ref_params(cfg)
    batch = batch_for(cfg)
    model = interop.params_from_jax(params, cfg, "cpu")
    got = float(T.lm_loss(model, tbatch(batch), cfg))
    want = float(jax_api.loss_fn(jax.tree.map(jnp.asarray, params),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 to_ref(cfg)))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_ce_sums_its_chunks(arch):
    """loss_chunk smaller than the sequence: the chunks' CE sums to the
    one-chunk CE, and the reference's chunked sum."""
    cfg = smoke(arch, loss_chunk=8)
    params = ref_params(cfg)
    batch = batch_for(cfg)
    model = interop.params_from_jax(params, cfg, "cpu")
    x, _ = T.lm_forward(model, tbatch(batch)["tokens"], cfg)
    got = float(T.chunked_ce(model, x, tbatch(batch)["targets"], cfg))
    whole = float(T.chunked_ce(model, x, tbatch(batch)["targets"],
                               dataclasses.replace(cfg, loss_chunk=2048)))
    np.testing.assert_allclose(got, whole, rtol=LOSS_TOL)
    from repro.models import transformer as JT
    jp = jax.tree.map(jnp.asarray, params)
    jx, _ = JT.lm_forward(jp, jnp.asarray(batch["tokens"]), to_ref(cfg))
    want = float(JT.chunked_ce(jp, jx, jnp.asarray(batch["targets"]), to_ref(cfg)))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


# ----------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_equal_the_reference(arch):
    """The port's sample_sort gradients against the reference's
    xla_sort, every leaf."""
    cfg = smoke(arch, dispatch="sample_sort")
    params = ref_params(cfg)
    batch = batch_for(cfg)
    loss, got = port_loss_and_grads(cfg, params, batch)
    want_loss, want = ref_loss_and_grads(smoke(arch, dispatch="xla_sort"), params, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_grad_close(got[key], want[key], MODEL_REL, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_gradient_shows_r8_and_d21(arch):
    """R8: the reference's sample_sort router gets only the aux loss's
    gradient (its gates come through the codec's bitcast), far less than
    its xla_sort router; the leaves that no gate gradient reaches agree
    with the port's.  D21: the port's sample_sort router gradient is the
    xla_sort one."""
    cfg = smoke(arch)
    params = ref_params(cfg)
    batch = batch_for(cfg)
    key = "period/slot0/moe/router"
    _, ref_ss = ref_loss_and_grads(smoke(arch, dispatch="sample_sort"), params, batch)
    _, ref_xs = ref_loss_and_grads(smoke(arch, dispatch="xla_sort"), params, batch)
    _, port = port_loss_and_grads(smoke(arch, dispatch="sample_sort"), params, batch)
    l1 = {name: float(np.abs(g[key]).sum())
          for name, g in (("ref_ss", ref_ss), ("ref_xs", ref_xs), ("port", port))}
    assert l1["ref_ss"] < 0.1 * l1["ref_xs"], l1  # R8
    assert_grad_close(port[key], ref_xs[key], MODEL_REL, key)  # D21
    last = cfg.n_periods - 1
    for k in ("embed/unembed", "final_norm/w"):
        assert_grad_close(port[k], ref_ss[k], MODEL_REL, k)
    for w in ("wg", "wu", "wd"):
        k = f"period/slot0/moe/{w}"
        assert_grad_close(port[k][last], ref_ss[k][last], MODEL_REL, k)


@pytest.mark.parametrize("ref_dispatch", ["xla_sort", "sample_sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_gradients_equal_the_reference(arch, ref_dispatch):
    """One layer's attention and MoE (K4, K1 and K2's plain versions on
    the sample_sort route), their parameters' and input's gradients
    under a random output gradient and the aux loss: against the
    reference's xla_sort on every leaf, and against its sample_sort on
    the expert weights (R8 reaches the rest)."""
    from repro.models import layers as JL
    from repro.models import moe as JM
    from repro_torch.models import layers as L

    cfg = smoke(arch, dispatch="sample_sort")
    rc = to_ref(smoke(arch, dispatch=ref_dispatch))
    lp = jax.tree.map(lambda a: a[0], ref_params(cfg)["period"]["slot0"])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32)[None]

    def ref_fn(p, x):
        y, aux = JM.moe_apply(p["moe"], JL.norm_apply(p["ln2"], x, rc), rc)
        a = JA.gqa_forward(p["attn"], JL.norm_apply(p["ln"], x, rc), rc, jnp.asarray(pos))
        return jnp.sum((y + a) * gy) + 3.0 * aux

    want_p, want_x = jax.grad(ref_fn, argnums=(0, 1))(jax.tree.map(jnp.asarray, lp),
                                                      jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), lp)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_apply(tp["moe"], L.norm_apply(tp["ln2"], tx, cfg), cfg)
    a = A.gqa_forward(tp["attn"], L.norm_apply(tp["ln"], tx, cfg), cfg, torch.from_numpy(pos))
    (torch.sum((y + a) * torch.from_numpy(gy)) + 3.0 * aux).backward()
    want = dict(_flat(jax.tree.map(np.asarray, want_p)))
    got = dict(_flat(jax.tree.map(lambda t: t.grad.numpy(), tp)))
    keys = list(want) if ref_dispatch == "xla_sort" else [
        ("moe", w) for w in ("wg", "wu", "wd")]
    for k in keys:
        assert_grad_close(got[k], want[k], LAYER_REL, "/".join(k))
    if ref_dispatch == "xla_sort":
        assert_grad_close(tx.grad.numpy(), np.asarray(want_x), LAYER_REL, "x")


@pytest.mark.parametrize("dispatch", ["xla_sort", "onehot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_dispatches_give_the_same_gradients(arch, dispatch):
    """The ranks are integers and the gates the same bits on every route,
    so the port's loss and gradients are bit-identical across them."""
    params = ref_params(smoke(arch))
    batch = batch_for(smoke(arch))
    want_loss, want = port_loss_and_grads(smoke(arch, dispatch="sample_sort"), params, batch)
    loss, got = port_loss_and_grads(smoke(arch, dispatch=dispatch), params, batch)
    assert loss == want_loss
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_loss_and_gradients(remat):
    """Recomputing a layer's forward in the backward changes nothing on
    the CPU: the same loss and gradients as remat="none", bit for bit."""
    arch = "qwen3-moe-30b-a3b"
    params = ref_params(smoke(arch))
    batch = batch_for(smoke(arch))
    want_loss, want = port_loss_and_grads(smoke(arch, remat="none"), params, batch)
    loss, got = port_loss_and_grads(smoke(arch, remat=remat), params, batch)
    assert loss == want_loss
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_remat_recomputes_the_sorts(monkeypatch):
    """Under remat "full" or "dots" each MoE layer's router top-k and
    dispatch sort run twice in a step (forward and recompute), once
    under "none"."""
    from repro_torch.kernels import topk as topk_kernel

    calls = []
    real = topk_kernel.topk_desc
    monkeypatch.setattr(topk_kernel, "topk_desc",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    params = ref_params(smoke("qwen3-moe-30b-a3b"))
    batch = batch_for(smoke("qwen3-moe-30b-a3b"))
    for remat, want in (("none", 2), ("full", 4), ("dots", 4)):
        calls.clear()
        port_loss_and_grads(smoke("qwen3-moe-30b-a3b", remat=remat), params, batch)
        assert len(calls) == want, remat


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,chunk", [(13, 4), (32, 16), (16, 32)])
def test_chunked_attention_gradient_equals_the_reference(sq, chunk, causal):
    """The online softmax under autograd (its in-place steps and the
    detached running max) against jax.grad of the reference's."""
    rng = np.random.default_rng(sq + chunk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    g = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = A.chunked_attention(tq, tk, tv, chunk=chunk, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(
        JA.chunked_attention(q, k, v, chunk=chunk, causal=causal) * g),
        argnums=(0, 1, 2))(q, k, v)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_gates_carry_the_router_gradient():
    """D21: on the sample_sort route the gates are the probabilities at
    K4's ids, bit-equal to the library route's, and carry a gradient."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((64, 16)).astype(np.float32),
                          requires_grad=True)
    gs, ids = moe._topk_gates(logits, 4, "sample_sort")
    gx, idx = moe._topk_gates(logits, 4, "xla_sort")
    assert torch.equal(ids, idx)
    assert torch.equal(gs.detach().view(torch.int32), gx.detach().view(torch.int32))
    assert gs.grad_fn is not None
    (g1,) = torch.autograd.grad(gs.sum(), logits)
    (g2,) = torch.autograd.grad(gx.sum(), logits)
    assert torch.equal(g1, g2)


# ------------------------------------------------------- the parameters
def test_gradients_land_in_the_stacked_tree(monkeypatch):
    """The per-layer parameters view the stacked tree; the training step
    binds their gradients to views of one stacked gradient tree, and the
    in-place update writes through to every layer."""
    cfg = smoke("qwen3-moe-30b-a3b", n_layers=3)
    params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
    opt = OptimizerConfig(warmup_steps=0)
    opt_state = adamw_init(params, opt)
    seen = []
    real = api.loss_fn
    monkeypatch.setattr(api, "loss_fn", lambda m, *a: seen.append(m) or real(m, *a))
    step = steps.build_train_step(cfg, opt)
    before = params["period"]["slot0"]["moe"]["wg"].clone()
    step(params, opt_state, batch_for(cfg))
    step(params, opt_state, batch_for(cfg, seed=1))
    stacked = params["period"]["slot0"]["moe"]["wg"]
    assert not torch.equal(stacked, before)
    assert seen[0] is seen[1]  # the same params: the same model and buffers
    model = seen[0]
    g0 = model.layers[0].moe.wg.grad
    base = g0._base
    assert base is not None and base.shape == stacked.shape and base.dtype == stacked.dtype
    for j, layer in enumerate(model.layers):
        assert layer.moe.wg.data_ptr() == stacked[j].data_ptr()
        assert layer.moe.wg.grad._base is base
        assert layer.moe.wg.grad.data_ptr() == base[j].data_ptr()
        assert torch.equal(T.CausalLM(cfg, params).layers[j].moe.wg, stacked[j])
    assert bool(base.abs().sum() > 0)
    fresh = {k: v for k, v in params.items()}  # another tree: a new model
    step(fresh, opt_state, batch_for(cfg))
    assert seen[2] is not model


def test_serving_model_keeps_no_gradient():
    cfg = smoke("qwen3-moe-30b-a3b")
    model = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = api.prefill(model, {"tokens": tbatch(batch_for(cfg))["tokens"]}, cfg, 40)
    assert logits.grad_fn is None and not logits.requires_grad


# ------------------------------------------------------------ the steps
def ref_train_step(cfg, opt, accum=1):
    """The reference's jitted train step on the xla_sort route (its
    sample_sort route cuts the gates' gradient, R8)."""
    xla = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="xla_sort"))
    plan = types.SimpleNamespace(model=to_ref(xla),
                                 parallel=RC.ParallelConfig(grad_accum=accum))
    return jax.jit(jax_steps.build_train_step(plan, RC.OptimizerConfig(
        **dataclasses.asdict(opt))))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_equal_the_reference(arch):
    cfg = smoke(arch)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    params_np = ref_params(cfg)
    jp = jax.tree.map(jnp.asarray, params_np)
    jo = jax_adamw_init(jp, RC.OptimizerConfig(**dataclasses.asdict(opt)))
    params, opt_state = interop.train_state_from_jax(
        params_np, jax.tree.map(np.asarray, jo), cfg, "cpu")
    port_step = steps.build_train_step(cfg, opt)
    jstep = ref_train_step(cfg, opt)
    for i in range(3):
        batch = batch_for(cfg, seed=i)
        params, opt_state, m = port_step(params, opt_state, batch)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=1e-3)
    bound = 2 * opt.lr * 3
    flat = dict(_flat(jax.tree.map(np.asarray, jp)))
    for path, t in leaves(params):
        np.testing.assert_allclose(t.numpy(), flat[path], rtol=0, atol=bound,
                                   err_msg="/".join(path))
    assert int(opt_state["step"]) == int(jo["step"]) == 3


def test_grad_accum_equals_the_reference():
    """grad_accum=2: two microbatches' float32 gradients summed and
    averaged, the loss their mean."""
    cfg = smoke("qwen3-moe-30b-a3b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=2)
    params_np = ref_params(cfg)
    jp = jax.tree.map(jnp.asarray, params_np)
    jo = jax_adamw_init(jp, RC.OptimizerConfig(**dataclasses.asdict(opt)))
    params, opt_state = interop.train_state_from_jax(
        params_np, jax.tree.map(np.asarray, jo), cfg, "cpu")
    batch = batch_for(cfg, b=4, s=16)
    _, _, m = steps.build_train_step(cfg, opt, ParallelConfig(grad_accum=2))(
        params, opt_state, batch)
    jp, jo, jm = ref_train_step(cfg, opt, accum=2)(
        jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=1e-3)
    flat = dict(_flat(jax.tree.map(np.asarray, jp)))
    for path, t in leaves(params):
        np.testing.assert_allclose(t.numpy(), flat[path], rtol=0, atol=2 * opt.lr)


def test_train_state_crosses_both_ways():
    cfg = smoke("qwen3-moe-30b-a3b")
    opt = RC.OptimizerConfig(moment_dtype="bfloat16")
    jp = jax.tree.map(jnp.asarray, ref_params(cfg))
    jo = jax_adamw_init(jp, opt)
    jo = {"m": jax.tree.map(lambda x: x + 0.5, jo["m"]), "v": jo["v"],
          "step": jnp.int32(7)}
    params, state = interop.train_state_from_jax(
        jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jo), cfg, "cpu")
    assert state["m"]["embed"]["tok"].dtype == torch.bfloat16
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    back = interop.opt_state_to_jax(state)
    for path, leaf in leaves(back["m"]):
        assert np.array_equal(leaf, np.asarray(dict(_flat(jo["m"]))[path], np.float32))
    assert back["step"].dtype == np.int32 and int(back["step"]) == 7
    for path, t in leaves(params):
        assert np.array_equal(t.numpy(), np.asarray(dict(_flat(jp))[path]))


# ---------------------------------------------------- launch and the API
def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = train.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] qwen3-moe-30b-a3b-smoke" in out and "[train] done: loss" in out
    assert [h["step"] for h in first] == [0, 1, 2, 3]
    assert np.isfinite(first[-1]["loss"])
    resumed = train.main(args + ["--steps", "6"])
    assert "[runtime] resuming from checkpoint step 4" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [4, 5]
    with pytest.raises(SystemExit, match="nothing to run"):
        train.main(args + ["--steps", "6"])


def test_train_cli_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 12e"):
        train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                    "--mesh", "2x1"])


@pytest.mark.parametrize("name", ["make_plan", "param_shardings", "lower_cell"])
def test_sharded_step_parts_name_item_12e(name):
    with pytest.raises(NotImplementedError, match="item 12e"):
        getattr(steps, name)()


def test_prefill_and_decode_steps_equal_the_api():
    cfg = smoke("qwen3-moe-30b-a3b")
    model = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = ShapeConfig("t", 16, 2, "prefill")
    assert steps.cache_len_for(cfg, shape) == 16
    toks = tbatch(batch_for(cfg, s=16))["tokens"]
    got, caches = steps.build_prefill_step(cfg, shape)(model, {"tokens": toks})
    want, _ = api.prefill(model, {"tokens": toks}, cfg, 16)
    assert torch.equal(got, want)
    caches = [{k: torch.cat([v, torch.zeros_like(v[:, :1])], 1) for k, v in c.items()}
              for c in caches]
    tok = got.argmax(-1)[:, None]
    a, _ = steps.build_decode_step(cfg)(model, tok, caches, 16)
    assert a.shape == (2, cfg.padded_vocab)


@pytest.mark.parametrize("over", [{}, {"n_encoder_layers": 2},
                                  {"frontend": "vision", "frontend_len": 8}])
def test_make_batch_shapes_equal_the_reference(over):
    cfg = dataclasses.replace(smoke("qwen3-moe-30b-a3b"), **over)
    got = api.make_batch_shapes(cfg, 4, 32)
    want = jax_api.make_batch_shapes(to_ref(cfg), 4, 32)
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and str(got[k].dtype)[6:] == str(v.dtype)
        assert got[k].device.type == "meta"
    ref_shape = types.SimpleNamespace(model=to_ref(cfg), shape=RC.ShapeConfig("t", 32, 4))
    assert steps.cache_len_for(cfg, ShapeConfig("t", 32, 4)) == jax_steps.cache_len_for(ref_shape)


def test_training_launches_on_the_cpu_equal_chip_smokes_count(monkeypatch):
    """A CPU rehearsal of the training phase's launch counts: each call of
    a kernel dispatcher is one launch on the card, and a remat="full"
    step must make the launches ``chip_smoke.training_launches`` holds
    the card to (the forward's, twice).  2 x 600 tokens at top-8 are
    9,600 ids: past the dispatch sort's direct_max, a bucket round."""
    import collections

    from repro_torch.kernels import ops
    from repro_torch.kernels import topk as topk_kernel

    calls = collections.Counter()

    def spy(owner, name, kernel):
        real = getattr(owner, name)

        def call(*args, **kw):
            calls[kernel] += 1
            return real(*args, **kw)
        monkeypatch.setattr(owner, name, call)

    spy(ops, "sort_tiles", "tile_sort")
    spy(ops, "sort_tiles_sample", "tile_sort")
    spy(ops, "splitter_partition", "splitter_partition")
    spy(ops, "splitter_ranks", "splitter_ranks")
    spy(topk_kernel, "topk_desc", "topk")
    base = configs.get_smoke("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(base, n_layers=2, attn_chunk=256, remat="full",
                              moe=dataclasses.replace(base.moe, n_experts=16, top_k=8))
    params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
    opt = OptimizerConfig()
    step = steps.build_train_step(cfg, opt)
    step(params, adamw_init(params, opt), batch_for(cfg, b=2, s=600))
    want = _chip_smoke().training_launches(cfg, 2 * 600)
    assert dict(calls) == want
    assert want["topk"] == 2 * 2 and want["splitter_partition"] == 2 * 2
