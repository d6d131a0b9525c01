"""The port's serving model against the JAX package's, on the CPU.

Seeded numpy inputs and the reference's own weights (``init_params``
with a ``PRNGKey``, brought across with ``interop.params_from_jax``) go
through ``repro.models`` (eagerly, as ``tests/test_models.py`` runs it;
its sorts take the pure-jnp path) and through ``repro_torch.models``
with every tensor on the CPU (the kernels' plain versions).  Configs,
templates, ids, ranks and counts must be equal exactly; floats agree
within tolerances stated per test, all float32:

* layers and attention 1e-5 (rtol and atol): the same ops in another
  order of summation;
* router gates 1e-6;
* ``moe_apply`` 2e-5 (a sum of k expert outputs after three products);
* whole-model logits 1e-4 (two layers, the errors above compounded).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as RC  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core import clear_degradation_log, degradation_log  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import meta as jax_meta  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.config import LayerSlot, ModelConfig, MoEConfig  # noqa: E402
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.models import api, meta  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
FULL_PARAMS = {"qwen3-moe-30b-a3b": 30_079_649_792,
               "moonshot-v1-16b-a3b": 28_057_995_264}
DISPATCHES = ["sample_sort", "xla_sort", "onehot"]


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


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def to_torch_tree(tree):
    return jax.tree.map(tt, tree)


def ref_params(template, seed: int):
    return jax.tree.map(np.asarray, jax_meta.init_params(template, jax.random.PRNGKey(seed)))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def small_cfg(**over) -> ModelConfig:
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=48, vocab=100, param_dtype="float32", dtype="float32",
                attn_chunk=16, layer_pattern=(LayerSlot("attn", "moe"),),
                moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16))
    base.update(over)
    return ModelConfig(**base)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    ours = configs.get_smoke(arch) if smoke else configs.get_config(arch).model
    ref = jax_configs.get_smoke(arch) if smoke else jax_configs.get_config(arch).model
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.dh, ours.padded_vocab, ours.n_periods) == (ref.dh, ref.padded_vocab, ref.n_periods)
    if not smoke:
        a, b = configs.get_config(arch), jax_configs.get_config(arch)
        assert (a.shapes, a.skip_notes != "", a.fsdp, a.moment_dtype) == (
            b.shapes, b.skip_notes != "", b.fsdp, b.moment_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_counts(arch):
    cfg = configs.get_config(arch).model
    ours = meta.count_params(api.template(cfg))
    assert ours == FULL_PARAMS[arch]
    assert ours == jax_meta.count_params(jax_api.template(to_ref(cfg)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_templates_equal_the_reference(arch, smoke):
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch).model
    ours = meta.tree_leaves(api.template(cfg))
    ref = jax.tree_util.tree_flatten_with_path(
        jax_api.template(to_ref(cfg)), is_leaf=jax_meta.is_meta)[0]
    assert [p for p, _ in ours] == [tuple(k.key for k in p) for p, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert (a.shape, a.axes, a.dtype, a.init, a.scale) == (
            b.shape, b.axes, b.dtype, b.init, b.scale)


@pytest.mark.parametrize("arch", sorted(set(jax_configs.ARCHS) - set(ARCHS)))
def test_unported_archs_name_item_12(arch):
    with pytest.raises(NotImplementedError, match="item 12"):
        configs.get_config(arch)
    with pytest.raises(NotImplementedError, match="item 12"):
        configs.get_smoke(arch)


def test_unported_layers_and_training_name_item_12():
    for mixer in ("mla", "mamba"):
        cfg = small_cfg(layer_pattern=(LayerSlot(mixer, "moe"),))
        with pytest.raises(NotImplementedError, match="item 12"):
            api.template(cfg)
        with pytest.raises(NotImplementedError, match="item 12"):
            T.CausalLM(cfg, {})
    with pytest.raises(NotImplementedError, match="item 12"):
        api.template(small_cfg(n_encoder_layers=2))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="item 12"):
        api.loss_fn(None, batch, small_cfg(n_encoder_layers=2))
    with pytest.raises(NotImplementedError, match="item 12"):
        api.loss_fn(None, {**batch, "prefix_embeds": batch["tokens"]}, small_cfg())


# --------------------------------------------------------------- init
def test_init_params_follows_the_reference_scales():
    cfg = small_cfg(n_layers=4, d_model=64, vocab=300)
    tpl = api.template(cfg)
    got = meta.init_params(tpl, torch.Generator().manual_seed(0), "cpu")
    for path, m in meta.tree_leaves(tpl):
        x = got
        for k in path:
            x = x[k]
        assert tuple(x.shape) == m.shape and x.dtype == meta.torch_dtype(m.dtype)
        if m.init == "ones":
            assert bool((x == 1).all())
        elif m.init == "zeros":
            assert bool((x == 0).all())
        else:  # R7: stacked weights take 1/sqrt(n_periods)
            want = 0.02 if m.init == "small" else m.shape[0] ** -0.5
            assert abs(float(x.std()) / want - 1) < 0.1, path
    assert meta.init_scale(tpl["period"]["slot0"]["moe"]["wg"]) == 4 ** -0.5


def test_init_params_draws_a_leaf_in_slices(monkeypatch):
    """A leaf larger than a draw is drawn slice by slice along its first
    axis, each slice from the generator's stream in turn."""
    m = meta.ParamMeta((6, 5, 4), (None, None, None), "bfloat16")
    whole = meta.init_params({"w": m}, torch.Generator().manual_seed(3), "cpu")["w"]
    monkeypatch.setattr(meta, "DRAW_ELEMENTS", 20)
    sliced = meta.init_params({"w": m}, torch.Generator().manual_seed(3), "cpu")["w"]
    g = torch.Generator().manual_seed(3)
    want = torch.cat([torch.randn((1, 5, 4), generator=g) * 6 ** -0.5 for _ in range(6)])
    assert torch.equal(sliced, want.to(torch.bfloat16))
    assert whole.dtype == torch.bfloat16 and whole.shape == (6, 5, 4)


def test_model_parameters_view_the_stacked_tree():
    cfg = small_cfg(n_layers=3)
    params = meta.init_params(api.template(cfg), torch.Generator().manual_seed(0), "cpu")
    model = T.CausalLM(cfg, params)
    stacked = params["period"]["slot0"]["moe"]["wg"]
    for j, layer in enumerate(model.layers):
        assert layer.moe.wg.data_ptr() == stacked[j].data_ptr()
        assert not layer.moe.wg.requires_grad
    names = dict(model.named_parameters())
    assert "layers.2.attn.wq" in names and "embed.unembed" in names
    assert sum(p.numel() for p in names.values()) == meta.count_params(api.template(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_reference_tree(arch):
    cfg = configs.get_smoke(arch)
    tree = ref_params(jax_api.template(to_ref(cfg)), 0)
    back = interop.params_to_jax(interop.params_from_jax(tree, cfg, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_the_references_per_layer(arch):
    """The reference stacks its zero caches per period; the port keeps a
    list with one (B, L, K, Dh) pair a layer, as prefill returns them."""
    cfg = configs.get_smoke(arch)
    want = jax_api.init_cache(to_ref(cfg), 3, 11)
    got = api.init_cache(cfg, 3, 11, "cpu")
    assert len(got) == cfg.n_layers
    for j, cache in enumerate(got):
        for key in ("k", "v"):
            ref = np.asarray(want["slot0"][key][j])
            assert cache[key].shape == ref.shape and cache[key].dtype == torch.float32
            assert not bool(cache[key].any())
    model = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    _, caches = api.prefill(model, {"tokens": torch.zeros((3, 5), dtype=torch.int64)}, cfg, 11)
    assert [{k: v.shape for k, v in c.items()} for c in caches] == [
        {k: v.shape for k, v in c.items()} for c in got]


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply(rng, norm):
    cfg = small_cfg(norm=norm)
    p = {"w": rng.normal(size=32).astype(np.float32),
         "b": rng.normal(size=32).astype(np.float32)}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    want = JL.norm_apply(p, jnp.asarray(x), to_ref(cfg))
    close(L.norm_apply(to_torch_tree(p), tt(x), cfg), want, 1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_apply(rng, activation):
    cfg = small_cfg(activation=activation)
    p = ref_params(JL.mlp_template(to_ref(cfg)), 4)
    p = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, p)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = JL.mlp_apply(p, jnp.asarray(x), to_ref(cfg))
    close(L.mlp_apply(to_torch_tree(p), tt(x), cfg), want, 1e-5)


@pytest.mark.parametrize("dh,theta", [(16, 10000.0), (64, 1e6), (8, 500.0)])
def test_apply_rope(rng, dh, theta):
    x = rng.normal(size=(2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(L.apply_rope(tt(x), tt(pos), theta), want, 1e-5)
    close(L.rope_angles(tt(pos), dh, theta), JL.rope_angles(jnp.asarray(pos), dh, theta), 1e-5)


@pytest.mark.parametrize("vocab,tie", [(100, False), (256, False), (300, True)])
def test_embed_and_unembed(rng, vocab, tie):
    cfg = small_cfg(vocab=vocab, tie_embeddings=tie)
    p = ref_params(JL.embed_template(to_ref(cfg)), 5)
    tokens = rng.integers(0, vocab, (3, 6))
    close(L.embed_apply(to_torch_tree(p), tt(tokens), cfg),
          JL.embed_apply(p, jnp.asarray(tokens), to_ref(cfg)), 1e-5)
    x = rng.normal(size=(3, 6, 32)).astype(np.float32)
    got = L.unembed_apply(to_torch_tree(p), tt(x), cfg)
    want = JL.unembed_apply(p, jnp.asarray(x), to_ref(cfg))
    assert got.shape == (3, 6, cfg.padded_vocab)
    close(got, want, 1e-5)
    assert bool((got[..., vocab:] == -1e9).all())


# ----------------------------------------------------------- attention
# Causal cases are self-attention (sq == sk); chunk < seq, padded lengths.
@pytest.mark.parametrize("causal,sq,sk,chunk", [
    (c, s, s, ch) for c in (True, False)
    for s, ch in ((64, 16), (64, 64), (60, 16), (37, 16), (5, 32))
] + [(False, 20, 37, 16), (False, 37, 20, 8)])
def test_chunked_attention(rng, causal, sq, sk, chunk):
    b, h, kh, d = 2, 4, 2, 16
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                chunk=chunk, causal=causal)
    got = A.chunked_attention(tt(q), tt(k), tt(v), chunk=chunk, causal=causal)
    close(got, want, 1e-5)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 32)])
def test_gqa_prefill_and_decode(rng, bias, s, chunk):
    cfg = small_cfg(attn_bias=bias, attn_chunk=chunk, rope_theta=1e6)
    p = ref_params(JA.gqa_template(to_ref(cfg)), 6)
    p = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, p)
    pt = to_torch_tree(p)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    cache_len = s + 3
    pos = np.arange(s)[None, :]
    want, wcache = JA.gqa_prefill(p, jnp.asarray(x), to_ref(cfg), jnp.asarray(pos), cache_len)
    got, cache = A.gqa_prefill(pt, tt(x), cfg, tt(pos), cache_len)
    close(got, want, 1e-5)
    for key in ("k", "v"):
        close(cache[key], wcache[key], 1e-5)
    for i in range(3):
        xd = rng.normal(size=(2, 1, 32)).astype(np.float32)
        want, wcache = JA.gqa_decode(p, jnp.asarray(xd), to_ref(cfg), wcache, jnp.int32(s + i))
        got, cache = A.gqa_decode(pt, tt(xd), cfg, cache, s + i)
        close(got, want, 1e-5)
        for key in ("k", "v"):
            close(cache[key], wcache[key], 1e-5)


# ----------------------------------------------------------------- MoE
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("n,e,k,ties", [(64, 8, 2, False), (300, 128, 8, False),
                                        (50, 16, 4, True), (7, 64, 6, True)])
def test_topk_gates(rng, dispatch, n, e, k, ties):
    logits = rng.normal(size=(n, e)).astype(np.float32)
    if ties:  # whole rows and runs of equal logits
        logits = np.round(logits)
        logits[::3] = 0.5
    wg, wi = JM._topk_gates(jnp.asarray(logits), k, dispatch)
    g, i = M._topk_gates(tt(logits), k, dispatch)
    assert i.dtype == torch.int32 and g.dtype == torch.float32
    assert np.array_equal(i.numpy(), np.asarray(wi))
    close(g, wg, 1e-6)


def _ids(rng, m, e, kind):
    if kind == "uniform":
        return rng.integers(0, e, m).astype(np.int32)
    if kind == "skewed":  # ties everywhere, experts 3 and e-1 get no slot
        ids = np.minimum(rng.geometric(0.3, m) - 1, e - 1).astype(np.int32)
        return np.where((ids == 3) | (ids == e - 1), 0, ids).astype(np.int32)
    return np.full(m, e // 2, np.int32)  # one expert takes every slot


@pytest.mark.parametrize("impl", ["sample_sort", "xla_sort", "dense"])
@pytest.mark.parametrize("m,e,kind", [(16, 8, "uniform"), (300, 8, "skewed"),
                                      (1000, 128, "uniform"), (64, 16, "equal"),
                                      (9000, 16, "skewed")])
def test_rank_in_expert_sort(rng, impl, m, e, kind):
    ids = _ids(rng, m, e, kind)
    wr, wc = JM._rank_in_expert_sort(jnp.asarray(ids), e, impl)
    r, c = M._rank_in_expert_sort(tt(ids), e, impl)
    assert r.dtype == torch.int32 and c.dtype == torch.int32
    assert np.array_equal(r.numpy(), np.asarray(wr))
    assert np.array_equal(c.numpy(), np.asarray(wc))


@pytest.mark.parametrize("m,e,kind", [(16, 8, "uniform"), (300, 8, "skewed"),
                                      (1000, 128, "uniform"), (64, 16, "equal")])
def test_rank_in_expert_onehot(rng, m, e, kind):
    ids = _ids(rng, m, e, kind)
    wr, wc = JM._rank_in_expert_onehot(jnp.asarray(ids), e)
    r, c = M._rank_in_expert_onehot(tt(ids), e)
    assert np.array_equal(r.numpy(), np.asarray(wr))
    assert np.array_equal(c.numpy(), np.asarray(wc))
    sr, sc = M._rank_in_expert_sort(tt(ids), e, "sample_sort")
    assert torch.equal(r, sr) and torch.equal(c, sc)


def _moe_cfg(dispatch, capacity_factor=1.25, shared=0):
    return small_cfg(moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                                   n_shared_experts=shared,
                                   capacity_factor=capacity_factor,
                                   dispatch=dispatch))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("capacity_factor,shared", [(1.25, 0), (0.05, 0), (8.0, 1)])
def test_moe_apply(rng, dispatch, capacity_factor, shared):
    cfg = _moe_cfg(dispatch, capacity_factor, shared)
    p = ref_params(JM.moe_template(to_ref(cfg)), 7)
    # a router far from uniform, so that the top-k is decided
    p["router"] = rng.normal(size=p["router"].shape).astype(np.float32)
    x = rng.normal(size=(2, 40, 32)).astype(np.float32)
    if capacity_factor < 1:  # most slots dropped: cap 128 < 160 slots an expert
        assert M.capacity(cfg, 80) == 128
        x = np.repeat(x[:, :1], 40, axis=1) + 0.01 * x
    wy, waux = JM.moe_apply(p, jnp.asarray(x), to_ref(cfg))
    y, aux = M.moe_apply(to_torch_tree(p), tt(x), cfg)
    close(y, wy, 2e-5)
    close(aux, waux, 2e-5)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.05])
def test_moe_dispatches_are_bit_identical(rng, capacity_factor):
    """The three dispatches route, rank and drop alike, and the same ops
    follow: their outputs are equal bit for bit (as on the card)."""
    p = to_torch_tree(ref_params(JM.moe_template(to_ref(_moe_cfg("onehot"))), 8))
    x = tt(rng.normal(size=(3, 50, 32)).astype(np.float32))
    outs = [M.moe_apply(p, x, _moe_cfg(d, capacity_factor)) for d in DISPATCHES]
    for y, aux in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(aux, outs[0][1])


# ------------------------------------------------------- whole model
STEPS = 4


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Smoke prefill + STEPS decode steps on both sides, the same weights
    and the same tokens; logits of every step."""
    arch = request.param
    clear_degradation_log()
    port_guard.clear_degradation_log()
    cfg = configs.get_smoke(arch)
    rcfg = to_ref(cfg)
    tree = ref_params(jax_api.template(rcfg), 0)
    model = interop.params_from_jax(tree, cfg, "cpu")
    rng = np.random.default_rng(1)
    b, s = 3, 40  # 40 > attn_chunk 32: two query and key blocks, padded
    tokens = rng.integers(0, cfg.vocab, (b, s))
    steps = rng.integers(0, cfg.vocab, (STEPS, b, 1))
    cache_len = s + STEPS
    jl, jc = jax_api.prefill(tree, {"tokens": jnp.asarray(tokens, jnp.int32)}, rcfg, cache_len)
    tl, tc = api.prefill(model, {"tokens": tt(tokens)}, cfg, cache_len)
    pairs = [(tl, np.asarray(jl))]
    for i in range(STEPS):
        jl, jc = jax_api.decode_step(tree, jnp.asarray(steps[i], jnp.int32), jc,
                                     jnp.int32(s + i), rcfg)
        tl, tc = api.decode_step(model, tt(steps[i]), tc, s + i, cfg)
        pairs.append((tl, np.asarray(jl)))
    assert degradation_log() == () and port_guard.degradation_log() == ()
    return arch, pairs


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_smoke_serving_logits(served, step):
    arch, pairs = served
    got, want = pairs[step]
    cfg = configs.get_smoke(arch)
    assert got.shape == (3, cfg.padded_vocab) and got.dtype == torch.float32
    close(got, want, 1e-4)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
