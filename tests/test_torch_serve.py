"""The port's serving sampler and server loop against the JAX package's.

``sample_topk`` takes the top k of all rows in one ``topk_batched`` call
where the reference calls ``partial_sort.topk`` once a row (ROADMAP.md
Queue 3 D18): the rows must be bit-equal (values as raw bits, and
indices), through the reference's pure-jnp path.  The draw cannot be
compared on the same seed (``jax.random`` and torch's generators give
other numbers), so both sides get the same uniforms: the port's
inverse CDF must equal ``jax.random.choice``'s, which the first test
pins to its formula.  The server loop runs the smoke configs on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs under several workers at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import clear_degradation_log, degradation_log  # noqa: E402
from repro.core import partial_sort as jax_partial  # noqa: E402
from repro.core.sort_config import SortConfig as JaxConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import guard as port_guard  # noqa: E402
from repro_torch.core.partial_sort import topk_batched  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402

JCFG = JaxConfig(tile=4096, s=64, direct_max=8192, impl="xla")
ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]


@pytest.fixture(autouse=True)
def _no_degradation():
    clear_degradation_log()
    port_guard.clear_degradation_log()
    yield
    assert degradation_log() == ()
    assert port_guard.degradation_log() == ()


def logits_rows(rng, b, v, dtype):
    x = rng.normal(size=(b, v)).astype(np.float32) * 4
    x[:, -7:] = -1e9  # the unembed's masked pad columns
    t = torch.from_numpy(x).to(getattr(torch, dtype))  # bfloat16: many ties
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def reference_formula(p, u):
    """jax.random.choice(key, k, p=p)'s draw on the uniform u it takes."""
    p_cuml = jnp.cumsum(p)
    return jnp.searchsorted(p_cuml, p_cuml[-1] * (1 - u))


@pytest.mark.parametrize("seed", range(4))
def test_reference_formula_is_jax_random_choice(rng, seed):
    p = jax.nn.softmax(jnp.asarray(rng.normal(size=8).astype(np.float32)))
    for i in range(16):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        u = jax.random.uniform(key, (), dtype=jnp.float32)
        assert int(jax.random.choice(key, 8, p=p)) == int(reference_formula(p, u))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,v,k", [(4, 512, 8), (3, 9000, 8), (2, 20000, 50),
                                   (5, 300, 1), (2, 4096, 64),
                                   (2, 152064, 8)])  # the Qwen3 padded vocab
def test_batched_top_k_equals_the_reference_per_row(rng, dtype, b, v, k):
    t, j = logits_rows(rng, b, v, dtype)
    vals, idx = topk_batched(t, k, serve.sampler_config(), device="cpu")
    for r in range(b):
        wv, wi = jax_partial.topk(j[r], k, JCFG)
        assert np.array_equal(bits(vals[r]), jbits(wv))
        assert np.array_equal(idx[r].numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [2, 8, 50])
def test_inverse_cdf_choice_equals_the_reference(rng, k):
    p = np.array(jax.nn.softmax(jnp.asarray(rng.normal(size=(64, k)).astype(np.float32)), -1))
    u = rng.random(64).astype(np.float32)
    u[:4] = [0.0, np.float32(1 - 2**-24), 0.5, 1e-8]  # both ends of [0, 1)
    got = serve.choice_from_uniform(torch.from_numpy(p), torch.from_numpy(u))
    want = [int(reference_formula(jnp.asarray(p[i]), jnp.float32(u[i]))) for i in range(64)]
    assert got.tolist() == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [0.8, 1.5])
def test_sample_topk_draws_the_reference_token(rng, dtype, temperature):
    """sample_topk == the reference's per-row steps (its top-k, softmax
    at the temperature, the choice) on the uniforms it drew."""
    b, v, k = 6, 9000, 8
    t, j = logits_rows(rng, b, v, dtype)
    gen = torch.Generator().manual_seed(5)
    u = torch.rand(b, generator=torch.Generator().manual_seed(5)).numpy()
    got = serve.sample_topk(t, k, temperature, gen, check="full")
    assert got.dtype == torch.int32
    for r in range(b):
        wv, wi = jax_partial.topk(j[r], k, JCFG)
        p = jax.nn.softmax(wv.astype(jnp.float32) / temperature)
        assert int(got[r]) == int(wi[reference_formula(p, jnp.float32(u[r]))])


@pytest.mark.parametrize("k,temperature", [(1, 0.8), (8, 0.0), (0, 1.0), (8, -1.0)])
def test_greedy_is_argmax(rng, k, temperature):
    t, j = logits_rows(rng, 5, 700, "bfloat16")  # ties: the first index wins
    t[0, 3] = t[0, 9] = t[0].max() + 1
    got = serve.sample_topk(t, k, temperature, torch.Generator())
    want = np.asarray(jnp.argmax(j.at[0, 3].set(t[0, 3].item()).at[0, 9].set(t[0, 9].item()), -1))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert int(got[0]) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_four_requests_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--gen", "5"])
    cfg = configs.get_smoke(arch)
    assert gen.shape == (4, 5)
    assert ((gen >= 0) & (gen < cfg.padded_vocab)).all()
    assert "4 requests served" in capsys.readouterr().out


def test_generate_is_deterministic_and_checked():
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    model = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(serve.prompts(cfg, 3, 20))
    runs = [serve.generate(model, tokens, cfg, gen=4, topk=8, temperature=0.8,
                           generator=torch.Generator().manual_seed(1), check=check)
            for check in ("off", "full")]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].prefill_logits, runs[1].prefill_logits)
    assert runs[0].tokens.shape == (3, 4)
    assert bool(torch.isfinite(runs[0].prefill_logits[:, :cfg.vocab]).all())


def test_prompts_are_the_references():
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    want = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    assert np.array_equal(serve.prompts(cfg, 4, 32), want)


def test_serve_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke"])


def _chip_smoke():
    """chip_smoke.py, loaded from the repository root."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dispatch", ["sample_sort", "xla_sort", "onehot"])
def test_serve_launches_on_the_cpu_equal_chip_smokes_count(monkeypatch, dispatch):
    """A CPU rehearsal of the serving phase's launch counts: each call of
    a kernel dispatcher is one launch on the card, and a serve must make
    the launches ``chip_smoke.serving_launches`` holds the card to.  The
    prefill's 9,600 ids pass the dispatch sort's direct_max (a bucket
    round: K1, K2), the 9,216-column padded vocab the sampler's (K1, K3);
    the router is K4 (``kernels.topk.topk_desc``), every row contiguous."""
    import collections
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.kernels import topk as topk_kernel

    calls = collections.Counter()

    def spy(owner, name, kernel):
        real = getattr(owner, name)

        def call(*args, **kw):
            tensors = [t for a in args[:2] for t in (a if isinstance(a, tuple) else (a,))
                       if isinstance(t, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), name
            calls[kernel] += 1
            return real(*args, **kw)
        monkeypatch.setattr(owner, name, call)

    spy(ops, "sort_tiles", "tile_sort")
    spy(ops, "sort_tiles_sample", "tile_sort")
    spy(ops, "splitter_partition", "splitter_partition")
    spy(ops, "splitter_ranks", "splitter_ranks")
    spy(topk_kernel, "topk_desc", "topk")
    smoke = configs.get_smoke("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        smoke, n_layers=2, vocab=9000, attn_chunk=256,
        moe=dataclasses.replace(smoke.moe, n_experts=16, top_k=8, dispatch=dispatch))
    model = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(serve.prompts(cfg, 2, 600))
    out = serve.generate(model, tokens, cfg, gen=3, topk=8, temperature=0.8,
                         generator=torch.Generator().manual_seed(1))
    assert out.tokens.shape == (2, 3)
    want = _chip_smoke().serving_launches(cfg, 2, 600, 3, 8)
    assert dict(calls) == want
    if dispatch == "sample_sort":
        assert want["splitter_partition"] == 2 and want["topk"] == 2 * 3


def test_dispatch_and_sampler_take_the_guarded_path():
    """The dispatch argsort and the sampler's top-k run through the sort's
    guarded funnel: a failed launch on the CPU is logged and degrades to
    another rung (on the card it is retried, then raised), and the result
    is the clean one."""
    import warnings

    from repro_torch.core import faults
    from repro_torch.models import moe

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 16, 9000).astype(np.int32))
    logits = torch.from_numpy(rng.normal(size=(3, 9000)).astype(np.float32))
    clean = (moe._rank_in_expert_sort(ids, 16, "sample_sort"),
             serve.sample_topk(logits, 8, 0.8, torch.Generator().manual_seed(2)))
    for fn, want in ((lambda: moe._rank_in_expert_sort(ids, 16, "sample_sort"), clean[0]),
                     (lambda: serve.sample_topk(logits, 8, 0.8,
                                                torch.Generator().manual_seed(2)), clean[1])):
        port_guard.clear_degradation_log()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", port_guard.DegradationWarning)
            with faults.inject("kernel.launch", on_hit=1) as rule:
                got = fn()
        assert rule.fired == 1 and len(port_guard.degradation_log()) >= 1
        assert all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
    port_guard.clear_degradation_log()
