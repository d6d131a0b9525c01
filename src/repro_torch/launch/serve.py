"""Serving launcher: batched prefill + decode with sort-based sampling.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu

A minimal batched server loop: the requests are packed into one batch,
prefilled once, then decoded token by token.  The sampler takes the top
k of every row's logits with the deterministic partial sample sort, one
``topk_batched`` call for the whole batch (ROADMAP.md Queue 3 D18), and
draws from them by the inverse CDF that ``jax.random.choice`` uses, on
uniforms from an explicit ``torch.Generator``.  The weights are random,
drawn on the device from ``--seed``; the prompts are
``default_rng(0)`` tokens, as the reference makes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.partial_sort import topk_batched
from repro_torch.core.sort_config import SortConfig


def sampler_config(check: str = "off") -> SortConfig:
    """The sampler's sort geometry: the reference's tile, s and
    direct_max.  The reference pins its sampler to the jnp stand-ins
    (``impl="xla"``); the port's goes through the kernels (K1, K3) on
    the card."""
    return SortConfig(tile=4096, s=64, direct_max=8192, check=check)


def choice_from_uniform(p, u):
    """Index drawn from each row's weights ``p`` (B, k) by the inverse
    CDF of ``jax.random.choice``: the first i with cumsum(p)[i] >=
    cumsum(p)[-1] * (1 - u), for u (B,) uniform in [0, 1)."""
    cum = torch.cumsum(p, dim=-1)
    r = cum[:, -1:] * (1 - u[:, None])
    return torch.searchsorted(cum, r)[:, 0]


def sample_topk(logits, k: int, temperature: float, generator: torch.Generator,
                check: str = "off"):
    """One token id per row of (B, V) logits: top-k sampling at
    ``temperature``, or the argmax for ``k <= 1`` or ``temperature <= 0``.

    ``check`` ('off'|'bounds'|'full') turns on the sort's runtime
    invariants for the top-k.  ``generator`` lives on the logits' device.
    """
    if k <= 1 or temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = topk_batched(logits, k, sampler_config(check), device=logits.device)
    p = torch.softmax(vals.float() / temperature, dim=-1)
    u = torch.rand(p.shape[0], generator=generator, device=p.device)
    choice = choice_from_uniform(p, u)
    return idx.gather(1, choice[:, None])[:, 0].to(torch.int32)


@dataclasses.dataclass
class Served:
    """What :func:`generate` returns: the tokens (B, gen) int32, the
    prefill's last-position logits, and host-clock times that end in a
    device synchronize."""

    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, tokens, cfg, *, gen: int, topk: int, temperature: float,
             generator: torch.Generator, check: str = "off") -> Served:
    """Prefill ``tokens`` (B, S), sample ``gen`` tokens (``gen - 1``
    decode steps) with :func:`sample_topk`."""
    from repro_torch.models import api

    b, s = tokens.shape
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = api.prefill(model, {"tokens": tokens}, cfg, s + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = sample_topk(logits, topk, temperature, generator, check)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = api.decode_step(model, tok, caches, s + i, cfg)
        tok = sample_topk(logits, topk, temperature, generator, check)[:, None]
        out.append(tok)
    _sync(dev)
    return Served(torch.cat(out, dim=1), prefill_logits, prefill_s,
                  time.perf_counter() - t0)


def prompts(cfg, requests: int, prompt_len: int) -> np.ndarray:
    """The reference's prompts: ``default_rng(0)`` token ids."""
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (requests, prompt_len))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--check", choices=["off", "bounds", "full"],
                    default="off",
                    help="runtime sort invariants for the sampler: "
                         "'bounds' verifies the capacity bound, 'full' "
                         "adds permutation and order checks")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the sampler's uniforms")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import api, meta

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch).model)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = api.init_model(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    _sync(dev)
    print(f"[serve] {cfg.name}: {meta.count_params(api.template(cfg)) / 1e6:.1f}M "
          f"params on {dev}, init {time.perf_counter() - t0:.2f} s")

    b, s = args.requests, args.prompt_len
    tokens = torch.from_numpy(prompts(cfg, b, s)).to(dev)
    out = generate(model, tokens, cfg, gen=args.gen, topk=args.topk,
                   temperature=args.temperature,
                   generator=torch.Generator(dev).manual_seed(args.seed + 1),
                   check=args.check)
    gen = out.tokens.cpu().numpy()
    if not ((gen >= 0) & (gen < cfg.padded_vocab)).all():
        raise RuntimeError("a sampled token id is outside the padded vocab")
    steps = max(args.gen - 1, 1)
    print(f"[serve] prefill {b}x{s}: {out.prefill_s * 1e3:.1f} ms; "
          f"decode {args.gen - 1} steps: {out.decode_s * 1e3 / steps:.1f} ms/tok")
    print(f"[serve] {b} requests served; sample generations (token ids):\n{gen[:, :12]}")
    return gen


if __name__ == "__main__":
    main()
