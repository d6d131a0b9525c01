"""Shared layers: norms, the SwiGLU/GELU MLP, embeddings, RoPE.

The reference's functions on tensors, with its casts: each takes its
parameters as a dict or a :class:`~repro_torch.models.meta.ParamModule`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.meta import ParamMeta, ParamModule, torch_dtype


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------- norms
def norm_template(cfg: ModelConfig):
    d = cfg.d_model
    t = {"w": ParamMeta((d,), ("embed",), cfg.param_dtype, "ones")}
    if cfg.norm == "layernorm":
        t["b"] = ParamMeta((d,), ("embed",), cfg.param_dtype, "zeros")
    return t


def norm_apply(p, x, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["w"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["w"].float() + p["b"].float()
    return out.to(_dt(cfg))


class Norm(ParamModule):
    def forward(self, x, cfg: ModelConfig):
        return norm_apply(self, x, cfg)


# ---------------------------------------------------------------- MLP
def mlp_template(cfg: ModelConfig, d_ff: int | None = None):
    d, ff, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.activation == "swiglu":
        return {
            "wg": ParamMeta((d, ff), ("embed", "mlp"), pd),
            "wu": ParamMeta((d, ff), ("embed", "mlp"), pd),
            "wd": ParamMeta((ff, d), ("mlp", "embed"), pd),
        }
    return {
        "w1": ParamMeta((d, ff), ("embed", "mlp"), pd),
        "b1": ParamMeta((ff,), ("mlp",), pd, "zeros"),
        "w2": ParamMeta((ff, d), ("mlp", "embed"), pd),
        "b2": ParamMeta((d,), ("embed",), pd, "zeros"),
    }


def mlp_apply(p, x, cfg: ModelConfig):
    dt = _dt(cfg)
    x = x.to(dt)
    if cfg.activation == "swiglu":
        g = x @ p["wg"].to(dt)
        u = x @ p["wu"].to(dt)
        return (F.silu(g) * u) @ p["wd"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


class MLP(ParamModule):
    def forward(self, x, cfg: ModelConfig):
        return mlp_apply(self, x, cfg)


# ---------------------------------------------------------------- embed
def embed_template(cfg: ModelConfig):
    v = cfg.padded_vocab
    t = {
        "tok": ParamMeta(
            (v, cfg.d_model), ("vocab", "embed"), cfg.param_dtype, "small"
        )
    }
    if not cfg.tie_embeddings:
        t["unembed"] = ParamMeta(
            (cfg.d_model, v), ("embed", "vocab"), cfg.param_dtype
        )
    return t


def embed_apply(p, tokens, cfg: ModelConfig):
    return p["tok"].to(_dt(cfg))[tokens.long()]


def unembed_apply(p, x, cfg: ModelConfig):
    """Logits over the PADDED vocab; pad columns masked to -1e9."""
    dt = _dt(cfg)
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = x.to(dt) @ w.to(dt)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e9
    return logits


class Embed(ParamModule):
    def forward(self, tokens, cfg: ModelConfig):
        return embed_apply(self, tokens, cfg)

    def logits(self, x, cfg: ModelConfig):
        return unembed_apply(self, x, cfg)


# ---------------------------------------------------------------- RoPE
def rope_angles(positions, dh: int, theta: float):
    """positions (...,) int -> (..., dh/2) float32 angles."""
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=positions.device) / dh
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
