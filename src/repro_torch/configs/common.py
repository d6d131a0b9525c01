"""Shared helpers for architecture configs."""

from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")

SKIP_FULL_ATTN = (
    "long_500k skipped: pure full-attention architecture (O(S) KV per "
    "decode step is fine, but the long cell is reserved for "
    "sub-quadratic archs)."
)


def smoke_shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config: tiny dims, 1-2 periods, small vocab,
    float32 parameters and activations."""
    pat = cfg.layer_pattern
    base = dict(
        n_layers=2 * len(pat) if len(pat) == 1 else len(pat),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab=512,
        head_dim=0,
        param_dtype="float32",
        dtype="float32",
        attn_chunk=32,
        remat="none",
        frontend_len=8 if cfg.frontend != "none" else 0,
        encoder_positions=16 if cfg.n_encoder_layers else cfg.encoder_positions,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
    )
    if cfg.mla is not None:
        base["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64
        )
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16
        )
    base.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
