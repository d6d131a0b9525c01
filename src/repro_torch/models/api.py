"""Model API of the port: template, init, loss, prefill, decode for a config.

The decoder-only LM is ported (``transformer.py``), for training
(:func:`loss_fn`) and serving (:func:`prefill`, :func:`decode_step`);
an encoder-decoder config and a frontend's prefix embeddings raise
``NotImplementedError`` naming ROADMAP.md Queue 1 item 12d.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import meta, transformer
from repro_torch.models.transformer import CausalLM


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.n_encoder_layers > 0


def _decoder_only(cfg: ModelConfig) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet "
            "(ROADMAP.md Queue 1 item 12d)")


def _no_prefix(batch: dict) -> None:
    if batch.get("prefix_embeds") is not None:
        raise NotImplementedError(
            "prefix embeddings (frontends) are not ported yet "
            "(ROADMAP.md Queue 1 item 12d)")


def template(cfg: ModelConfig):
    _decoder_only(cfg)
    return transformer.lm_template(cfg)


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None) -> CausalLM:
    """A model with random weights drawn on ``device`` (None = "cuda",
    raising without CUDA) from ``generator``, which lives there
    (``meta.init_params``: never a float32 copy of the model, never the
    host)."""
    return CausalLM(cfg, meta.init_params(template(cfg), generator, device))


def loss_fn(model: CausalLM, batch: dict, cfg: ModelConfig):
    """batch {"tokens", "targets": (B,S)} -> the scalar training loss
    (``transformer.lm_loss``), differentiable in the model's parameters."""
    _decoder_only(cfg)
    _no_prefix(batch)
    return transformer.lm_loss(model, batch, cfg)


def prefill(model: CausalLM, batch: dict, cfg: ModelConfig, cache_len: int):
    """batch {"tokens": (B,S)} -> (last-position logits (B,V), caches)."""
    _decoder_only(cfg)
    _no_prefix(batch)
    return transformer.prefill(model, batch["tokens"], cfg, cache_len)


def decode_step(model: CausalLM, token, caches, pos: int, cfg: ModelConfig):
    _decoder_only(cfg)
    return transformer.decode_step(model, token, caches, pos, cfg)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, cache_len, device)


def make_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The batch a train or prefill step takes, as tensors on the "meta"
    device (shapes and dtypes, no storage): the reference's
    ShapeDtypeStruct batch, stub frontends' inputs included."""
    def shape(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    b = {"tokens": shape(batch, seq), "targets": shape(batch, seq)}
    if is_encdec(cfg):
        b["enc_frames"] = shape(batch, cfg.encoder_positions, cfg.d_model,
                                dtype=meta.torch_dtype(cfg.dtype))
        b["targets"] = b.pop("targets")  # after the frames, as the reference orders them
    elif cfg.frontend != "none" and cfg.frontend_len:
        b["prefix_embeds"] = shape(batch, cfg.frontend_len, cfg.d_model,
                                   dtype=meta.torch_dtype(cfg.dtype))
    return b
