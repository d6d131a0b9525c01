"""Decoder-only LM for serving: attention with MoE or dense ffns.

The reference stacks its layers per period and scans over them; the
port keeps the stacked template (:func:`lm_template`, the one source of
shapes) and runs a Python loop over :class:`DecoderLayer` modules whose
parameters are period slices of it: ``layers[j].moe.wg`` is the
reference's ``period/slot{j % P}/moe/wg[j // P]`` for a pattern of P
slots.  Serving only (``prefill``, ``decode_step``, under
``torch.inference_mode``); MLA and Mamba-2 slots and training
(``lm_forward``, ``lm_loss``, ``chunked_ce``) wait for ROADMAP.md
Queue 1 item 12.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import LayerSlot, ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.meta import ParamMeta, tree_map_meta, torch_dtype

_ITEM_12 = "ROADMAP.md Queue 1 item 12"


def _check_slot(slot: LayerSlot) -> None:
    if slot.mixer in ("mla", "mamba"):
        raise NotImplementedError(
            f"the {slot.mixer!r} mixer is not ported yet ({_ITEM_12})")


# ----------------------------------------------------------- templates
def _slot_template(cfg: ModelConfig, slot: LayerSlot):
    _check_slot(slot)
    t = {}
    if slot.mixer == "attn":
        t["ln"] = L.norm_template(cfg)
        t["attn"] = attn.gqa_template(cfg)
    if slot.ffn != "none":
        t["ln2"] = L.norm_template(cfg)
    if slot.ffn == "dense":
        t["mlp"] = L.mlp_template(cfg)
    elif slot.ffn == "moe":
        t["moe"] = moe.moe_template(cfg)
    return t


def _stack_period(template, n_periods: int):
    return tree_map_meta(
        lambda m: ParamMeta(
            (n_periods,) + m.shape, ("layers",) + m.axes, m.dtype, m.init, m.scale
        ),
        template,
    )


def lm_template(cfg: ModelConfig):
    period = {
        f"slot{i}": _slot_template(cfg, s) for i, s in enumerate(cfg.layer_pattern)
    }
    return {
        "embed": L.embed_template(cfg),
        "period": _stack_period(period, cfg.n_periods),
        "final_norm": L.norm_template(cfg),
    }


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]  # a view: the layer shares the stacked tensor


# ------------------------------------------------------------- modules
class DecoderLayer(nn.Module):
    """One slot of one period: ``ln``, ``attn`` (GQA), ``ln2`` and
    ``mlp`` or ``moe``, named as the slot template's keys."""

    def __init__(self, cfg: ModelConfig, slot: LayerSlot, tensors: dict):
        super().__init__()
        self.slot = slot
        tpl = _slot_template(cfg, slot)
        kinds = {"ln": L.Norm, "attn": attn.GQAttention, "ln2": L.Norm,
                 "mlp": L.MLP, "moe": moe.MoE}
        for name, t in tpl.items():
            self.add_module(name, kinds[name](t, tensors[name]))

    def prefill(self, x, cfg: ModelConfig, positions, cache_len: int):
        cache = {}
        if self.slot.mixer == "attn":
            y, cache = self.attn.prefill(self.ln(x, cfg), cfg, positions, cache_len)
            x = x + y
        return self._ffn(x, cfg), cache

    def decode(self, x, cfg: ModelConfig, cache, pos: int):
        if self.slot.mixer == "attn":
            y, cache = self.attn.decode(self.ln(x, cfg), cfg, cache, pos)
            x = x + y
        return self._ffn(x, cfg), cache

    def _ffn(self, x, cfg: ModelConfig):
        if self.slot.ffn == "dense":
            x = x + self.mlp(self.ln2(x, cfg), cfg)
        elif self.slot.ffn == "moe":
            y, _ = self.moe(self.ln2(x, cfg), cfg)
            x = x + y
        return x


class CausalLM(nn.Module):
    """``embed``, ``layers`` (a ModuleList of :class:`DecoderLayer`) and
    ``final_norm``, from a parameter tree shaped as :func:`lm_template`
    (the layers take views of its period slices)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        pat = cfg.layer_pattern
        for slot in pat:
            _check_slot(slot)
        self.embed = L.Embed(L.embed_template(cfg), params["embed"])
        layers = []
        for j in range(cfg.n_layers):
            period, i = divmod(j, len(pat))
            t = _index_tree(params["period"][f"slot{i}"], period)
            layers.append(DecoderLayer(cfg, pat[i], t))
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.Norm(L.norm_template(cfg), params["final_norm"])


# ------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zero KV caches on ``device`` (None = "cuda", raising without CUDA),
    one dict a layer (``k`` and ``v`` of (B, L, K, Dh) for an attention
    slot, empty otherwise)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    caches = []
    for j in range(cfg.n_layers):
        slot = cfg.layer_pattern[j % len(cfg.layer_pattern)]
        _check_slot(slot)
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.dh)
        caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
                      if slot.mixer == "attn" else {})
    return caches


@torch.inference_mode()
def prefill(model: CausalLM, tokens, cfg: ModelConfig, cache_len: int):
    """tokens (B,S) -> (last-position logits (B,V), caches for decode)."""
    x = model.embed(tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for layer in model.layers:
        x, cache = layer.prefill(x, cfg, positions, cache_len)
        caches.append(cache)
    # The norm is per position: normalizing the last alone is the same.
    x = model.final_norm(x[:, -1:, :], cfg)
    return model.embed.logits(x, cfg)[:, 0, :], caches


@torch.inference_mode()
def decode_step(model: CausalLM, token, caches, pos: int, cfg: ModelConfig):
    """token (B,1) int; ``pos`` the position it takes -> (logits (B,V),
    the caches, written in place)."""
    x = model.embed(token, cfg)
    for layer, cache in zip(model.layers, caches):
        x, _ = layer.decode(x, cfg, cache, pos)
    x = model.final_norm(x, cfg)
    return model.embed.logits(x, cfg)[:, 0, :], caches


def _training(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} (training) is not ported yet ({_ITEM_12})")
    fn.__name__ = name
    return fn


lm_forward = _training("lm_forward")
lm_loss = _training("lm_loss")
chunked_ce = _training("chunked_ce")
