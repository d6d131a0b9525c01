"""Grouped-query attention: chunked (online softmax) prefill and decode.

The reference computes attention with plain array ops and no Pallas
kernel, so the port does too, op for op: ``chunked_attention`` walks
query and key blocks of ``cfg.attn_chunk`` with float32 running max and
denominator, the scores and the value sums in float32 (the reference's
``preferred_element_type``), the softmax weights cast to the values'
dtype first.  No fused attention operator is called, so the arithmetic
stays the reference's.  ``gqa_forward`` is the training attention (no
cache); its backward runs through autograd.  MLA and cross-attention
wait for ROADMAP.md Queue 1 item 12d.

The KV cache of a layer is a dict of (B, L, K, Dh) tensors; decode
writes the new position in place, which equals the reference's
functional ``dynamic_update_slice``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.meta import ParamMeta, ParamModule, torch_dtype


def gqa_template(cfg: ModelConfig):
    d, h, k, dh, pd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.param_dtype
    t = {
        "wq": ParamMeta((d, h, dh), ("embed", "heads", "head_dim"), pd),
        "wk": ParamMeta((d, k, dh), ("embed", "kv_heads", "head_dim"), pd),
        "wv": ParamMeta((d, k, dh), ("embed", "kv_heads", "head_dim"), pd),
        "wo": ParamMeta((h, dh, d), ("heads", "head_dim", "embed"), pd),
    }
    if cfg.attn_bias:
        t["bq"] = ParamMeta((h, dh), ("heads", "head_dim"), pd, "zeros")
        t["bk"] = ParamMeta((k, dh), ("kv_heads", "head_dim"), pd, "zeros")
        t["bv"] = ParamMeta((k, dh), ("kv_heads", "head_dim"), pd, "zeros")
    return t


def _qkv(p, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _out(p, o, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(dt), p["wo"].to(dt))


def _pad_seq(x, length: int):
    return F.pad(x, (0, 0, 0, 0, 0, length - x.shape[1])) if length > x.shape[1] else x


def chunked_attention(q, k, v, *, chunk: int, causal: bool, q_offset: int = 0):
    """Online-softmax attention.  q: (B,Sq,H,D); k,v: (B,Sk,K,D), H=K*G.

    Both sequence dims are padded to chunk multiples; padded keys are
    masked, padded query rows sliced off.  Scores of one (query block,
    key block) pair, (B,K,G,cq,ck) float32, are the largest buffer.
    """
    b, sq0, h, d = q.shape
    sk0, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    cq, ck = min(chunk, sq0), min(chunk, sk0)
    sq, sk = -(-sq0 // cq) * cq, -(-sk0 // ck) * ck
    q, k, v = _pad_seq(q, sq), _pad_seq(k, sk), _pad_seq(v, sk)
    nq, nk = sq // cq, sk // ck
    scale = d ** -0.5
    dev = q.device

    qb = q.reshape(b, nq, cq, kh, g, d)
    kb = k.reshape(b, nk, ck, kh, d)
    vb = v.reshape(b, nk, ck, kh, dv)
    outs = []
    for qi in range(nq):
        qc = qb[:, qi].float()  # (B, cq, K, G, D)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, kh, g, cq), -torch.inf, device=dev)
        l = torch.zeros((b, kh, g, cq), device=dev)
        acc = torch.zeros((b, kh, g, cq, dv), device=dev)
        for kj in range(nk):
            kc, vc = kb[:, kj], vb[:, kj]
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc.float())
            # In place when serving; under autograd the product is left
            # as it is, since remat="dots" keeps it for the backward.
            s = s * scale if torch.is_grad_enabled() else s.mul_(scale)
            kpos = kj * ck + torch.arange(ck, device=dev)
            mask = (kpos < sk0)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s.masked_fill_(~mask, -torch.inf)
            # The running max carries no gradient: the output does not
            # depend on it (exactly; the reference differentiates
            # through it and gets the same gradient up to rounding).
            # Detached, s is saved by no op, so the in-place steps below
            # hold under autograd, and only p is kept for the backward.
            m_new = torch.maximum(m, s.detach().amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()  # in place: s is not read again
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
            del s, p, pv
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,K,G,cq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, dv))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out[:, :sq0].to(q.dtype)


def gqa_forward(p, x, cfg: ModelConfig, positions, causal: bool = True):
    """Full-sequence self-attention (training)."""
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _out(p, chunked_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal), cfg)


def gqa_prefill(p, x, cfg: ModelConfig, positions, cache_len: int):
    """Causal forward that also returns the layer's KV cache, (B, L, K,
    Dh) zeros past the prompt."""
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _out(p, chunked_attention(q, k, v, chunk=cfg.attn_chunk, causal=True), cfg)
    cache = {"k": _pad_seq(k, cache_len), "v": _pad_seq(v, cache_len)}
    return out, cache


def gqa_decode(p, x, cfg: ModelConfig, cache, pos: int):
    """One-token decode.  x: (B,1,d); cache k/v: (B,L,K,Dh), written in
    place at ``pos``; attends to positions 0..pos."""
    q, k, v = _qkv(p, x, cfg)
    positions = torch.tensor([pos], device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    b, l, kh, dh = ck.shape
    g = q.shape[2] // kh
    qg = q.reshape(b, 1, kh, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), ck.float()) * (dh ** -0.5)
    mask = torch.arange(l, device=x.device) <= pos
    s = s.masked_fill(~mask, -torch.inf)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", w.to(cv.dtype).float(), cv.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, kh * g, dh)
    return _out(p, o, cfg), cache


class GQAttention(ParamModule):
    """The attention mixer of a layer: parameters ``wq wk wv wo`` (and
    ``bq bk bv`` with ``cfg.attn_bias``) from :func:`gqa_template`."""

    def forward(self, x, cfg: ModelConfig, positions):
        return gqa_forward(self, x, cfg, positions)

    def prefill(self, x, cfg: ModelConfig, positions, cache_len: int):
        return gqa_prefill(self, x, cfg, positions, cache_len)

    def decode(self, x, cfg: ModelConfig, cache, pos: int):
        return gqa_decode(self, x, cfg, cache, pos)
