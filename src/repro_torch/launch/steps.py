"""Step builders: the train, prefill and decode steps of one device.

The reference's ``launch/steps.py`` builds sharded steps for a ``Plan``
(arch x shape x mesh) and lowers them for the dry run.  The port's
models run on one device (ROADMAP.md Queue 3 D19): its builders take
the model config, and :func:`make_plan`, :func:`param_shardings` and
:func:`lower_cell` raise ``NotImplementedError`` naming ROADMAP.md
Queue 1 item 12e.

:func:`build_train_step` keeps the train state as the reference's trees
(``params``: the stacked parameter tensors, shaped as
``api.template(cfg)``; ``opt_state``: ``adamw_init``'s), so the
checkpoint holds the reference's keys.  It runs them through a
``CausalLM`` whose per-layer parameters view ``params`` and whose
gradients land in views of one stacked gradient tree
(``models/meta.py``), and updates ``params`` and ``opt_state`` in place.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.models.transformer import CausalLM
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_warmup
from repro_torch.tree import get, leaves, map_tree

_ITEM_12E = "ROADMAP.md Queue 1 item 12e"


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: the mesh, the shardings and the lowering are not ported yet "
        f"({_ITEM_12E}); the port's steps run on one device")


def make_plan(*args, **kwargs):
    """The reference's (arch x shape x mesh) plan."""
    _not_ported("make_plan")


def param_shardings(*args, **kwargs):
    _not_ported("param_shardings")


def lower_cell(*args, **kwargs):
    _not_ported("lower_cell")


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV length: the sequence plus the VLM stub's prefix rows."""
    extra = cfg.frontend_len if (cfg.frontend != "none" and not cfg.n_encoder_layers) else 0
    return shape.seq_len + extra


def build_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                     parallel: ParallelConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm", "lr"})``: the loss and its gradients (``api.loss_fn``
    under autograd; with ``parallel.grad_accum`` > 1 a loop over that
    many microbatches whose float32 gradients are summed, then averaged),
    the global-norm clip, the cosine-warmup rate at ``opt_state["step"]``
    and an AdamW update of ``params`` and ``opt_state`` in place.
    ``batch`` holds arrays or tensors; they go to the parameters' device.
    """
    accum = (parallel or ParallelConfig()).grad_accum
    held = {}

    def bind(params):
        """The trainable model over ``params`` and its stacked gradient
        tree, kept while the same ``params`` comes back."""
        if held.get("params") is not params:
            held.clear()
            model = CausalLM(cfg, params).requires_grad_(True)
            grads = map_tree(torch.zeros_like, params)
            for path, period, p in model.param_slices():
                g = get(grads, path)
                p.grad = g if period is None else g[period]
            held.update(params=params, model=model, grads=grads)
        return held["model"], held["grads"]

    def loss_and_grads(model, grads, batch):
        for _, g in leaves(grads):
            g.zero_()
        loss = api.loss_fn(model, batch, cfg)
        loss.backward()  # into the bound gradient tree, in place
        return loss.detach()

    def train_step(params, opt_state, batch):
        model, grads = bind(params)
        dev = leaves(params)[0][1].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if accum > 1:
            gsum = map_tree(
                lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
            losses = []
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                losses.append(loss_and_grads(model, grads, mb))
                for (_, s), (_, g) in zip(leaves(gsum), leaves(grads)):
                    s.add_(g)
            for _, s in leaves(gsum):
                s.div_(accum)
            step_grads, loss = gsum, torch.stack(losses).mean()
        else:
            step_grads, loss = grads, loss_and_grads(model, grads, batch)
        scale, gnorm = clip_by_global_norm(step_grads, opt.grad_clip)
        lr = cosine_warmup(int(opt_state["step"]), opt.lr, opt.warmup_steps,
                           opt.total_steps)
        adamw_update(params, step_grads, opt_state, opt, lr, grad_scale=scale)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    clen = cache_len_for(cfg, shape)

    def prefill_step(model, batch):
        return api.prefill(model, batch, cfg, cache_len=clen)

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def serve_step(model, token, caches, pos):
        return api.decode_step(model, token, caches, pos, cfg)

    return serve_step
