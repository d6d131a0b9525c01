"""End-to-end driver on the PyTorch port: train a ~100M-param MoE LM for a
few hundred steps with the sample-sort token dispatch (K4 router, K1/K2
dispatch sort on the card), the fault-tolerant runtime, checkpoints and
synthetic data.  The counterpart of ``examples/train_moe_lm.py``.

  PYTHONPATH=src python examples/torch_train_moe_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_moe_lm.py --device cpu --steps 30 --seq 64
"""

import argparse
import math
import tempfile

import torch

from repro_torch.config import LayerSlot, ModelConfig, MoEConfig, OptimizerConfig
from repro_torch.data import SyntheticDataset
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import api, meta
from repro_torch.optim import adamw_init
from repro_torch.runtime import StragglerMonitor, TrainDriver

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# ~100M-param MoE: 8 layers, d=512, 16 experts top-2, sample-sort dispatch
model = ModelConfig(
    name="moe-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
    d_ff=1536, vocab=32000, layer_pattern=(LayerSlot("attn", "moe"),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=512,
                  dispatch="sample_sort"),
    param_dtype="float32", dtype="float32", attn_chunk=256, remat="none",
)
tpl = api.template(model)
print(f"params: {meta.count_params(tpl) / 1e6:.1f}M")
dev = resolve_device(args.device)
ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_moe_example_")
opt = OptimizerConfig(lr=1e-3, warmup_steps=max(args.steps // 15, 1), total_steps=args.steps)
train_step = build_train_step(model, opt)


def init_state():
    params = meta.init_params(tpl, torch.Generator(dev).manual_seed(0), dev)
    return (params, adamw_init(params, opt))


def step_fn(state, batch):
    params, opt_state, metrics = train_step(*state, batch)
    return (params, opt_state), metrics


ds = SyntheticDataset(model.vocab, args.seq, args.batch, seed=0)
driver = TrainDriver(
    step_fn, init_state, ds, ckpt_dir=ckpt_dir, ckpt_every=100,
    log_every=max(args.steps // 15, 1), monitor=StragglerMonitor(),
)
state, history = driver.run(args.steps)

losses = [h["loss"] for h in history]
print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
assert losses[-1] < losses[0] and math.isfinite(losses[-1])
print("OK: loss decreased; checkpoints in", ckpt_dir)
