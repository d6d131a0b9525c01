"""Training launcher: real steps on one device.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu --steps 4 --batch 2 --seq 32

The reference's CLI, flag for flag, plus ``--device`` ("cuda", the
kernels, or "cpu", their plain versions) and ``--seed`` (the weights,
drawn on the device; the data is ``SyntheticDataset(seed=0)`` as the
reference's).  ``--smoke`` takes the reduced config; without it the
full config, at its published widths.  Fault tolerance is the
runtime's: auto-resume from the newest checkpoint in ``--ckpt-dir``
(a new temporary directory when not given), async saves, straggler
logging.  ``--mesh`` other than 1x1 waits for ROADMAP.md Queue 1 item
12e.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resumes from the newest checkpoint here "
                         "(default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None, help="only 1x1: one device")
    ap.add_argument("--dispatch", default=None)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    ap.add_argument("--seed", type=int, default=0, help="seeds the weights")
    args = ap.parse_args(argv)

    if args.mesh is not None and math.prod(int(x) for x in args.mesh.split("x")) != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes wait "
            "for ROADMAP.md Queue 1 item 12e")

    from repro_torch import configs
    from repro_torch.config import OptimizerConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api, meta
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import StragglerMonitor, TrainDriver

    arch = configs.get_config(args.arch)
    model = configs.get_smoke(args.arch) if args.smoke else arch.model
    if args.dispatch and model.moe is not None:
        model = dataclasses.replace(
            model, moe=dataclasses.replace(model.moe, dispatch=args.dispatch))
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1),
                          moment_dtype=arch.moment_dtype)

    tpl = api.template(model)
    print(f"[train] {model.name}: {meta.count_params(tpl) / 1e6:.1f}M params, "
          f"mesh (1, 1) on {dev}, batch {args.batch} x seq {args.seq}, "
          f"checkpoints in {ckpt_dir}")
    train_step = build_train_step(model, opt)

    def step_fn(state, batch):
        params, opt_state, metrics = train_step(*state, batch)
        return (params, opt_state), metrics

    def init_state():
        params = meta.init_params(tpl, torch.Generator(dev).manual_seed(args.seed), dev)
        return (params, adamw_init(params, opt))

    ds = SyntheticDataset(model.vocab, args.seq, args.batch, seed=0)
    driver = TrainDriver(
        step_fn, init_state, ds,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1),
        monitor=StragglerMonitor(heartbeat_path=ckpt_dir + "/heartbeat.json"),
    )
    _, history = driver.run(args.steps)
    if not history:
        raise SystemExit(f"[train] the checkpoint in {ckpt_dir} is at or past "
                         f"--steps {args.steps}: nothing to run")
    losses = [h["loss"] for h in history]
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"[train] the last loss is {losses[-1]}")
    return history


if __name__ == "__main__":
    main()
