"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant Trainer (checkpoint/restart, straggler watchdog)
on one CUDA card; ``--smoke --device cpu`` trains the reduced config on
the CPU through the plain PyTorch versions. Without --smoke the full
config at the train_4k shape is instantiated (256 x 4096 tokens a step:
more than one card holds). Weights are drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.common import resolve_device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.optim import OptConfig
from repro_torch.runtime import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "train")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
        shape = ShapeConfig("cli", args.seq, args.batch, "train")
    else:
        shape = SHAPES["train_4k"]
    trainer = Trainer(cfg, shape, args.workdir, OptConfig(warmup_steps=10),
                      ckpt_every=args.ckpt_every, seed=args.seed,
                      device=device)

    def hook(step, metrics):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}")

    trainer.run(args.steps, hook=hook)
    print(f"done on {device}; stragglers flagged: {trainer.watchdog.events}")


if __name__ == "__main__":
    main()
