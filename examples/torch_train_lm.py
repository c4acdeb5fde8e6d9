"""Train a small LM end to end with the PyTorch port's fault-tolerant runtime.

    PYTHONPATH=src python examples/torch_train_lm.py [--arch xlstm-125m]
        [--steps 30] [--device cuda|cpu]

The reduced config of the arch (``reduce_for_smoke``) at 4 x 128 tokens a
step, through ``repro_torch.runtime.Trainer`` with a checkpoint every 10
steps; the loss must fall. It runs on the CUDA card unless ``--device
cpu`` is given; ``python -m repro_torch.launch.train`` trains the full
configs.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="xlstm-125m")
ap.add_argument("--steps", type=int, default=30)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = reduce_for_smoke(get_config(args.arch))
shape = ShapeConfig("example", 128, 4, "train")
with tempfile.TemporaryDirectory() as workdir:
    trainer = Trainer(cfg, shape, workdir, OptConfig(warmup_steps=5),
                      ckpt_every=10, device=args.device)
    losses = []
    trainer.run(args.steps, hook=lambda s, m: losses.append(float(m["loss"])))
    print(f"arch={args.arch} steps={args.steps} device={trainer.device} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss should decrease"
    print("checkpoints: " + ", ".join(sorted(
        d for d in os.listdir(workdir) if d.startswith("step_")))
          + f"; stragglers flagged: {trainer.watchdog.events}")
