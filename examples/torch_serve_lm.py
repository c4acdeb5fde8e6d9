"""Serve a small model with the PyTorch port: batched prefill + incremental
decode with a KV cache.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen3-8b]
        [--device cuda|cpu]

The reduced config of the arch (``launch/serve.py --smoke``), 8 tokens
decoded; on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import main  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3-8b")
ap.add_argument("--device", default="cuda")
args, rest = ap.parse_known_args()
main(["--arch", args.arch, "--smoke", "--tokens", "8",
      "--device", args.device] + rest)
