"""Roofline report: the port's dry-run reports beside the analytic cost model.

For every (arch x shape x mesh) JSON that ``launch/dryrun.py`` wrote, emit
the three terms of the cost model on H100 figures (compute / memory /
collective, in seconds), the dominant one, model flops over the model's
flops, the counted flops (PyTorch's FlopCounterMode, plain attention) over
the model's, and the per-device residency against one H100's memory: a
markdown table on stdout and a machine-readable JSON.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.costmodel import cost_cell
from repro_torch.launch.dryrun import OUT_DIR

DEVICE_MEMORY = 80e9   # bytes: NVIDIA H100 SXM5 data sheet, 80 GB HBM3


def analyze(path: str) -> dict:
    with open(path) as f:
        r = json.load(f)
    cfg = get_config(r["arch"])
    shape = SHAPES[r["shape"]]
    micro = r.get("analytic_memory", {}).get("micro_batches", 1)
    # EP rules always fully shard expert weights (over data and/or model)
    kw = {"assume_ep": True} if (cfg.num_experts and shape.kind == "train") else {}
    cost = cost_cell(cfg, shape, r["mesh_shape"], micro, **kw)
    terms = cost.terms(r["chips"])
    resid = r.get("analytic_memory", {}).get("total", 0)
    counted = r["counted_flops"]
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "chips": r["chips"],
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "dominant", "useful_ratio",
                                 "roofline_fraction")},
        "model_flops": cost.model_flops,
        "analytic_flops": cost.flops,
        "counted_flops_raw": counted,
        "counted_over_analytic": counted / cost.flops,
        "analytic_coll_bytes": cost.coll_bytes,
        "resident_gib": resid / 2**30,
        "fits_device_memory": resid < DEVICE_MEMORY,
        "count_s": r.get("count_s"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(OUT_DIR),
                                                  "roofline.json"))
    ap.add_argument("--mesh", default="pod16x16",
                    help="mesh for the markdown table")
    args = ap.parse_args(argv)
    rows = [analyze(path)
            for path in sorted(glob.glob(os.path.join(args.dir, "*.json")))]
    if not rows:
        raise SystemExit(f"roofline: no dry-run report under {args.dir}")
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print("| arch | shape | compute_s | memory_s | collective_s | dominant "
          "| useful | roofline_frac | counted/model | resid GiB | fits 80 GB |")
    print("|" + "---|" * 11)
    for r in rows:
        if r["mesh"] != args.mesh:
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
              f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
              f"{r['dominant']} | {r['useful_ratio']:.2f} | "
              f"{r['roofline_fraction']:.2f} | "
              f"{r['counted_over_analytic']:.4f} | "
              f"{r['resident_gib']:.2f} | "
              f"{'Y' if r['fits_device_memory'] else 'N'} |")


if __name__ == "__main__":
    main()
