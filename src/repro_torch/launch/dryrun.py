"""Dry-run: count every (arch x shape x mesh) cell without allocating it.

For each cell the step's inputs (parameters, optimizer state, decode cache
and batch) are ``meta`` tensors from the ParamDef trees (``abstract_tree``:
shapes and dtypes, no storage), and the step runs on them under
``torch.utils.flop_counter.FlopCounterMode``:
  * train   — the loss's forward and backward (``loss_and_grads``) of one
              microbatch, times the microbatch count (FlopCounterMode
              counts by shape, and every microbatch has the same shapes);
              the optimizer's elementwise update counts no flops;
  * prefill — ``prefill``;  decode — ``decode_step``.
The count is global (the port runs a mesh's shards on one device), so it
lines up with the cost model's global flops. It uses
``attention_impl="torch"``: the CUDA flash-attention kernel takes only CUDA
tensors and refuses ``meta`` ones, so the count is the plain attention's
(the full score matrix, the same products). With
``embedding_impl="mapsin"`` the vocab-sharded lookup runs over the mesh's
`model` axis, one thread a shard, on ``meta`` tensors. On ``meta`` tensors
the models' step loops (xlstm's mLSTM chunks and sLSTM steps, MLA's kv
blocks) run their like steps as one batched step with the same products,
so every cell counts in seconds; tests/test_torch_launch.py holds that
count equal to the loop's on CPU tensors.

Per-device memory is analytic (``analytic_memory``, from the sharded
ParamDef trees). Collective bytes come only from the cost model
(``launch/costmodel.py``): PyTorch has no SPMD compiler whose output could
be parsed. The count is host work alone (no device runs), one cell a
process, as many processes as the host gives this one cores.

The per-cell JSON lands in ``build/dryrun/`` (git-ignored) and feeds
``launch/roofline.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common import dump_json
from repro_torch.configs import SHAPES, get_config, list_archs, runnable_shapes
from repro_torch.launch.costmodel import cost_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (build_model, default_micro_batches, input_defs,
                                loss_and_grads, make_decode_step,
                                make_prefill_step)
from repro_torch.models.params import abstract_tree, sharded_bytes_per_device
from repro_torch.optim import OptConfig, opt_state_defs
from repro_torch.sharding.rules import make_rules

OUT_DIR = "build/dryrun"
COUNTED_ATTENTION = "torch"


def _opt_cfg(cfg) -> OptConfig:
    # memory-floor models: bf16 optimizer moments
    big = cfg.n_params() > 100e9
    return OptConfig(moment_dtype="bfloat16" if big else "float32")


def build_cell(arch: str, shape_name: str, mesh):
    """(fn, meta args, cfg, rules, micro_batches) of one cell; `fn(*args)`
    runs the counted step (for train, one microbatch of it)."""
    cfg = get_config(arch, attention_impl=COUNTED_ATTENTION)
    shape = SHAPES[shape_name]
    rules = make_rules(mesh, cfg, shape)
    model = build_model(cfg, mesh, rules, device="meta")
    micro = default_micro_batches(cfg, shape, mesh)
    batch = abstract_tree(input_defs(cfg, shape, micro), rules)
    pdefs = model.param_defs()
    params = abstract_tree(pdefs, rules)
    if shape.kind == "train":
        opt = abstract_tree(opt_state_defs(pdefs, _opt_cfg(cfg)), rules)

        def train(params, opt_state, batch):
            mb = batch if micro == 1 else {k: v[0] for k, v in batch.items()}
            loss_and_grads(model, params, mb)
        return train, (params, opt, batch), cfg, rules, micro
    if shape.kind == "prefill":
        return make_prefill_step(model), (params, batch), cfg, rules, micro
    cache = abstract_tree(model.cache_defs(shape.global_batch, shape.seq_len),
                          rules)
    return make_decode_step(model), (params, cache, batch), cfg, rules, micro


def analytic_memory(arch: str, shape_name: str, mesh) -> dict:
    """Exact per-device resident bytes (params/opt/cache/inputs + remat
    stash) from the sharded ParamDef trees."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = make_rules(mesh, cfg, shape)
    model = build_model(cfg, mesh, rules, device="meta")
    micro = default_micro_batches(cfg, shape, mesh)
    out = {"micro_batches": micro}
    pdefs = model.param_defs()
    out["params"] = sharded_bytes_per_device(pdefs, rules)
    if shape.kind == "train":
        big = cfg.n_params() > 100e9
        out["opt"] = sharded_bytes_per_device(opt_state_defs(pdefs, _opt_cfg(cfg)),
                                              rules)
        out["grad_accum"] = out["params"] * (1 if big else 2) if micro > 1 else 0
        dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        rows_local = max(shape.global_batch // micro // dp, 1)
        out["remat_stash"] = (cfg.num_layers * rows_local * shape.seq_len
                              * cfg.d_model * 2)
    if shape.kind == "decode":
        cdefs = model.cache_defs(shape.global_batch, shape.seq_len)
        out["cache"] = sharded_bytes_per_device(cdefs, rules)
    out["batch"] = sharded_bytes_per_device(input_defs(cfg, shape, micro), rules)
    out["total"] = sum(v for k, v in out.items() if k != "micro_batches")
    return out


def count_flops(fn, args) -> tuple[int, dict]:
    """(total, {op: flops}) of `fn(*args)` under FlopCounterMode."""
    # serving steps record no graph; loss_and_grads turns grad on itself
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(*args)
    by_op = {str(k): int(v) for k, v in fc.get_flop_counts()["Global"].items()}
    return int(fc.get_total_flops()), by_op


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    t0 = time.perf_counter()
    fn, args, cfg, rules, micro = build_cell(arch, shape_name, mesh)
    flops, by_op = count_flops(fn, args)
    if shape.kind == "train":
        flops, by_op = flops * micro, {k: v * micro for k, v in by_op.items()}
    count_s = time.perf_counter() - t0
    mesh_shape = dict(mesh.shape)
    # EP rules always fully shard expert weights (over data and/or model)
    kw = {"assume_ep": True} if (cfg.num_experts and shape.kind == "train") else {}
    cost = cost_cell(cfg, shape, mesh_shape, micro, **kw)
    report = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": mesh_shape, "chips": mesh.size,
        "kind": shape.kind,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "micro_batches": micro,
        "analytic_memory": analytic_memory(arch, shape_name, mesh),
        "counted_attention_impl": COUNTED_ATTENTION,
        "counted_flops": flops, "counted_flops_by_op": by_op,
        "cost_model": {"flops": cost.flops, "model_flops": cost.model_flops,
                       "hbm_bytes": cost.hbm_bytes,
                       "coll_bytes": cost.coll_bytes},
        "count_s": round(count_s, 3),
        "kv_mode": rules.kv_mode,
    }
    os.makedirs(out_dir, exist_ok=True)
    dump_json(report, os.path.join(out_dir,
                                   f"{arch}_{shape_name}_{mesh_name}.json"))
    ana = report["analytic_memory"]["total"]
    print(f"[dryrun] {arch:20s} {shape_name:12s} {mesh_name:10s} "
          f"flops={flops:.4e} counted/model={flops / cost.flops:.4f} "
          f"coll={cost.coll_bytes:.3e}B resid/dev={ana / 2**30:.2f}GiB "
          f"count={count_s:.2f}s", flush=True)
    return report


def _try_cell(cell, out_dir: str):
    """(report, None) or (None, the traceback) of one (arch, shape,
    multi_pod) cell, for a worker process."""
    try:
        return run_cell(*cell, out_dir), None
    except Exception:      # noqa: BLE001 — reported by main
        return None, traceback.format_exc(limit=3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([SHAPES[args.shape]] if args.shape
                  else runnable_shapes(cfg))
        for sh in shapes:
            cells.append((arch, sh.name))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    work = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    # the largest models first, so that the last cells to start are short
    work.sort(key=lambda c: -get_config(c[0]).n_params())
    failures = []
    t0 = time.perf_counter()
    one = functools.partial(_try_cell, out_dir=args.out)
    jobs = min(len(os.sched_getaffinity(0)), len(work))
    with ProcessPoolExecutor(jobs, multiprocessing.get_context("spawn")) as pool:
        for cell, (_, err) in zip(work, pool.map(one, work)):
            if err is not None:
                failures.append(cell)
                print(f"[dryrun] FAIL {cell}:\n{err}")
    print(f"[dryrun] done: {len(work) - len(failures)} counted, "
          f"{len(failures)} failed, {jobs} processes, "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
