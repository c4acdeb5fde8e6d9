"""How well-conditioned xlstm-125m's step-0 gradients are: the gradients in
bf16, and in float32 at the weights perturbed by one bf16 rounding (2^-9)
and by 1e-6, each as a cosine from float32 at the weights themselves, over
the whole flattened gradient and layer by layer.

    PYTHONPATH=src python scripts/xlstm_grad_conditioning.py \
        [--package port|jax] [--device cuda|cpu] [--d-model D] \
        [--seqs 2048,1024,512,256] [--rows 2]

`--package port` runs the PyTorch port (on the card unless `--device cpu`);
`--package jax` runs the JAX package on its default device (the CPU here).
`--d-model` narrows the model (heads and layers stay) so that the CPU can
run it; the batch is batch_for_step's step 0 at seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

REL = {"one bf16 rounding": 2.0 ** -9, "1e-6": 1e-6}


def cosine(a: dict, b: dict, keys=None) -> tuple[float, float, float]:
    keys = list(a) if keys is None else keys
    dot = sum(float(a[k] @ b[k]) for k in keys)
    na = sum(float(a[k] @ a[k]) for k in keys)
    nb = sum(float(b[k] @ b[k]) for k in keys)
    return dot / math.sqrt(na * nb), math.sqrt(na), math.sqrt(nb)


def port_runner(cfg, device: str):
    import torch

    from repro_torch.common import tree_map_with_path, tree_paths
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for_step
    from repro_torch.models import build_model, loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params = build_model(cfg, device).init_params(0)
    p32 = tree_map_with_path(lambda _, t: t.float(), params)
    gen = torch.Generator(device).manual_seed(1)
    models = {"bf16": build_model(cfg, device),
              "f32": build_model(cfg32, device)}

    def run(name: str, rel: float, rows: int, seq: int):
        shape = ShapeConfig("t", seq, rows, "train")
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 batch_for_step(cfg, shape, 0, 0).items()}
        p = params if name == "bf16" else p32
        if rel:
            p = tree_map_with_path(lambda _, t: t * (1 + rel * torch.randn(
                t.shape, device=device, generator=gen)), p)
        loss, _, g = loss_and_grads(models[name], p, batch)
        return float(loss), {"/".join(k): v.double().flatten().cpu().numpy()
                             for k, v in tree_paths(g)}
    return run


def jax_runner(cfg, device: str):
    import jax
    import jax.numpy as jnp

    from repro.common import tree_paths
    from repro.configs.base import ShapeConfig
    from repro.data import batch_for_step
    from repro.models import build_model
    from repro.models.params import init_tree

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params = init_tree(build_model(cfg).param_defs(), jax.random.key(0))
    p32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    grads = {"bf16": jax.jit(jax.value_and_grad(build_model(cfg).loss,
                                                has_aux=True)),
             "f32": jax.jit(jax.value_and_grad(build_model(cfg32).loss,
                                               has_aux=True))}
    key = [jax.random.key(1)]

    def run(name: str, rel: float, rows: int, seq: int):
        shape = ShapeConfig("t", seq, rows, "train")
        batch = {k: jnp.asarray(v) for k, v in
                 batch_for_step(cfg, shape, 0, 0).items()}
        p = params if name == "bf16" else p32
        if rel:
            leaves, tree = jax.tree.flatten(p)
            key[0], *ks = jax.random.split(key[0], len(leaves) + 1)
            p = jax.tree.unflatten(tree, [
                t * (1 + rel * jax.random.normal(k, t.shape, jnp.float32))
                for t, k in zip(leaves, ks)])
        (loss, _), g = grads[name](p, batch)
        return float(loss), {"/".join(k): np.asarray(
            v.astype(jnp.float32), np.float64).ravel() for k, v in tree_paths(g)}
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--seqs", default="2048,1024,512,256")
    ap.add_argument("--rows", type=int, default=2)
    args = ap.parse_args(argv)
    if args.package == "port":
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    cfg = get_config("xlstm-125m")
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    run = (port_runner if args.package == "port" else jax_runner)(
        cfg, args.device)
    for seq in (int(s) for s in args.seqs.split(",")):
        t0 = time.perf_counter()
        loss_f, g_f = run("f32", 0.0, args.rows, seq)
        loss_b, g_b = run("bf16", 0.0, args.rows, seq)
        parts = [f"bf16 {cosine(g_b, g_f)[0]:.6f} (loss {loss_b:.6f})"]
        shifted = {}
        for what, rel in REL.items():
            loss_s, shifted[what] = run("f32", rel, args.rows, seq)
            parts.append(f"float32 at weights x (1 + {rel:.3e} N) "
                         f"{cosine(shifted[what], g_f)[0]:.6f}")
        print(f"{args.package} d {cfg.d_model}, {args.rows} x {seq}: loss "
              f"{loss_f:.6f}, |g| {cosine(g_f, g_f)[1]:.4e}; cosine from "
              f"float32: " + "; ".join(parts)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        for layer in ["embed", "final_norm"] + [
                f"layer{i}" for i in range(cfg.num_layers)]:
            keys = [k for k in g_f if k == layer or k.startswith(layer + "/")]
            print(f"  {layer}: |g| {cosine(g_f, g_f, keys)[1]:.4e}, bf16 "
                  f"{cosine(g_b, g_f, keys)[0]:.6f}, one bf16 rounding "
                  f"{cosine(shifted['one bf16 rounding'], g_f, keys)[0]:.6f}",
                  flush=True)


if __name__ == "__main__":
    main()
