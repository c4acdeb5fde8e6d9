"""Serving launcher: prefill a prompt batch, decode N tokens greedily.

``python -m repro_torch.launch.serve --arch yi-6b`` on a CUDA card;
``python -m repro_torch.launch.serve --smoke --device cpu`` runs the
reduced config on the CPU through the plain PyTorch versions.
Weights are drawn from ``--seed``; prompts from numpy's RandomState(seed).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, tokens: torch.Tensor, n: int):
    """Greedy decoding: prefill `tokens` (b, s), then `n` decode steps, each
    fed the argmax of the previous logits. Returns (ids (b, n) int64,
    prefill seconds, decode seconds per token), the times by the host
    clock around work that ends in a device sync."""
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    _sync(tokens.device)
    t_prefill = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    for _ in range(n):
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        logits, cache = decode(params, cache,
                               {"tokens": nxt[:, None].to(torch.int32)})
    _sync(tokens.device)
    t_decode = (time.perf_counter() - t0) / max(n, 1)
    ids = torch.stack(out, 1) if out else tokens.new_zeros((tokens.shape[0], 0))
    return ids, t_prefill, t_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "serve")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    model = build_model(cfg, device)
    params = model.init_params(args.seed)
    rng = np.random.RandomState(args.seed)
    toks = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)
    ids, t_prefill, t_decode = generate(model, params, toks, args.tokens)
    print(f"prefill({args.prompt_len} tok x {args.batch}) on {device}: "
          f"{t_prefill * 1e3:.1f} ms")
    print(f"decode: {t_decode * 1e3:.2f} ms/token")
    print("sampled ids:", ids[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
