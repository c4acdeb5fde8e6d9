"""Serving launcher: prefill a prompt batch, decode N tokens greedily.

``python -m repro_torch.launch.serve --arch yi-6b`` on a CUDA card (any
ported arch: ``--arch dbrx-132b`` and so on);
``python -m repro_torch.launch.serve --arch dbrx-132b --smoke --device cpu``
runs the reduced config on the CPU through the plain PyTorch versions.
Weights are drawn from ``--seed``; prompts (one token a codebook for the
audio family) and the vlm family's patch embeddings from numpy's
RandomState(seed), as the JAX package's launcher draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, make_decode_step, make_prefill_step
from repro_torch.models.transformer import VIT_DIM


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, tokens: torch.Tensor, n: int,
             patch_embeds: torch.Tensor | None = None):
    """Greedy decoding: prefill `tokens` (b, s), or (b, s, K) for the audio
    family (behind `patch_embeds` for vlm), then `n` decode steps, each fed
    the argmax of the previous logits. Returns (ids (b, n) int64, or
    (b, n, K), prefill seconds, decode seconds per token), the times by
    the host clock around work that ends in a device sync."""
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    batch = {"tokens": tokens}
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
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
    ids = (torch.stack(out, 1) if out else
           tokens.new_zeros((tokens.shape[0], 0) + tokens.shape[2:]))
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
    shape = (args.batch, args.prompt_len)
    if cfg.family == "audio":
        shape += (cfg.num_codebooks,)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, shape),
                           dtype=torch.int32, device=device)
    patches = None
    if cfg.family == "vlm":
        patches = torch.as_tensor(
            rng.randn(args.batch, cfg.num_patches, VIT_DIM),
            dtype=torch.float32, device=device)
    ids, t_prefill, t_decode = generate(model, params, toks, args.tokens,
                                        patches)
    print(f"prefill({args.prompt_len} tok x {args.batch}) on {device}: "
          f"{t_prefill * 1e3:.1f} ms")
    print(f"decode: {t_decode * 1e3:.2f} ms/token")
    print("sampled ids:", ids[0].reshape(-1)[:16].cpu().numpy())


if __name__ == "__main__":
    main()
