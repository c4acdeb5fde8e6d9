"""Uniform model API: build_model and the serving step factories.

    prefill_step(params, batch)                 -> (logits, cache)
    decode_step(params, cache, batch)           -> (logits, cache)

The training step belongs to the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, device="cuda") -> TransformerLM:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet")
    return TransformerLM(cfg, device)


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"])
    return decode_step
