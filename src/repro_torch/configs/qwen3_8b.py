"""Qwen3-8B — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12288, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
        embedding_impl="mapsin",
    )
