"""RecurrentGemma-9B — RG-LRU recurrent blocks + local sliding-window
attention in a 2:1 pattern (rec, rec, attn) [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        block_pattern=("rec", "rec", "attn"),
        window_size=2048, lru_width=4096, conv_width=4,
        rope_theta=10000.0,
        embedding_impl="mapsin",
    )
