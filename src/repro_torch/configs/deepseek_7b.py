"""DeepSeek-LLM 7B — dense llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense",
        num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=102400, head_dim=128,
        rope_theta=10000.0, tie_embeddings=False,
        embedding_impl="mapsin",  # vocab >= 100k: distributed_lookup path
    )
