"""Yi-6B — dense llama-arch with GQA kv=4 [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("yi-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, head_dim=128,
        rope_theta=5_000_000.0,
    )
