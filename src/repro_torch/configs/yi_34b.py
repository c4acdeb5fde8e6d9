"""Yi-34B — dense llama-arch GQA kv=8 [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("yi-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128,
        rope_theta=5_000_000.0,
    )
