"""DBRX 132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352, head_dim=128,
        num_experts=16, top_k=4, moe_d_ff=10752,
        rope_theta=500_000.0,
        embedding_impl="mapsin",
    )
