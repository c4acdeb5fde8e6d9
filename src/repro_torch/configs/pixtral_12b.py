"""Pixtral-12B — pixtral-ViT frontend (STUB) + mistral-nemo decoder backbone
[hf:mistralai/Pixtral-12B-2409]. The modality frontend is a stub:
models/api.py input_defs takes precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=131072, head_dim=128,
        rope_theta=1_000_000_000.0,
        num_patches=256,  # patch embeddings prepended to the text sequence
        embedding_impl="mapsin",
    )
