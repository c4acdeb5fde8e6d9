"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The audio frontend (EnCodec + delay-pattern interleave) is a STUB:
models/api.py input_defs takes the EnCodec codes as (b, s, codebooks)
tokens; the backbone predicts codebook tokens."""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, head_dim=64,
        num_codebooks=4,
        rope_theta=10000.0,
    )
