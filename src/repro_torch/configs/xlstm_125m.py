"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].
d_ff=0: mixing blocks carry their own projections (mLSTM proj-factor 2 up/down,
sLSTM gated 4/3 FFN). sLSTM placement follows the paper's sparse-ratio style
(~1 sLSTM per 6 blocks)."""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_at=(5, 11),
        tie_embeddings=True,
    )
