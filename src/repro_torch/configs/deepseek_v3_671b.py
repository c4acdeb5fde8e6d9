"""DeepSeek-V3 671B — MLA + 1 shared/256 routed top-8 MoE + MTP
[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]."""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=2048,  # routed-expert hidden dim (assigned shape table value)
        vocab_size=129280,
        # MoE: first 3 layers dense (d_ff 18432), rest 256 routed + 1 shared
        num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_dense_layers=3, dense_d_ff=18432,
        # MLA
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        mtp_depth=1,
        rope_theta=10000.0,
        embedding_impl="mapsin",
    )
