"""Config system: model architecture configs, input shapes, registry.

A copy of the JAX package's ``configs/base.py`` (that file imports no
JAX, but the port imports nothing of the JAX package). Every field keeps
its name and default, except ``attention_impl``, which takes the port's
values: ``"kernel"`` (the hand-written CUDA flash-attention kernel on a
CUDA tensor, its plain version on the CPU) or ``"torch"`` (the plain
version everywhere).

Each architecture gets one ``configs/<arch>.py`` registering the
published hyper-parameters; every architecture of the JAX package is
registered, and ``get_config`` raises ``KeyError`` for any other name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

ATTENTION_IMPLS = ("kernel", "torch")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading dense layers (deepseek-v3 style)
    dense_d_ff: int = 0          # d_ff for those dense layers (0 -> d_ff)
    router_aux_weight: float = 1e-3
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0  # multi-token-prediction depth

    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    window_size: int = 0  # sliding window for local attention (0 = full)
    lru_width: int = 0
    conv_width: int = 4

    # --- ssm (xlstm) ---
    slstm_at: tuple[int, ...] = ()
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- modality frontend stubs ---
    num_patches: int = 0     # vlm: image patch embeddings prepended to text
    num_codebooks: int = 0   # audio: EnCodec codebooks (frontend stub)

    # --- numerics & implementation switches ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # float8_e4m3fn: quantized decode cache
    attention_impl: str = "kernel"   # kernel (CUDA flash attention) | torch
    embedding_impl: str = "dense"    # dense | mapsin (distributed_lookup)
    remat_policy: str = "names"      # none | minimal | names | full
    logical_rules: str = "default"   # sharding rule set name (see sharding/rules.py)
    attn_block_q: int = 512          # blockwise attention tile sizes
    attn_block_kv: int = 1024
    causal_split: bool = False       # split-causal flop-saving decomposition
    scan_layers: bool = True         # False: unroll (exact XLA cost analysis)

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS} in this "
                f"package, got {self.attention_impl!r}")

    # derived ----------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_subquadratic(self) -> bool:
        """True if sequence mixing is sub-quadratic (can run long_500k)."""
        return self.family in ("ssm", "hybrid")

    @property
    def moe_layer_ids(self) -> tuple[int, ...]:
        if self.num_experts == 0:
            return ()
        return tuple(range(self.first_dense_layers, self.num_layers))

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim
        for layer in range(self.num_layers):
            if self.family == "ssm":
                if layer in self.slstm_at:
                    # sLSTM: 4 gates recurrent+input + ffn
                    total += 8 * d * d + int(2 * d * d * self.slstm_proj_factor)
                else:
                    inner = int(d * self.mlstm_proj_factor)
                    total += 2 * d * inner + inner * d + 3 * inner * (inner // max(self.num_heads, 1)) // max(inner // max(self.num_heads, 1), 1)  # approx qkv
                total += 2 * d
                continue
            is_rec = bool(self.block_pattern) and self.block_pattern[layer % len(self.block_pattern)] == "rec" if self.block_pattern else False
            if is_rec:
                w = self.lru_width or d
                total += 2 * d * w + w * d + self.conv_width * w + 2 * w  # rg-lru block
            elif self.use_mla:
                total += d * self.q_lora_rank
                total += self.q_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                total += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                total += self.num_heads * self.v_head_dim * d
            else:
                total += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
            # mlp / moe
            if self.num_experts and layer in self.moe_layer_ids:
                total += (self.num_experts + self.num_shared_experts) * 3 * d * self.moe_d_ff
                total += d * self.num_experts  # router
            else:
                ff = self.dense_d_ff or self.d_ff
                if ff:
                    total += 3 * d * ff
            total += 2 * d  # norms
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.num_experts == 0:
            return self.n_params()
        total = self.n_params()
        n_moe = len(self.moe_layer_ids)
        inactive = (self.num_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff * n_moe
        return total - inactive


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for LM-family transformers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def runnable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells this architecture runs (long_500k needs sub-quadratic)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.is_subquadratic:
        out.append(SHAPES["long_500k"])
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

# architectures of the JAX package whose model families are not ported yet
# (none: every one runs here)
NOT_PORTED: tuple[str, ...] = ()


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (triggers arch module imports)
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported to this package yet; "
                       f"ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family/feature set, tiny dims: one forward/train step on CPU."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=2, moe_d_ff=32,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  dense_d_ff=128 if cfg.dense_d_ff else 0)
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, head_dim=0)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    if cfg.block_pattern:
        kw.update(num_layers=5, lru_width=64, window_size=32)  # rec,rec,attn,rec,rec
    if cfg.family == "ssm":
        kw.update(num_layers=4, slstm_at=(3,), d_ff=0)
    if cfg.num_patches:
        kw.update(num_patches=8)
    if cfg.num_codebooks:
        kw.update(num_codebooks=cfg.num_codebooks, vocab_size=64)
    if cfg.window_size and not cfg.block_pattern:
        kw.update(window_size=32)
    kw.update(param_dtype="float32", activation_dtype="float32",
              attn_block_q=16, attn_block_kv=32)
    return dataclasses.replace(cfg, **kw)
