"""Analytic roofline cost model: FLOPs, HBM bytes and collective bytes of
one step of an (arch x shape x mesh) cell.

A copy of the JAX package's formulas (``launch/costmodel.py``), which
mirror the model op for op, inefficiencies included (full-rectangle
attention blocks, MoE capacity padding, remat recompute). The peaks are
one NVIDIA H100 SXM5's, not the TPU's:

    compute    = FLOPs_global / (gpus * PEAK_FLOPS)   [dense bf16 / GPU]
    memory     = HBM_global   / (gpus * HBM_BW)       [HBM3 / GPU]
    collective = coll_global  / (gpus * LINK_BW)      [NVLink 4, one way]

One link rate for every collective holds inside one NVLink domain (8
GPUs of an HGX node). A mesh beyond one node (the 16x16 and 2x16x16
layouts) crosses slower inter-node links (InfiniBand or Ethernet) on some
of its axes, which this constant does not model: the collective term is a
lower bound there.

PyTorch has no SPMD compiler whose output could be parsed, so the
collective bytes of the port's dry-run come only from this model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.common import dtype_of
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.xlstm import CHUNK

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column
PEAK_FLOPS = 989.4e12  # dense BF16 Tensor Core FLOP/s (1,979 TFLOP/s with sparsity)
HBM_BW = 3.35e12       # HBM3 bytes/s (80 GB)
LINK_BW = 450e9        # NVLink 4 bytes/s each way (900 GB/s both ways, 18 links)


@dataclasses.dataclass
class CellCost:
    flops: float          # global, per step
    model_flops: float    # 6*N_active*D (train) / 2*N_active*D (serve)
    hbm_bytes: float      # global, per step
    coll_bytes: float     # global, per step
    detail: dict[str, float]

    def terms(self, chips: int) -> dict[str, Any]:
        compute = self.flops / (chips * PEAK_FLOPS)
        memory = self.hbm_bytes / (chips * HBM_BW)
        coll = self.coll_bytes / (chips * LINK_BW)
        dom = max(("compute", compute), ("memory", memory),
                  ("collective", coll), key=lambda t: t[1])
        step = max(compute, memory, coll)
        return {
            "compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": dom[0],
            "useful_ratio": self.model_flops / max(self.flops, 1),
            "roofline_fraction": (self.model_flops / (chips * PEAK_FLOPS)) / max(step, 1e-30),
            "step_s": step,
        }


def _attn_flops_per_token(cfg: ModelConfig, kv_span: float, causal_factor: float) -> float:
    """scores + pv flops per token for one layer (fwd)."""
    h = cfg.num_heads
    if cfg.use_mla:
        eq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        ev = cfg.v_head_dim
    else:
        eq = ev = cfg.resolved_head_dim
    return 2.0 * h * kv_span * (eq + ev) * causal_factor


def _layer_fwd_flops_per_token(cfg: ModelConfig, layer: int, seq: int,
                               block_q: int) -> float:
    """One layer's forward matmul flops per token (projections + mixing +
    FFN). Causal attention counts the full rectangle: the JAX package's
    triangle variant (``attention_impl="xla_tri"``) has no counterpart in
    the port."""
    d = cfg.d_model
    h, g, e = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f = 0.0
    is_rec = bool(cfg.block_pattern) and \
        cfg.block_pattern[layer % len(cfg.block_pattern)] == "rec"
    if cfg.family == "ssm":
        inner = int(d * cfg.mlstm_proj_factor)
        if layer in cfg.slstm_at:
            f += 2 * d * 4 * d + 4 * 2 * (d // max(cfg.num_heads, 1)) * d  # W + R
            f += 3 * 2 * d * int(d * cfg.slstm_proj_factor)                # ffn
        else:
            em = inner // cfg.num_heads
            f += 2 * d * 2 * inner + 3 * 2 * inner * inner + 2 * inner * d
            # chunkwise mixing: intra (2*L_chunk) + inter/state (4*em)
            f += 2 * cfg.num_heads * em * (2 * CHUNK + 4 * em)
        return f
    if is_rec:
        w = cfg.lru_width
        f += 2 * d * w * 2 + 2 * w * w * 2 + 2 * w * d + 2 * cfg.conv_width * w
        f += 10 * w  # scan combine work
    elif cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        f += 2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * h * (dn + dr)
        f += 2 * d * (cfg.kv_lora_rank + dr)
        f += 2 * cfg.kv_lora_rank * h * (dn + dv)
        f += 2 * h * dv * d
        span = seq  # full-rectangle blockwise baseline
        f += _attn_flops_per_token(cfg, span, 1.0)
    else:
        f += 2 * d * h * e + 2 * 2 * d * g * e + 2 * h * e * d
        if cfg.window_size:
            span = min(cfg.window_size + block_q, seq)
            f += _attn_flops_per_token(cfg, span, 1.0)
        else:
            f += _attn_flops_per_token(cfg, seq, 1.0)
    # FFN
    if cfg.num_experts and layer >= cfg.first_dense_layers:
        f += 2 * d * cfg.num_experts  # router
        f += cfg.top_k * cfg.capacity_factor * 3 * 2 * d * cfg.moe_d_ff
        f += cfg.num_shared_experts * 3 * 2 * d * cfg.moe_d_ff
    else:
        ff = (cfg.dense_d_ff or cfg.d_ff)
        if ff:
            f += 3 * 2 * d * ff
    return f


def _fwd_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    total = 0.0
    for layer in range(cfg.num_layers):
        total += _layer_fwd_flops_per_token(cfg, layer, seq, cfg.attn_block_q)
    total += 2 * cfg.d_model * cfg.vocab_size * (cfg.num_codebooks or 1)  # head
    if cfg.mtp_depth:
        total += _layer_fwd_flops_per_token(cfg, cfg.num_layers - 1, seq,
                                            cfg.attn_block_q)
        total += 2 * (2 * cfg.d_model) * cfg.d_model
        total += 2 * cfg.d_model * cfg.vocab_size
    return total


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.n_params() * 2.0  # bf16


def _mesh_dims(mesh_shape: dict[str, int]):
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    return dp, tp


def _expert_param_bytes(cfg: ModelConfig) -> float:
    """Bytes of routed-expert weights (bf16) — EP keeps them in place."""
    if not cfg.num_experts:
        return 0.0
    n_moe = len(cfg.moe_layer_ids)
    return cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff * n_moe * 2.0


def cost_train(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict[str, int],
               micro_batches: int = 1, assume_ep: bool | None = None) -> CellCost:
    tokens = shape.global_batch * shape.seq_len
    dp, tp = _mesh_dims(mesh_shape)
    chips = dp * tp
    fwd = _fwd_flops_per_token(cfg, shape.seq_len) * tokens
    # bwd = 2x fwd; full remat re-runs fwd once more
    remat_extra = {"none": 0.0, "minimal": 0.5, "names": 1.0, "full": 1.0}[cfg.remat_policy]
    flops = fwd * (3.0 + remat_extra)
    model_flops = 6.0 * cfg.n_active_params() * tokens
    # --- HBM ---
    pbytes = _param_bytes(cfg)
    big = cfg.n_params() > 100e9
    mom_b = 2.0 if big else 4.0  # bf16 moments for memory-floor models
    opt_bytes = cfg.n_params() * 2 * mom_b
    act_stash = cfg.num_layers * tokens / micro_batches * cfg.d_model * 2.0
    hbm = (
        pbytes * (2.0 + remat_extra) * micro_batches   # weights streamed fwd+bwd(+remat) per microbatch
        + pbytes + opt_bytes * 2 + cfg.n_params() * mom_b  # optimizer r/w + grads
        + act_stash * 2.0 * micro_batches               # stash write+read per microbatch
        + tokens * cfg.d_model * 2.0 * 8.0              # transient activation streams
    )
    # --- collectives: TOTAL link-crossing bytes, ring accounting ---
    #   all-gather / reduce-scatter of global tensor T over n: T*(n-1)
    #   all-reduce: 2*T*(n-1);  all-to-all: ~T
    coll = 0.0
    ep_wide = bool(cfg.num_experts) and cfg.num_experts % chips == 0
    if assume_ep is not None:
        ep_wide = assume_ep
    expert_b = _expert_param_bytes(cfg) if ep_wide else 0.0
    fsdp_b = max(pbytes - expert_b, 0.0)   # EP weights never gather
    passes = 2.0 + remat_extra
    if dp > 1:
        # FSDP weight all-gathers (fwd + bwd + remat) per microbatch
        coll += fsdp_b * passes * micro_batches * (dp - 1)
        # gradient reduce-scatter per microbatch (non-expert grads)
        grad_b = (cfg.n_params() * 2.0 - expert_b) * (1.0 if big else 2.0)
        coll += max(grad_b, 0.0) * micro_batches * (dp - 1)
    if tp > 1:
        # 3 per-layer TP combines (attn-out AR, mlp-down AR, carry AG/RS),
        # each ~an all-reduce of the global (tokens x d) bf16 activation
        t_act = tokens * cfg.d_model * 2.0
        coll += 3.0 * cfg.num_layers * 2.0 * t_act * (tp - 1) * passes / 2.0
    if ep_wide:
        # MoE dispatch + combine a2a of routed activations per pass
        t_routed = (tokens * cfg.top_k * cfg.capacity_factor
                    * cfg.d_model * 2.0)
        coll += 2.0 * len(cfg.moe_layer_ids) * t_routed * passes
    if cfg.embedding_impl == "mapsin" and tp > 1:
        coll += 2.0 * 2.0 * tokens * cfg.d_model * 2.0 * (tp - 1)  # psum rows
    detail = {"fwd_flops": fwd, "param_bytes": pbytes, "act_stash": act_stash,
              "fsdp_gather_bytes": fsdp_b}
    return CellCost(flops, model_flops, hbm, coll, detail)


def cost_serve(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict[str, int],
               prefill: bool, wide_mlp: bool = False) -> CellCost:
    """Serving: weights are TP-sharded and replicated over `dp` (no FSDP),
    except wide-EP expert weights (sharded over all chips, streamed once)."""
    dp, tp = _mesh_dims(mesh_shape)
    chips = dp * tp
    ep_wide = bool(cfg.num_experts) and cfg.num_experts % chips == 0
    expert_b = _expert_param_bytes(cfg) if ep_wide else 0.0
    dense_b = _param_bytes(cfg) - expert_b
    # every dp replica streams its TP slice of the dense weights per step
    mlp_b = 3 * cfg.d_model * (cfg.dense_d_ff or cfg.d_ff) * cfg.num_layers * 2.0 \
        if cfg.d_ff else 0.0
    if wide_mlp:
        # d_ff sharded over data x model: the MLP weights stream ONCE
        # globally instead of once per data replica
        weight_stream = (dense_b - mlp_b) * dp + mlp_b + expert_b
    else:
        weight_stream = dense_b * dp + expert_b
    if prefill:
        tokens = shape.global_batch * shape.seq_len
        flops = _fwd_flops_per_token(cfg, shape.seq_len) * tokens
        model_flops = 2.0 * cfg.n_active_params() * tokens
        hbm = (weight_stream + tokens * cfg.d_model * 2.0 * 8.0
               + _cache_bytes(cfg, shape))
        coll = 0.0
        if tp > 1:
            t_act = tokens * cfg.d_model * 2.0
            coll += 2.0 * cfg.num_layers * 2.0 * t_act * (tp - 1)
        if ep_wide:
            coll += 2.0 * len(cfg.moe_layer_ids) * tokens * cfg.top_k \
                * cfg.capacity_factor * cfg.d_model * 2.0
        return CellCost(flops, model_flops, hbm, coll, {})
    # decode: one token per sequence
    tokens = shape.global_batch
    flops = _fwd_flops_per_token_decode(cfg, shape.seq_len) * tokens
    model_flops = 2.0 * cfg.n_active_params() * tokens
    hbm = weight_stream + _cache_bytes(cfg, shape)
    coll = 0.0
    if tp > 1:
        t_act = tokens * cfg.d_model * 2.0
        coll += 2.0 * cfg.num_layers * 2.0 * t_act * (tp - 1)
    if ep_wide:
        coll += 2.0 * len(cfg.moe_layer_ids) * tokens * cfg.top_k \
            * cfg.d_model * 2.0
    if cfg.embedding_impl == "mapsin" and tp > 1:
        coll += 2.0 * tokens * cfg.d_model * 2.0 * (tp - 1)
    return CellCost(flops, model_flops, hbm, coll, {})


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    kvb = dtype_of(cfg.kv_cache_dtype).itemsize
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        inner = int(cfg.d_model * cfg.mlstm_proj_factor)
        em = inner // cfg.num_heads
        per = cfg.num_heads * (em * em + em + 1) * 4.0
        return cfg.num_layers * b * per
    if cfg.family == "hybrid":
        n_attn = sum(1 for i in range(cfg.num_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
        n_rec = cfg.num_layers - n_attn
        w = min(cfg.window_size, s)
        return (n_attn * b * w * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2.0
                + n_rec * b * cfg.lru_width * (4.0 + 2.0 * (cfg.conv_width - 1)))
    if cfg.use_mla:
        return cfg.num_layers * b * s * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * kvb
    return cfg.num_layers * b * s * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * kvb


def _fwd_flops_per_token_decode(cfg: ModelConfig, cache_len: int) -> float:
    """Decode reads the cache instead of seq-wide attention."""
    total = 0.0
    for layer in range(cfg.num_layers):
        if cfg.family == "ssm" or (cfg.block_pattern and
                                   cfg.block_pattern[layer % len(cfg.block_pattern)] == "rec"):
            total += _layer_fwd_flops_per_token(cfg, layer, 1, cfg.attn_block_q)
            continue
        span = min(cfg.window_size, cache_len) if cfg.window_size else cache_len
        d, h, g, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        if cfg.use_mla:
            c = cfg.kv_lora_rank
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            f = 2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * h * (dn + dr)
            f += 2 * d * (c + dr) + 2 * h * dn * c + 2 * h * dv * c  # absorbed
            f += 2 * h * span * (c + dr) + 2 * h * span * c          # latent attn
            f += 2 * h * dv * d
        else:
            f = 2 * d * h * e + 4 * d * g * e + 2 * h * e * d
            f += 2 * h * e * span * 2
        if cfg.num_experts and layer >= cfg.first_dense_layers:
            f += 2 * d * cfg.num_experts
            f += cfg.top_k * 3 * 2 * d * cfg.moe_d_ff
            f += cfg.num_shared_experts * 3 * 2 * d * cfg.moe_d_ff
        else:
            ff = (cfg.dense_d_ff or cfg.d_ff)
            if ff:
                f += 3 * 2 * d * ff
        total += f
    total += 2 * cfg.d_model * cfg.vocab_size * (cfg.num_codebooks or 1)
    return total


def cost_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict[str, int],
              micro_batches: int = 1, **kw) -> CellCost:
    if shape.kind == "train":
        return cost_train(cfg, shape, mesh_shape, micro_batches, **kw)
    return cost_serve(cfg, shape, mesh_shape,
                      prefill=(shape.kind == "prefill"), **kw)
