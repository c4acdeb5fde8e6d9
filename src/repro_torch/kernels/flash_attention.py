"""Forward attention: the plain PyTorch version and the launch of the
hand-written CUDA kernel (``csrc/flash_attention.cu``).

Both compute, for q (b, sq, h, e) and k, v (b, skv, g, e) with h % g == 0,
o = softmax(q k^T * scale + mask) v in float32, query head i reading kv
head i // (h // g), and return o (b, sq, h, e) in q's dtype: the contract
of the TPU kernel ``repro.kernels.ops.flash_attention``. The causal mask is
end-aligned, k_pos <= q_pos + (skv - sq), as in the JAX package's
``ref.attention_ref``; at sq == skv it is the Pallas kernel's mask.
``kernels/ops.py`` chooses between them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.searchsorted import check_tensor

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """The plain version: the full score matrix of ``ref.attention_ref``,
    in float32, the masked scores filled with -1e30."""
    b, sq, h, e = q.shape
    skv, g = k.shape[1], k.shape[2]
    scale = scale or e ** -0.5
    qg = q.reshape(b, sq, g, h // g, e).float()
    s = torch.einsum("bqgre,bkge->bgrqk", qg, k.float())
    s.mul_(scale)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        s.masked_fill_(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bgrqk,bkge->bqgre", p, v.float())
    return o.reshape(b, sq, h, e).to(q.dtype)


@functools.cache               # argument types are set once per process
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q (b, sq, h, e), k and
    v (b, skv, g, e): contiguous, one CUDA device, one dtype (float32 or
    bfloat16), e in HEAD_DIMS. Returns o (b, sq, h, e) in q's dtype."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q: expected (b, sq, h, e), got {tuple(q.shape)}")
    b, sq, h, e = q.shape
    check_tensor(q, "q", q.dtype, (b, sq, h, e))
    check_tensor(k, "k", q.dtype, (b, None, None, e), q.device)
    check_tensor(v, "v", q.dtype, tuple(k.shape), q.device)
    skv, g = k.shape[1], k.shape[2]
    if e not in HEAD_DIMS:
        raise ValueError(f"head_dim {e} is not one of {HEAD_DIMS}")
    if g == 0 or h % g:
        raise ValueError(f"{h} query heads do not divide into {g} kv heads")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid's 65535")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, got {type(causal).__name__}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, sq, skv, h, g, e, _DTYPE_CODE[q.dtype], int(causal),
                   scale or e ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out
