"""Forward attention: the plain PyTorch version and the launch of the
hand-written CUDA kernel (``csrc/flash_attention.cu``).

Both compute, for q (b, sq, h, e) and k, v (b, skv, g, e) with h % g == 0,
o = softmax(q k^T * scale + mask) v in float32, query head i reading kv
head i // (h // g), and return o (b, sq, h, e) in q's dtype: the contract
of the TPU kernel ``repro.kernels.ops.flash_attention``. The causal mask is
end-aligned, k_pos <= q_pos + (skv - sq), as in the JAX package's
``ref.attention_ref``; at sq == skv it is the Pallas kernel's mask.
``kernels/ops.py`` chooses between them.

The CUDA source holds two kernels, and ``variant`` picks one by dtype and
head dim: "wgmma" (bf16 on the tensor cores, TMA-fed; P rounded to bf16
before P.V, as a TPU's MXU and cuDNN's kernels round it) for bfloat16 at
head dims 64 and 128; "simt" (float32 FMAs on the CUDA cores) for float32
and for bfloat16 at 16 and 32. The wgmma kernel's tensor maps need q, k
and v 16-byte aligned: ``flash_attention_cuda`` raises on a pointer that
is not. The choice is made before the launch: a launch that fails raises,
whichever kernel it was.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.searchsorted import check_tensor

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
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


def variant(q: torch.Tensor) -> str:
    """The kernel a call of ``flash_attention_cuda`` with this q launches:
    "wgmma" for bfloat16 at a head dim in WGMMA_HEAD_DIMS, else "simt"."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


@functools.cache               # argument types are set once per process
def _fn(name: str):
    lib = _build.library("flash_attention")
    fn = getattr(lib, f"flash_attention_{name}")
    dtype = [ctypes.c_int] if name == "simt" else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + dtype
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel that ``variant`` names on the current
    stream. q (b, sq, h, e), k and v (b, skv, g, e): contiguous, one CUDA
    device, one dtype (float32 or bfloat16), e in HEAD_DIMS; for the
    wgmma kernel, 16-byte aligned. Returns o (b, sq, h, e) in q's dtype."""
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
    name = variant(q)
    if name == "wgmma":
        for t, label in ((q, "q"), (k, "k"), (v, "v")):
            if t.data_ptr() % 16:
                raise ValueError(f"{label}: the wgmma kernel's tensor map "
                                 f"needs a 16-byte aligned pointer")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    dtype = (_DTYPE_CODE[q.dtype],) if name == "simt" else ()
    with torch.cuda.device(q.device):
        rc = _fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, sq, skv, h, g, e, *dtype,
                       int(causal), scale or e ** -0.5,
                       torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"flash_attention ({name}): cuTensorMapEncodeTiled "
                           f"failed: CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash_attention ({name}) kernel launch failed: "
                           f"CUDA error {rc}")
    return out
