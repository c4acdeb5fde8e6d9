"""Forward attention: the plain PyTorch version and the launch of the
hand-written CUDA kernel (``csrc/flash_attention.cu``).

Both compute, for q (b, sq, h, e) and k, v (b, skv, g, e) with h % g == 0,
o = softmax(q k^T * scale + mask) v in float32, query head i reading kv
head i // (h // g), and return o (b, sq, h, e) in q's dtype: the contract
of the TPU kernel ``repro.kernels.ops.flash_attention``. The causal mask is
end-aligned, k_pos <= q_pos + (skv - sq), as in the JAX package's
``ref.attention_ref``; at sq == skv it is the Pallas kernel's mask.
``kernels/ops.py`` chooses between them. ``flash_attention_backward_plain``
is the gradient of that function, in plain PyTorch, for both.

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
BWD_BLOCK_Q = 256        # query rows a step of the plain backward: its float32
                         # (b, h, 256, skv) P, dP and dS are 268 MB each at
                         # yi-6b's training shape (b 2, h 32, skv 4096)


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


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, causal: bool = True,
                                   scale: float | None = None,
                                   block_q: int = BWD_BLOCK_Q):
    """The gradient of the kernels' function: (dq, dk, dv) for the output
    `o` and its cotangent `do`, in the dtypes of q, k and v.

    Blockwise over query blocks of `block_q` rows: each block recomputes
    its scores from q and k in float32 (the full (b, h, s, s) score matrix
    is never held), takes P by a float32 softmax over the keys the block
    can see (a causal block stops at its last row's diagonal), and with
    D = rowsum(do * o) forms dS = P (dO V^T - D); then dq = dS K scale,
    dk += dS^T Q scale, dv += P^T dO, dk and dv summed over each kv head's
    query heads (query head i reads kv head i // (h // g)). Products and
    sums in float32. It replaces no TPU kernel: the JAX package
    differentiates its blockwise attention by autodiff."""
    with torch.profiler.record_function("flash_attention_backward"):
        b, sq, h, e = q.shape
        skv, g = k.shape[1], k.shape[2]
        r = h // g
        scale = scale or e ** -0.5
        kf, vf = k.float(), v.float()
        dq = torch.empty_like(q)
        dk = torch.zeros((b, skv, g, e), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for i0 in range(0, sq, block_q):
            i1 = min(i0 + block_q, sq)
            n = min(skv, i1 + skv - sq) if causal else skv
            split = lambda t: t[:, i0:i1].float().reshape(b, i1 - i0, g, r, e)
            qb, ob, dob = split(q), split(o), split(do)
            kb, vb = kf[:, :n], vf[:, :n]
            s = torch.einsum("bqgre,bkge->bgrqk", qb, kb)
            s.mul_(scale)
            if causal:
                keep = torch.ones((i1 - i0, n), dtype=torch.bool,
                                  device=q.device).tril(i0 + skv - sq)
                s.masked_fill_(~keep, NEG)
            p = torch.softmax(s, dim=-1)
            del s
            dd = (dob * ob).sum(-1).permute(0, 2, 3, 1)      # (b, g, r, bq)
            ds = torch.einsum("bqgre,bkge->bgrqk", dob, vb)
            ds.sub_(dd[..., None]).mul_(p)
            dq[:, i0:i1] = (torch.einsum("bgrqk,bkge->bqgre", ds, kb)
                            .mul_(scale).reshape(b, i1 - i0, h, e))
            dk[:, :n] += torch.einsum("bgrqk,bqgre->bkge", ds, qb).mul_(scale)
            dv[:, :n] += torch.einsum("bgrqk,bqgre->bkge", p, dob)
        return dq, dk.to(k.dtype), dv.to(v.dtype)


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
