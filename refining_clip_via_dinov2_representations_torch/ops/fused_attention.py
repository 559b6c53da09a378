"""Fused short-sequence attention: the Hopper kernel and its plain version.

The port of the TPU Pallas kernel in
``refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py``
(``_fwd_kernel``, launched by ``_fused_fwd``). At CLIP sequence lengths
(77 text tokens, 197 ViT-B/16 tokens) a head's whole score row fits on chip,
so scores, softmax and the PV product run in one kernel and only Q, K, V and
O touch device memory. The CUDA source is ``csrc/fused_attention_fwd.cu``;
its header states what bounds it on an H100 and how its design answers that.

Numerics, as the TPU kernel: scores and softmax in fp32; a causal mask sets
col > row to the fp32 minimum; the normalised probabilities are cast to V's
dtype before the PV product, which accumulates in fp32; the output is in the
input dtype. Forward only: the backward kernel comes with training.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import native

MAX_FUSED_SEQ = 1024
MAX_HEAD_DIM = 256
_SOURCE = "fused_attention_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics. q,k,v: [B,H,L,D]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        lq, lk = s.shape[-2:]
        above = torch.ones(lq, lk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention_compatible(q, k, v, mask) -> bool:
    """Kernel applicability: no external additive mask (causal is handled
    in-kernel), head_dim <= 256, both sequence lengths <= 1024."""
    if mask is not None:
        return False
    if q.shape[-2] > MAX_FUSED_SEQ or k.shape[-2] > MAX_FUSED_SEQ:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM


def _library() -> ctypes.CDLL:
    lib = native.load(_SOURCE)
    fn = lib.fused_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.fused_attention_error_string.argtypes = [i]
        lib.fused_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"fused_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_attention: float32 or bfloat16 q, k, v of one dtype "
            f"(got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"fused_attention: q [B,H,Lq,D], k=v [B,H,Lk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"fused_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or head_dim")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError(f"fused_attention: empty input {tuple(q.shape)}")
    if not fused_attention_compatible(q, k, v, None):
        raise ValueError(f"fused_attention: shapes {tuple(q.shape)}/{tuple(k.shape)} "
                         f"exceed L <= {MAX_FUSED_SEQ}, D <= {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention: q, k, v must be contiguous")


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Fused attention forward. q,k,v: [B,H,L,D]; returns [B,H,Lq,D].

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    calling thread's current stream, or raise. ``fused_attention.launches``
    counts the kernel launches.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale, causal)
    _check(q, k, v)
    lib = _library()
    out = torch.empty_like(q)
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, lq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        msg = lib.fused_attention_error_string(err).decode()
        raise RuntimeError(f"fused_attention_fwd launch failed: {msg} ({err})")
    with _count_lock:
        fused_attention.launches += 1
    return out


fused_attention.launches = 0
