"""Fused short-sequence attention: the Hopper kernels and their plain versions.

The port of the TPU Pallas kernels in
``refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py``:
``_fwd_kernel`` (launched by ``_fused_fwd``) and ``_bwd_kernel`` (launched by
``_fused_bwd``, the VJP of ``fused_attention``). At CLIP sequence lengths (77
text tokens, 197 ViT-B/16 tokens) scores, softmax and the products run inside
the kernels and only the inputs, the outputs and (backward) three fp32 row
statistics touch device memory. The CUDA sources are
``csrc/fused_attention_fwd.cu`` and ``csrc/fused_attention_bwd.cu``; their
headers state what bounds them on an H100 and how their designs answer that.

Numerics, as the TPU kernels. Forward: scores and softmax in fp32; a causal
mask sets col > row to the fp32 minimum; the normalised probabilities are
cast to V's dtype before the PV product, which accumulates in fp32; the
output is in the input dtype. Backward: P is recomputed in fp32; dV uses P
and dO cast to V's dtype; delta = rowsum(dO * O) in fp32 from the stored O;
dS = P * (dP - delta) is cast to q's dtype; dQ and dK are scaled after their
fp32 sums; each gradient is in its input's dtype.

Routes on the card, chosen by dtype and head dim; nothing falls back:

* bf16: tensor cores (``mma.sync`` m16n8k16, ``csrc/attention_mma.cuh``),
  forward at every head dim, backward up to head dim 128; the scalar
  backward kernels past it.
* fp32 (serving, and training at ``--precision amp`` / ``fp32``): tensor
  cores up to head dim 128, forward and backward, with split-TF32 products
  (``mma.sync`` m16n8k8, ``csrc/attention_tf32.cuh``): each operand is
  split as hi + lo TF32 values and each product accumulates
  lo·hi + hi·lo + hi·hi in fp32, which keeps fp32 accuracy (within 1e-4 of
  the plain version; a single TF32 product misses that). The kernels split
  whatever ``torch.backends.cuda.matmul.allow_tf32`` says. Past head dim 128
  (no registry model has such heads) the scalar CUDA-core kernels. In fp32
  the cast of P to V's dtype is the identity, so the fp32 forward takes one
  online-softmax pass and divides after P V, the same function up to fp32
  rounding; the bf16 forward keeps two passes.

``fused_attention`` is a ``torch.autograd.Function`` over the two: the
forward saves q, k, v and o (as the JAX VJP's residuals) and the backward
runs the backward kernel. CPU tensors take the plain versions in both
directions; CUDA tensors launch the kernel their dtype and shape route to,
or raise.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import native

MAX_FUSED_SEQ = 1024
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _causal_scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        lq, lk = s.shape[-2:]
        above = torch.ones(lq, lk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, torch.finfo(torch.float32).min)
    return s


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel. q,k,v: [B,H,L,D]."""
    p = torch.softmax(_causal_scores(q, k, scale, causal), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, scale: float, causal: bool = False,
):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) from the
    residuals q, k, v, o and the cotangent do, with ``_bwd_kernel``'s
    rounding points."""
    p = torch.softmax(_causal_scores(q, k, scale, causal), dim=-1)
    do_v = do.float().to(v.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do_v)
    dp = torch.matmul(do_v, v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention_compatible(q, k, v, mask) -> bool:
    """Kernel applicability: no external additive mask (causal is handled
    in-kernel), head_dim <= 256, both sequence lengths <= 1024."""
    if mask is not None:
        return False
    if q.shape[-2] > MAX_FUSED_SEQ or k.shape[-2] > MAX_FUSED_SEQ:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM


def _library(source: str, fn_name: str, n_pointers: int) -> ctypes.CDLL:
    lib = native.load(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_pointers + [i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{fn_name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _check_inputs(name: str, q, k, v, *same_as_q) -> None:
    """What every kernel wrapper takes: one CUDA device, one dtype of
    float32 or bfloat16, q [B,H,Lq,D] and k = v [B,H,Lk,D], no empty axis,
    contiguous memory."""
    tensors = (q, k, v, *same_as_q)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(
            f"{name}: inputs must share one CUDA device (got "
            f"{', '.join(str(t.device) for t in tensors)})"
        )
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            f"{name}: float32 or bfloat16 inputs of one dtype (got "
            f"{', '.join(str(t.dtype) for t in tensors)})"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,H,Lq,D], k=v [B,H,Lk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or head_dim")
    if any(t.shape != q.shape for t in same_as_q):
        raise ValueError(f"{name}: o and do must have q's shape {tuple(q.shape)}")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check(q, k, v, *same_as_q) -> None:
    _check_inputs("fused_attention", q, k, v, *same_as_q)
    if not fused_attention_compatible(q, k, v, None):
        raise ValueError(f"fused_attention: shapes {tuple(q.shape)}/{tuple(k.shape)} "
                         f"exceed L <= {MAX_FUSED_SEQ}, D <= {MAX_HEAD_DIM}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _raise_on(lib, fn_name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{fn_name}_error_string")(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = False) -> torch.Tensor:
    """The forward kernel, launched on the calling thread's current stream.
    CPU tensors take the plain version. ``fused_attention_fwd.launches``
    counts the kernel's launches."""
    if _on_cpu(q, k, v):
        return fused_attention_reference(q, k, v, scale, causal)
    _check(q, k, v)
    lib = _library("fused_attention_fwd.cu", "fused_attention_fwd", 4)
    out = torch.empty_like(q)
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, lq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(lib, "fused_attention_fwd", err)
    with _count_lock:
        fused_attention_fwd.launches += 1
    return out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, scale: float,
                        causal: bool = False):
    """The backward kernel -> (dq, dk, dv), launched on the calling thread's
    current stream (autograd runs a CUDA backward on its own thread, with the
    forward's stream current). CPU tensors take the plain version.
    ``fused_attention_bwd.launches`` counts the kernel's launches."""
    if _on_cpu(q, k, v, o, do):
        return fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    _check(q, k, v, o, do)
    lib = _library("fused_attention_bwd.cu", "fused_attention_bwd", 9)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    b, h, lq, d = q.shape
    stats = torch.empty(3 * b * h * lq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b * h, lq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(lib, "fused_attention_bwd", err)
    with _count_lock:
        fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_fwd.launches = 0
fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o = fused_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        # MultiheadAttention's transpose + reshape hands back a strided view
        do = do.contiguous()
        dq, dk, dv = fused_attention_bwd(q, k, v, o, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Fused attention, differentiable. q,k,v: [B,H,L,D]; returns [B,H,Lq,D].

    CPU tensors take the plain versions; CUDA tensors launch the forward
    kernel and, under autograd, the backward kernel, or raise."""
    return _FusedAttention.apply(q, k, v, float(scale), bool(causal))
