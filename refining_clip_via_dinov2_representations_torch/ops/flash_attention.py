"""Blockwise flash attention: the Hopper kernel and its plain version.

The port of ``refining_clip_via_dinov2_representations_tpu/ops/flash_attention.py``:
``_flash_fwd_kernel`` (launched by ``_flash_forward``), an online-softmax
forward whose memory does not grow with the sequence length. The CUDA source
is ``csrc/flash_attention_fwd.cu``; its header states what bounds it on an
H100 and how its design answers that. The route that runs, by dtype and
head dim:

* bf16: ``flash_attention_fwd_mma_kernel``, tensor cores (``mma.sync``),
  every head dim up to 256;
* fp32 up to head dim 128: ``flash_attention_fwd_tf32_kernel``, tensor cores
  with split-TF32 products (each fp32 operand as hi + lo, three TF32
  products a product), which keep fp32 accuracy; its body is the fused
  kernel's fp32 forward (``csrc/attention_fwd_tf32.cuh``) with Q scaled in
  fp32 where its tile lands;
* fp32 past head dim 128 (no registry model): the scalar kernel
  ``flash_attention_fwd_kernel<float, 256>``.

Numerics, as the TPU kernel:

* Q is pre-scaled in the input dtype (``q * scale``, the scale itself rounded
  to that dtype first);
* S = Q K^T with fp32 accumulation; padded keys and, when causal, keys past
  the query's index are set to -1e30;
* a running max m and sum l in fp32; ``p = exp(s - m)`` in fp32 feeds l,
  and p cast to V's dtype feeds the fp32 accumulator of P V;
* the output is ``acc / max(l, 1e-30)``, cast to the input dtype: it is
  normalised after the PV product (the fused kernel normalises before).

The backward is not a kernel in the JAX package either: ``_flash_bwd_rule``
recomputes attention through the plain ``dot_product_attention_xla`` and
takes its VJP. ``_FlashAttention`` does the same. CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_attention import (
    _DTYPE_CODES, _check_inputs, _count_lock, _library, _on_cpu, _raise_on,
)

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MIN_FLASH_SEQ = 512
# the CUDA grid's second dimension counts query tiles (at most 65535): 64
# rows in the tensor-core kernels (bf16, and fp32 up to head dim 128), 32 in
# the scalar fp32 kernel past head dim 128
MAX_QUERY_LEN = 65535 * 64
MAX_QUERY_LEN_SCALAR = 65535 * 32


def max_query_len(dtype: torch.dtype, head_dim: int) -> int:
    """The longest query the route that runs for ``dtype`` and ``head_dim``
    can take."""
    return MAX_QUERY_LEN_SCALAR if dtype == torch.float32 and head_dim > 128 else MAX_QUERY_LEN


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, one full-row softmax
    relative to the row max. q: [B,H,Lq,D]; k, v: [B,H,Lk,D]."""
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        lq, lk = s.shape[-2:]
        above = torch.ones(lq, lk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def flash_attention_compatible(q, k, v, mask) -> bool:
    """Kernel applicability, by shape alone (the JAX gate without its TPU
    check): no external mask (causal is handled in-kernel), head_dim <= 256,
    at least 512 queries. There is no upper bound on the length."""
    if mask is not None:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM and q.shape[-2] >= MIN_FLASH_SEQ


def _check(q, k, v) -> None:
    _check_inputs("flash_attention", q, k, v)
    d = q.shape[3]
    if d > MAX_HEAD_DIM or q.shape[2] > max_query_len(q.dtype, d):
        raise ValueError(f"flash_attention: {tuple(q.shape)} exceeds D <= {MAX_HEAD_DIM}, "
                         f"Lq <= {max_query_len(q.dtype, d)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = False) -> torch.Tensor:
    """The forward kernel, launched on the calling thread's current stream.
    Any Lq, Lk >= 1 and head_dim <= 256; CPU tensors take the plain version.
    ``flash_attention_fwd.launches`` counts the kernel's launches."""
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, scale, causal)
    _check(q, k, v)
    lib = _library("flash_attention_fwd.cu", "flash_attention_fwd", 4)
    out = torch.empty_like(q)
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, lq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream,
        )
    _raise_on(lib, "flash_attention_fwd", err)
    with _count_lock:
        flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def _causal_mask(lq: int, lk: int, device) -> torch.Tensor:
    return torch.full((lq, lk), float("-inf"), device=device).triu(1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.save_for_backward(q, k, v)  # the JAX VJP's residuals
        ctx.scale, ctx.causal = scale, causal
        return flash_attention_fwd(q, k, v, scale, causal)

    @staticmethod
    def backward(ctx, do):
        # _flash_bwd_rule: the VJP of the plain attention, recomputed
        from .attention import dot_product_attention_xla

        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        mask = _causal_mask(q.shape[-2], k.shape[-2], q.device) if ctx.causal else None
        with torch.enable_grad():
            out = dot_product_attention_xla(q, k, v, mask=mask, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention, differentiable. q: [B,H,Lq,D]; k, v: [B,H,Lk,D]."""
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """[B,H,L,D] flash attention with the JAX signature. ``mask`` must be
    None (``causal`` covers the text tower). ``block_q`` and ``block_k`` are
    accepted for that signature and unused: the CUDA kernel picks its own
    tiles, which change the TPU kernel's result only by rounding."""
    if mask is not None:
        raise ValueError("flash kernel handles mask=None/causal only")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention(q, k, v, scale, causal)
