"""Multi-head attention: one dispatching entry point over the attention paths.

The port of ``refining_clip_via_dinov2_representations_tpu/ops/attention.py``.

* ``impl="xla"`` — ``dot_product_attention_xla``: plain PyTorch attention
  with an fp32 softmax. The correctness oracle and the CPU path. (The name is
  the JAX package's, kept so the two can be read side by side.)
* ``impl="fused"`` — the hand-written Hopper kernels
  (``ops/fused_attention.py``: forward, and backward under autograd)
  wherever their gate holds (L <= 1024); where it fails, ``"flash"``, as in
  the JAX package. On CPU tensors their plain versions, through the same
  autograd Function.
* ``impl="flash"`` — the hand-written Hopper flash forward
  (``ops/flash_attention.py``; its backward recomputes through the plain
  attention, as the JAX package's) wherever its gate holds (no mask,
  head_dim <= 256, at least 512 queries), else the plain path. On CPU
  tensors its plain version, through the same autograd Function. (The JAX
  gate is closed off the TPU; the port's gate checks shapes only.)
* ``impl="auto"`` — ``"fused"`` on a CUDA tensor wherever its gate holds,
  ``"xla"`` otherwise.
* ``impl="xla_bf16_bwd"`` — ``dot_product_attention_bf16_bwd``: the plain
  forward under an autograd Function with the JAX package's custom
  backward (``tpu/ops/attention.py:64-118``): it saves P in the input
  dtype, takes the backward products in that dtype with an fp32 row sum,
  and gives a learned additive mask its cotangent. Plain PyTorch on either
  device: the JAX rule is XLA code, not a Pallas kernel.

Layout is ``[batch, heads, seq, head_dim]`` throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_compatible, flash_mha
from .fused_attention import fused_attention, fused_attention_compatible

IMPLS = ("xla", "xla_bf16_bwd", "fused", "flash", "auto")


def dot_product_attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention. q,k,v: [B,H,L,D]; mask: additive, broadcastable
    to [B,H,Lq,Lk].

    Precision: logits stay in the input dtype (fp32 in → fp32, bf16 in →
    bf16); the softmax runs in fp32 and its weights are cast back to the
    input dtype for the PV product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2))
    logits = logits * torch.tensor(scale, dtype=logits.dtype)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


class _AttentionBf16Bwd(torch.autograd.Function):
    """``dot_product_attention_xla``'s forward, saving ``(q, k, v, p, mask)``;
    the backward follows ``_attention_bf16_bwd_rule`` rounding point for
    rounding point."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float):
        logits = torch.matmul(q, k.transpose(-1, -2))
        logits = logits * torch.tensor(scale, dtype=logits.dtype)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        ctx.save_for_backward(q, k, v, p, mask)
        ctx.scale = scale
        return torch.matmul(p, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v, p, mask = ctx.saved_tensors
        do = do.to(v.dtype)
        dv = torch.matmul(p.transpose(-1, -2), do)
        dp = torch.matmul(do, v.transpose(-1, -2)).to(p.dtype)
        # softmax backward: dS = P * (dP - rowsum(P * dP)); the row sum in fp32
        r = (p.float() * dp.float()).sum(-1, keepdim=True)
        dlogits = p * (dp - r.to(p.dtype))
        ds = dlogits * torch.tensor(ctx.scale, dtype=p.dtype)
        dq = torch.matmul(ds, k)
        dk = torch.matmul(ds.transpose(-1, -2), q)
        dmask = None
        if mask is not None and ctx.needs_input_grad[3]:
            # a learned mask's cotangent: dlogits summed over the axes the
            # mask broadcasts over
            dm = dlogits.float()
            pad = dm.dim() - mask.dim()
            axes = tuple(range(pad)) + tuple(
                ax + pad for ax in range(mask.dim())
                if mask.shape[ax] == 1 and dm.shape[ax + pad] != 1)
            if axes:
                dm = dm.sum(dim=axes)
            dmask = dm.reshape(mask.shape).to(mask.dtype)
        return dq, dk, dv, dmask, None


def dot_product_attention_bf16_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``dot_product_attention_xla`` with the JAX package's bf16 custom
    backward (saved P and backward products in the input dtype)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _AttentionBf16Bwd.apply(q, k, v, mask, float(scale))


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    impl: str = "xla",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatching attention entry point.

    Args:
      q, k, v: [B, H, L, D] tensors.
      mask: optional additive mask broadcastable to [B, H, Lq, Lk]. When
        ``causal`` is set and no mask is given, the fused kernel applies the
        causal rule itself; the plain path builds the mask.
      impl: "xla" | "xla_bf16_bwd" | "fused" | "flash" | "auto".
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        fused_ok = q.is_cuda and fused_attention_compatible(q, k, v, mask)
        impl = "fused" if fused_ok else "xla"

    if impl == "xla_bf16_bwd":
        return dot_product_attention_bf16_bwd(q, k, v, mask=_causal_mask(q, k, causal, mask),
                                              scale=scale)

    if impl == "fused":
        if fused_attention_compatible(q, k, v, mask):
            if scale is None:
                scale = q.shape[-1] ** -0.5
            return fused_attention(q, k, v, float(scale), causal)
        impl = "flash"  # long-sequence fallback

    if impl == "flash":
        if flash_attention_compatible(q, k, v, mask):
            return flash_mha(q, k, v, mask=None, causal=causal, scale=scale)
        impl = "xla"

    return dot_product_attention_xla(q, k, v, mask=_causal_mask(q, k, causal, mask), scale=scale)


def _causal_mask(q, k, causal: bool, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The -inf-above-the-diagonal mask the plain paths add when ``causal``
    is set and no mask is given; else ``mask``."""
    if causal and mask is None:
        return torch.full((q.shape[-2], k.shape[-2]), float("-inf"), device=q.device).triu(1)
    return mask
