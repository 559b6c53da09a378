"""Multi-head attention: one dispatching entry point over the attention paths.

The port of ``refining_clip_via_dinov2_representations_tpu/ops/attention.py``.

* ``impl="xla"`` — ``dot_product_attention_xla``: plain PyTorch attention
  with an fp32 softmax. The correctness oracle and the CPU path. (The name is
  the JAX package's, kept so the two can be read side by side.)
* ``impl="fused"`` — the hand-written Hopper kernels
  (``ops/fused_attention.py``: forward, and backward under autograd)
  wherever their gate holds, else the plain path; on CPU tensors their
  plain versions, through the same autograd Function.
* ``impl="auto"`` — ``"fused"`` on a CUDA tensor wherever the gate holds,
  ``"xla"`` on a CPU tensor.
* ``impl="flash"`` / ``"xla_bf16_bwd"`` — not ported yet: they raise
  ``NotImplementedError`` on CUDA tensors and take the plain path on CPU
  tensors (their forwards compute the same function).

Layout is ``[batch, heads, seq, head_dim]`` throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

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

    if impl == "fused":
        if fused_attention_compatible(q, k, v, mask):
            if scale is None:
                scale = q.shape[-1] ** -0.5
            return fused_attention(q, k, v, float(scale), causal)
        impl = "xla"  # as the JAX package off-TPU, where its flash gate is closed

    if impl in ("flash", "xla_bf16_bwd") and q.is_cuda:
        raise NotImplementedError(
            f"attention impl {impl!r} has no CUDA kernel yet (ROADMAP Queue 2); "
            "use 'fused' or 'xla'"
        )

    if causal and mask is None:
        mask = torch.full((q.shape[-2], k.shape[-2]), float("-inf"), device=q.device).triu(1)
    return dot_product_attention_xla(q, k, v, mask=mask, scale=scale)
