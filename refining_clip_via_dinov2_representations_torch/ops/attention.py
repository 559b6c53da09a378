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
* ``impl="xla_bf16_bwd"`` — not ported yet: it raises
  ``NotImplementedError`` on CUDA tensors and takes the plain path on CPU
  tensors (its forward computes the same function).

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
        impl = "flash"  # long-sequence fallback

    if impl == "flash":
        if flash_attention_compatible(q, k, v, mask):
            return flash_mha(q, k, v, mask=None, causal=causal, scale=scale)
        impl = "xla"

    if impl == "xla_bf16_bwd" and q.is_cuda:
        raise NotImplementedError(
            "attention impl 'xla_bf16_bwd' has no CUDA version yet (ROADMAP Queue 1); "
            "use 'fused', 'flash' or 'xla'"
        )

    if causal and mask is None:
        mask = torch.full((q.shape[-2], k.shape[-2]), float("-inf"), device=q.device).triu(1)
    return dot_product_attention_xla(q, k, v, mask=mask, scale=scale)
