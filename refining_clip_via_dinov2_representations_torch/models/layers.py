"""Core layers of the CLIP towers, as ``nn.Module``s.

The port of the JAX package's ``models/layers.py``. Numerics kept:

* LayerNorm statistics are computed in fp32 and cast back to the input
  dtype; eps 1e-5.
* QuickGELU is ``x * sigmoid(1.702 x)``; GELU is the erf form in fp32 and the
  tanh form in bf16, as in the JAX package.
* Attention projections use the fused-QKV parameter layout of open_clip
  (``in_proj_weight`` [3D, D]), the transpose of the JAX ``in_proj_kernel``.

Parameters stay fp32; each layer casts them to the dtype of its input, so a
model computes in the dtype its input arrives in.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # erf form in fp32; tanh form under bf16 (the JAX package's choice: its
    # error sits below bf16 rounding)
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, cast back to the input dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), 1e-5)
        return y.to(x.dtype)


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class MultiheadAttention(nn.Module):
    """Fused-QKV multi-head self-attention (full-sequence mode).

    ``in_proj_weight`` is [3D, D] as in torch's ``nn.MultiheadAttention``;
    ``out_proj`` is a Linear. The attention core is ``multi_head_attention``
    with this layer's ``attn_impl``.
    """

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, l, d = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        # [B, L, 3, H, Dh] -> three contiguous [B, H, L, Dh] tensors
        q, k, v = qkv.view(b, l, 3, self.num_heads, d // self.num_heads).permute(
            2, 0, 3, 1, 4).contiguous().unbind(0)
        out = multi_head_attention(q, k, v, causal=causal, impl=self.attn_impl)
        return _linear(out.transpose(1, 2).reshape(b, l, d), self.out_proj)


class MLP(nn.Module):
    """Transformer MLP: c_fc -> act -> c_proj."""

    def __init__(self, dim: int, hidden_dim: int, act: Callable = gelu):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.act = act
        self.c_proj = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.act(_linear(x, self.c_fc)), self.c_proj)
