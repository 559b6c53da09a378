"""Core layers of the CLIP towers, as ``nn.Module``s.

The port of the JAX package's ``models/layers.py``. Numerics kept:

* LayerNorm statistics are computed in fp32 and cast back to the input
  dtype; eps 1e-5 (DINOv2 passes 1e-6).
* QuickGELU is ``x * sigmoid(1.702 x)``; GELU is the erf form in fp32 and the
  tanh form in bf16, as in the JAX package.
* Attention projections use the fused-QKV parameter layout of open_clip
  (``in_proj_weight`` [3D, D]), the transpose of the JAX ``in_proj_kernel``.
* PatchDropout keeps ``max(1, int(n * (1 - prob)))`` patch tokens (CLS
  kept): the first of ``argsort(scores)`` (stable) for uniform scores.

Parameters stay fp32; each layer casts them to the dtype of its input, so a
model computes in the dtype its input arrives in.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import column_linear, copy_to_model, row_linear


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

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def patch_dropout_keep(x: torch.Tensor, scores: torch.Tensor, prob: float,
                       exclude_first_token: bool = True) -> torch.Tensor:
    """The tokens PatchDropout keeps for per-example ``scores`` [B, n] (n the
    patch tokens): the first token (CLS) when excluded, then the patch
    tokens at ``argsort(scores)[:, :num_keep]`` in that order, as the JAX
    ``PatchDropout`` takes them."""
    if exclude_first_token:
        cls_tok, rest = x[:, :1], x[:, 1:]
    else:
        cls_tok, rest = x[:, :0], x
    b, n, d = rest.shape
    num_keep = max(1, int(n * (1.0 - prob)))
    keep = torch.argsort(scores, dim=-1, stable=True)[:, :num_keep]
    rest = torch.gather(rest, 1, keep.unsqueeze(-1).expand(b, num_keep, d))
    return torch.cat([cls_tok, rest], dim=1)


class PatchDropout(nn.Module):
    """Token subsampling in training (open_clip ``transformer.py:50-87``).

    Draws uniform scores from the explicit ``generator`` it is given (on the
    tokens' device) and keeps ``patch_dropout_keep``'s tokens. The identity
    in eval mode, at ``prob`` 0, and without a generator (the JAX module's
    ``deterministic`` default: a caller that passes no generator asks for
    no draw, as the evaluations do)."""

    def __init__(self, prob: float = 0.5, exclude_first_token: bool = True):
        super().__init__()
        self.prob = prob
        self.exclude_first_token = exclude_first_token

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.prob == 0.0 or generator is None:
            return x
        n = x.shape[1] - (1 if self.exclude_first_token else 0)
        return patch_dropout_keep(x, self.scores(x.shape[0], n, generator, x.device), self.prob,
                                  self.exclude_first_token)

    @staticmethod
    def scores(b: int, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """Uniform [b, n] fp32 scores from ``generator`` on ``device``."""
        return torch.rand(b, n, generator=generator, device=device)


class MultiheadAttention(nn.Module):
    """Fused-QKV multi-head self-attention (full-sequence mode).

    ``in_proj_weight`` is [3D, D] as in torch's ``nn.MultiheadAttention``;
    ``out_proj`` is a Linear. The attention core is ``multi_head_attention``
    with this layer's ``attn_impl``. Under a model group (``tp``, set by
    ``parallel/tensor.py:shard_module``) the layer holds this rank's heads of
    q, k and v and its columns of ``out_proj``, and the core runs on
    ``num_heads / tp.world`` heads.
    """

    tp = None

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
        heads = self.num_heads // (self.tp.world if self.tp else 1)
        dh = d // self.num_heads
        qkv = F.linear(copy_to_model(x, self.tp), self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        # [B, L, 3, H, Dh] -> three contiguous [B, H, L, Dh] tensors
        q, k, v = qkv.view(b, l, 3, heads, dh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = multi_head_attention(q, k, v, causal=causal, impl=self.attn_impl)
        return row_linear(out.transpose(1, 2).reshape(b, l, heads * dh), self.out_proj, self.tp)


class MLP(nn.Module):
    """Transformer MLP: c_fc -> act -> c_proj; under a model group (``tp``)
    ``c_fc`` column- and ``c_proj`` row-parallel."""

    tp = None

    def __init__(self, dim: int, hidden_dim: int, act: Callable = gelu):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.act = act
        self.c_proj = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_linear(self.act(column_linear(x, self.c_fc, self.tp)), self.c_proj, self.tp)
