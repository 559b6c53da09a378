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
* ``MultiheadAttention`` has the JAX module's cross-attention and decode
  modes; ``AttentionalPooler`` (CoCa) keeps open_clip's parameter names.

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
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


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
    """Fused-QKV multi-head attention, in the JAX module's modes.

    ``in_proj_weight`` is [3D, D] as in torch's ``nn.MultiheadAttention``;
    ``out_proj`` is a Linear. Under a model group (``tp``, set by
    ``parallel/tensor.py:shard_module``) the layer holds this rank's heads of
    q, k and v and its columns of ``out_proj``, and the core runs on
    ``num_heads / tp.world`` heads. The modes of ``forward``
    (``tpu/models/layers.py:131-250``):

    * full self-attention (no ``kv``): one product for q, k and v, then
      ``multi_head_attention`` with this layer's ``attn_impl``, ``mask`` and
      ``causal``;
    * full cross-attention (``kv`` given, the CoCa decoder): q from ``x``,
      k and v from ``kv`` through the thirds of the same weight, then the
      same dispatch, so Lq != Lk reaches the fused kernel;
    * ``return_kv``: only the head-split (k, v) of ``kv``, for reuse over a
      generation;
    * ``static_kv=(k, v)``: ``x``'s queries over such a pair;
    * ``cache=(k, v)`` [B, H, L, Dh] with ``pos``: one token's decode step;
      its k and v are written into the cache at ``pos`` (in place) and the
      query attends over positions ``<= pos``. Returns ``(out, cache)``.

    The last two take plain attention only because the JAX package routes
    them there (``impl="xla"``, ``tpu/models/layers.py:209-243``): a decode
    step launches no kernel. Without ``qkv_bias`` (the timm GAP and relpos
    ViTs) the layer has no ``in_proj_bias``, as the JAX module has none.
    """

    tp = None

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto",
                 qkv_bias: bool = True):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim)) if qkv_bias else None
        self.out_proj = nn.Linear(dim, dim)

    def _bias(self, x: torch.Tensor, part: Optional[int] = None) -> Optional[torch.Tensor]:
        """``in_proj_bias`` (its q, k or v third) in ``x``'s dtype, or None."""
        if self.in_proj_bias is None:
            return None
        b = self.in_proj_bias if part is None else self.in_proj_bias.chunk(3)[part]
        return b.to(x.dtype)

    def _project(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """[B, L, D] -> this rank's heads of q (0), k (1) or v (2), [B, H, L, Dh],
        contiguous (as the kernels take them)."""
        b, l, _ = x.shape
        n = self.in_proj_weight.shape[0] // 3
        heads = self.num_heads // (self.tp.world if self.tp else 1)
        w = self.in_proj_weight[part * n:(part + 1) * n].to(x.dtype)
        y = F.linear(x, w, self._bias(x, part))
        return y.view(b, l, heads, n // heads).transpose(1, 2).contiguous()

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        b, h, l, dh = out.shape
        return row_linear(out.transpose(1, 2).reshape(b, l, h * dh), self.out_proj, self.tp)

    def forward(self, x: torch.Tensor, causal: bool = False, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, cache=None, pos: Optional[int] = None,
                static_kv=None, return_kv: bool = False):
        x = copy_to_model(x, self.tp)
        if kv is not None:
            kv = copy_to_model(kv, self.tp)
        if return_kv:
            return self._project(kv, 1), self._project(kv, 2)
        if static_kv is not None:
            out = multi_head_attention(self._project(x, 0), static_kv[0], static_kv[1],
                                       mask=mask, impl="xla")
            return self._out(out)
        if cache is not None:
            if x.shape[1] != 1 or pos is None:
                raise ValueError("decode mode takes one token and its position")
            ck, cv = cache
            ck[:, :, pos:pos + 1] = self._project(x, 1)
            cv[:, :, pos:pos + 1] = self._project(x, 2)
            # additive key mask: only positions <= pos are live
            key_mask = torch.zeros(ck.shape[2], device=x.device)
            key_mask[pos + 1:] = float("-inf")
            out = multi_head_attention(self._project(x, 0), ck, cv, mask=key_mask, impl="xla")
            return self._out(out), (ck, cv)
        if kv is not None:
            q, k, v = self._project(x, 0), self._project(kv, 1), self._project(kv, 2)
        else:
            b, l, d = x.shape
            heads = self.num_heads // (self.tp.world if self.tp else 1)
            dh = d // self.num_heads
            qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self._bias(x))
            # [B, L, 3, H, Dh] -> three contiguous [B, H, L, Dh] tensors
            q, k, v = qkv.view(b, l, 3, heads, dh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return self._out(multi_head_attention(q, k, v, mask=mask, causal=causal,
                                              impl=self.attn_impl))


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


class PoolerAttention(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention(d_model, n_head,
    kdim=context_dim, vdim=context_dim)``, open_clip's pooler attention,
    under its names: one ``in_proj_weight`` [3D, D] where the context is as
    wide as ``d_model``, else ``q_proj_weight`` [D, D] and
    ``k_proj_weight``/``v_proj_weight`` [D, context_dim]; ``in_proj_bias``
    [3D]; ``out_proj``."""

    def __init__(self, d_model: int, context_dim: int, n_head: int):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"width {d_model} is not divisible by {n_head} heads")
        self.num_heads = n_head
        if context_dim == d_model:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(d_model, d_model))
            self.k_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
            self.v_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def weights(self):
        """(q, k, v) projection weights, [D, D], [D, C], [D, C]."""
        if hasattr(self, "in_proj_weight"):
            return self.in_proj_weight.chunk(3)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight


class AttentionalPooler(nn.Module):
    """Learned-query cross-attention pooler (open_clip ``transformer.py:
    194-216``; ``tpu/models/layers.py:268-306``): ``n_queries`` learned
    queries through ``ln_q`` attend over ``ln_k`` of the context with
    separate q, k and v projections (the context may be wider than
    ``d_model``), through the plain attention, as the JAX module calls it."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256):
        super().__init__()
        self.query = nn.Parameter(torch.zeros(n_queries, d_model))
        self.attn = PoolerAttention(d_model, context_dim, n_head)
        self.ln_q = LayerNorm(d_model)
        self.ln_k = LayerNorm(context_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        nq, d = self.query.shape
        h = self.attn.num_heads
        x = self.ln_k(x)
        q = self.ln_q(self.query.to(x.dtype).expand(b, nq, d))
        wq, wk, wv = (w.to(x.dtype) for w in self.attn.weights())
        bq, bk, bv = self.attn.in_proj_bias.to(x.dtype).chunk(3)

        def heads(t, n):
            return t.view(b, n, h, d // h).transpose(1, 2)

        out = multi_head_attention(heads(F.linear(q, wq, bq), nq), heads(F.linear(x, wk, bk), l),
                                   heads(F.linear(x, wv, bv), l))
        return _linear(out.transpose(1, 2).reshape(b, nq, d), self.attn.out_proj)
