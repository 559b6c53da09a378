"""The relative-position-bias ViT (timm's
``vit_relpos_medium_patch16_cls_224``).

The port of the JAX package's ``models/relpos_vit.py``: a BEiT-style
learned relative position bias in every block instead of an absolute
positional embedding. Each block holds a table of
``(2 gh - 1)(2 gw - 1) + 3`` rows by heads (the 3 extra rows: class token
to patch, patch to class token, class token to itself;
``build_relpos_index``); the table, gathered into ``[1, H, N, N]``, is an
additive mask of the block's attention. An external mask is what the fused
kernel refuses (``ops/fused_attention.py:fused_attention_compatible``), so
this tower's attention takes the plain path, as the JAX tower's does, and
launches no kernel. Pre-LN blocks without a QKV bias (LayerNorm eps 1e-6),
a biased patch embedding, class-token pooling after ``ln_post`` and a
bias-free projection.

Parameter names are the standard ViT's under ``visual.``
(``conv1.weight``/``bias``, ``class_embedding``,
``transformer.resblocks.{i}.{ln_1, attn, ln_2, mlp}``, ``ln_post``,
``proj`` [width, out]), plus ``transformer.resblocks.{i}.
relative_position_bias_table``; ``models/convert.py`` writes them from the
JAX tree. No published checkpoint exists for this tower. Under a model
group (``parallel/tensor.py:shard_module``) each block's attention runs this
rank's heads and its MLP its columns, and the bias takes this rank's heads'
columns of the whole table (``model_slice``: the table stays whole on every
rank, as ``_param_spec`` places it, and its gradient is the whole one).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.tensor import model_slice
from .layers import MLP, LayerNorm, MultiheadAttention, gelu
from .transformer import run_blocks, saved_ops


def build_relpos_index(grid: Tuple[int, int], prefix_tokens: int = 1) -> np.ndarray:
    """[N + p, N + p] row indices into the bias table (the BEiT scheme;
    ``tpu/models/relpos_vit.py:build_relpos_index``)."""
    h, w = grid
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    idx = rel.sum(-1)  # [N, N] in [0, (2h-1)(2w-1))
    if not prefix_tokens:
        return idx
    num = (2 * h - 1) * (2 * w - 1)
    n = idx.shape[0]
    full = np.zeros((n + 1, n + 1), np.int64)
    full[1:, 1:] = idx
    full[0, 1:] = num      # class token -> patch
    full[1:, 0] = num + 1  # patch -> class token
    full[0, 0] = num + 2   # class token -> itself
    return full


class RelPosBlock(nn.Module):
    """A pre-LN block whose attention adds this block's relative position
    bias; under a model group (``tp``) that of this rank's heads."""

    tp = None

    def __init__(self, width: int, heads: int, grid: Tuple[int, int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, norm_eps: float = 1e-6, act: Callable = gelu,
                 attn_impl: str = "auto"):
        super().__init__()
        self.heads = heads
        entries = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(entries, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(build_relpos_index(grid).reshape(-1)),
                             persistent=False)
        self.ln_1 = LayerNorm(width, norm_eps)
        self.attn = MultiheadAttention(width, heads, attn_impl, qkv_bias)
        self.ln_2 = LayerNorm(width, norm_eps)
        self.mlp = MLP(width, int(width * mlp_ratio), act)

    def bias(self) -> torch.Tensor:
        """The additive mask [1, H, N, N] of this rank's H heads, fp32."""
        n = int(round(self.relative_position_index.numel() ** 0.5))
        table = model_slice(self.relative_position_bias_table, 1, self.tp)
        return table[self.relative_position_index].reshape(n, n, -1).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask=self.bias())
        return x + self.mlp(self.ln_2(x))


class RelPosTransformer(nn.Module):
    """The blocks, each recomputed in the backward under ``remat_policy``
    where ``grad_checkpointing`` is on (training under autograd)."""

    def __init__(self, blocks, grad_checkpointing: bool = False, remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.resblocks = nn.ModuleList(blocks)
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        return run_blocks(self.resblocks, x, remat, self.remat_policy)


class RelPosVisionTower(nn.Module):
    """``tpu/models/relpos_vit.py:RelPosVisionTower``: patch embedding, the
    class token, the relative-position blocks, ``ln_post``, the class
    token's row through the bias-free projection."""

    patch_dropout = None

    def __init__(self, width: int, layers: int, heads: int, patch_size: int, image_size: int,
                 output_dim: int, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 norm_eps: float = 1e-6, output_tokens: bool = False, act: Callable = gelu,
                 attn_impl: str = "auto", compute_dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.image_size = (image_size, image_size)
        self.patch_size = (patch_size, patch_size)
        self.grid_size = (image_size // patch_size,) * 2
        self.width, self.heads = width, heads
        self.compute_dtype = compute_dtype
        self.output_tokens = output_tokens
        self.conv1 = nn.Conv2d(3, width, kernel_size=patch_size, stride=patch_size, bias=True)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.transformer = RelPosTransformer(
            [RelPosBlock(width, heads, self.grid_size, mlp_ratio, qkv_bias, norm_eps, act,
                         attn_impl) for _ in range(layers)],
            grad_checkpointing, remat_policy)
        self.ln_post = LayerNorm(width, norm_eps)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """JAX's initialisers for the tower's own tensors (the blocks' layers
        take ``models/clip.py:init_weights``' rules): the patch kernel
        normal(fan_in^-1/2) and a zero bias, the class token normal(1e-6),
        the bias tables normal(0.02), the projection normal(width^-1/2)."""
        normal_(self.conv1.weight, self.conv1.weight[0].numel() ** -0.5)
        self.conv1.bias.zero_()
        normal_(self.class_embedding, 1e-6)
        for blk in self.transformer.resblocks:
            normal_(blk.relative_position_bias_table, 0.02)
        normal_(self.proj, self.width ** -0.5)

    def forward(self, x: torch.Tensor,
                patch_dropout_generator: Optional[torch.Generator] = None):
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # accept NCHW at the boundary
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(f"expected {self.image_size} images, got {tuple(x.shape)}")
        dtype = self.compute_dtype
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid_size, self.patch_size
        patches = x.to(dtype).reshape(b, gh, ph, gw, pw, 3).permute(0, 1, 3, 5, 2, 4)
        x = patches.reshape(b, gh * gw, 3 * ph * pw) @ self.conv1.weight.to(dtype).reshape(
            self.width, -1).t() + self.conv1.bias.to(dtype)
        x = torch.cat([self.class_embedding.to(dtype).expand(b, 1, -1), x], dim=1)
        x = self.ln_post(self.transformer(x))
        pooled = x[:, 0] @ self.proj.to(dtype)
        return (pooled, x[:, 1:]) if self.output_tokens else pooled
