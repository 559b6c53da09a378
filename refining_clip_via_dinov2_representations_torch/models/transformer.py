"""Transformer towers: the vision ViT and the causal text transformer.

The port of the JAX package's ``models/transformer.py`` for the standard
CLIP: the ViT with a class token, learnable positional embedding and 'tok'
pooling, and the causal text transformer with argmax-EOT pooling. (The CoCa
decoder, KV-cache decode and the CLIPA/timm variants come later.) Parameter
names are open_clip's, so ``models/convert.py`` output loads with
``strict=True``.

Images are NHWC at the public boundary, as in the JAX package (NCHW is
accepted too and transposed once). The patch embedding, a convolution with
kernel = stride = patch, runs as a reshape and one matmul over the
``conv1.weight`` [width, 3, ph, pw] parameter: in fp32 that keeps it off
cuDNN's TF32 convolutions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import MLP, LayerNorm, LayerScale, MultiheadAttention, gelu


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: ``x + ls_1(attn(ln_1(x)))`` then ``x + ls_2(mlp(ln_2(x)))``."""

    def __init__(self, width: int, n_head: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, act: Callable = gelu,
                 attn_impl: str = "auto"):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, n_head, attn_impl)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, int(width * mlp_ratio), act)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width, ls_init_value)
            self.ls_2 = LayerScale(width, ls_init_value)
        else:
            self.ls_1 = self.ls_2 = None

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        attn_out = self.attn(self.ln_1(x), causal=causal)
        if self.ls_1 is not None:
            attn_out = self.ls_1(attn_out)
        x = x + attn_out
        mlp_out = self.mlp(self.ln_2(x))
        if self.ls_2 is not None:
            mlp_out = self.ls_2(mlp_out)
        return x + mlp_out


class Transformer(nn.Module):
    """A stack of residual blocks. With ``grad_checkpointing`` on, a module
    in training under autograd runs each block under
    ``torch.utils.checkpoint`` (non-reentrant): only the block's input is
    kept and the block is recomputed in the backward, as the JAX package's
    ``nn.remat`` with its default ("full") policy."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, act: Callable = gelu,
                 attn_impl: str = "auto", grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, ls_init_value, act, attn_impl)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        for blk in self.resblocks:
            if remat:
                x = checkpoint(blk, x, causal, use_reentrant=False)
            else:
                x = blk(x, causal=causal)
        return x


def text_global_pool(x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """Argmax-EOT pooling: each sequence's features at its highest token id,
    the EOT (the first one on ties, so all-zero padding rows pool at
    position 0). The only text pooling the port builds."""
    return x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]


class VisionTransformer(nn.Module):
    """ViT tower: patch embed, CLS + learnable positional embedding, ln_pre,
    transformer, ln_post on the CLS token, projection."""

    def __init__(self, image_size: Tuple[int, int] = (224, 224),
                 patch_size: Tuple[int, int] = (16, 16), width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, output_dim: int = 512,
                 act: Callable = gelu, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False):
        super().__init__()
        self.image_size = tuple(image_size)
        self.patch_size = tuple(patch_size)
        self.grid_size = (image_size[0] // patch_size[0], image_size[1] // patch_size[1])
        self.width = width
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, width, kernel_size=self.patch_size,
                               stride=self.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        n_pos = self.grid_size[0] * self.grid_size[1] + 1
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       act, attn_impl, grad_checkpointing)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, gh*gw, width], the stride-patch convolution
        as a matmul over (channel, row, col)-ordered patches."""
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid_size, self.patch_size
        patches = x.reshape(b, gh, ph, gw, pw, 3).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, gh * gw, 3 * ph * pw)
        return patches @ self.conv1.weight.to(x.dtype).reshape(self.width, -1).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # accept NCHW at the boundary
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(f"expected {self.image_size} images, got {tuple(x.shape)}")
        dtype = self.compute_dtype
        x = self._patch_embed(x.to(dtype))
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.transformer(self.ln_pre(x))
        pooled = self.ln_post(x)[:, 0]
        return pooled @ self.proj.to(pooled.dtype)


def encode_text_tokens(tower: nn.Module, text: torch.Tensor) -> torch.Tensor:
    """The text-tower forward over a module holding its parts
    (``token_embedding``, ``positional_embedding``, ``transformer``,
    ``ln_final``, ``text_projection``, ``compute_dtype``): a
    ``TextTransformer``, or a ``CLIP``, which holds them at top level as
    open_clip's CLIP does."""
    dtype = tower.compute_dtype
    x = tower.token_embedding(text).to(dtype)
    x = x + tower.positional_embedding[: text.shape[1]].to(dtype)
    x = tower.ln_final(tower.transformer(x, causal=True))
    pooled = text_global_pool(x, text)
    return pooled @ tower.text_projection.to(dtype)


class TextTransformer(nn.Module):
    """Causal text transformer with argmax-EOT pooling."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 output_dim: int = 512, act: Callable = gelu, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False):
        super().__init__()
        self.context_length = context_length
        self.compute_dtype = compute_dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       act, attn_impl, grad_checkpointing)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return encode_text_tokens(self, text)
