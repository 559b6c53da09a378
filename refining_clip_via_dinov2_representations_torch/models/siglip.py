"""The SigLIP vision tower (timm ``vit_*_siglip_*``), in timm's trunk layout.

The port of the JAX package's ``models/siglip.py``: patchify (a biased
convolution, no class token) -> learned positions, resized bicubically for
another grid at forward time -> pre-LN blocks (LayerNorm eps 1e-6, fused
QKV, a tanh-GELU MLP) -> the final LayerNorm -> the MAP pooling head (a
learned probe attends over the tokens, then LayerNorm and an MLP with a
residual) -> pooled [B, width]. GELU is the tanh form whatever the dtype
(``gelu_tanh``, HF's ``gelu_pytorch_tanh``), unlike the CLIP towers' rule.

Parameter names are timm's under the tower's ``trunk`` (``visual.trunk.``
in a CLIP), so the JAX exporter's output
(``tpu/models/siglip.py:siglip_vision_params_to_timm_state_dict``) and
open_clip's hub checkpoints load with ``strict=True``: ``patch_embed.proj``,
``pos_embed`` [1, N, D], ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm`` and ``attn_pool.{latent, q, kv, proj, norm,
mlp.fc1, mlp.fc2}``. The head keeps timm's separate ``q`` and fused ``kv``
projections; each attention's heads are made contiguous before the
dispatch, as the CUDA kernels take them. On a CUDA tensor the blocks'
self-attention ([b, heads, N, 64]) and the head's one probe query over the
N tokens ([b, heads, 1, 64] x N keys) run the fused kernels under
``"auto"``.

``grad_checkpointing`` recomputes the blocks (not the head) in the
backward under the remat policy, as the JAX tower's ``nn.remat`` wraps
only its blocks. Under a model group (``parallel/tensor.py:shard_module``)
each block's attention and MLP and the MAP head run on this rank's heads
and columns, as the JAX ``_param_spec`` splits them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import column_linear, row_linear
from .layers import LayerNorm
from .transformer import run_blocks, saved_ops

# timm model name -> (width, layers, heads, mlp_dim): the port's own copy of
# the JAX package's table
_SIGLIP_FAMILY_DIMS = {
    "base": (768, 12, 12, 3072),
    "large": (1024, 24, 16, 4096),
    "so400m": (1152, 27, 16, 4304),
    "giantopt": (1536, 40, 16, 6144),
}

_TIMM_RE = re.compile(r"^vit_(base|large|so400m|giantopt)_patch(\d+)_siglip(_gap)?_(\d+)$")


def parse_siglip_timm_name(name: str) -> Optional[Dict[str, int]]:
    """A timm ``vit_*_siglip_*`` name -> the tower's dims, or None for
    another name. The ``_gap`` variants (global average pooling, no MAP
    head weights) raise."""
    m = _TIMM_RE.match(name)
    if not m:
        return None
    if m.group(3):
        raise NotImplementedError(
            f"{name}: timm `_gap` SigLIP variants (global-average-pooled, no attention-pool "
            "head) are not ported; use the MAP-head variant (ROADMAP Queue 1 item 2-3)")
    family, patch, res = m.group(1), int(m.group(2)), int(m.group(4))
    width, layers, heads, mlp = _SIGLIP_FAMILY_DIMS[family]
    return {"width": width, "layers": layers, "heads": heads, "mlp_dim": mlp,
            "patch_size": patch, "image_size": res}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class SiglipVisionCfg:
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    norm_eps: float = 1e-6


def _heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """[B, L, heads * head_dim] -> contiguous [B, heads, L, head_dim]."""
    b, l, _ = t.shape
    return t.view(b, l, heads, head_dim).transpose(1, 2).contiguous()


def _local_heads(heads: int, tp) -> int:
    """The heads this rank runs: all of them, or its part under a model group."""
    return heads // (tp.world if tp else 1)


class Mlp(nn.Module):
    """timm's Mlp: fc1 -> tanh GELU -> fc2; under a model group (``tp``)
    ``fc1`` column- and ``fc2`` row-parallel."""

    tp = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_linear(gelu_tanh(column_linear(x, self.fc1, self.tp)), self.fc2, self.tp)


class Attention(nn.Module):
    """timm's Attention: one fused ``qkv`` projection, ``proj`` out. Under a
    model group (``tp``) ``qkv`` holds this rank's heads of q, k and v and
    ``proj`` its columns: the core runs on ``num_heads / tp.world`` heads."""

    tp = None

    def __init__(self, dim: int, heads: int, attn_impl: str = "auto"):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} is not divisible by {heads} heads")
        self.num_heads, self.attn_impl = heads, attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        heads = _local_heads(self.num_heads, self.tp)
        qkv = column_linear(x, self.qkv, self.tp).view(b, l, 3, heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = multi_head_attention(q, k, v, impl=self.attn_impl)
        return row_linear(out.transpose(1, 2).reshape(b, l, -1), self.proj, self.tp)


class Block(nn.Module):
    """Pre-LN block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``."""

    def __init__(self, cfg: SiglipVisionCfg, attn_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(cfg.width, cfg.norm_eps)
        self.attn = Attention(cfg.width, cfg.heads, attn_impl)
        self.norm2 = LayerNorm(cfg.width, cfg.norm_eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AttentionPoolLatent(nn.Module):
    """timm's MAP head (HF ``SiglipMultiheadAttentionPoolingHead``): the
    ``latent`` probe through ``q`` attends over ``kv`` of the tokens, then
    ``proj``; ``x + mlp(norm(x))``; the probe's row. Under a model group
    (``tp``) ``q`` and ``kv`` hold this rank's heads (of k and of v) and
    ``proj`` its columns, as the JAX rule splits ``head_attn``."""

    tp = None

    def __init__(self, cfg: SiglipVisionCfg, attn_impl: str = "auto"):
        super().__init__()
        d = cfg.width
        self.num_heads, self.attn_impl = cfg.heads, attn_impl
        self.latent = nn.Parameter(torch.zeros(1, 1, d))
        self.q = nn.Linear(d, d)
        self.kv = nn.Linear(d, 2 * d)
        self.proj = nn.Linear(d, d)
        self.norm = LayerNorm(d, cfg.norm_eps)
        self.mlp = Mlp(d, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        heads, dh = _local_heads(self.num_heads, self.tp), d // self.num_heads
        q = column_linear(self.latent.to(x.dtype).expand(b, 1, d), self.q, self.tp)
        k, v = column_linear(x, self.kv, self.tp).chunk(2, dim=-1)
        out = multi_head_attention(_heads(q, heads, dh), _heads(k, heads, dh),
                                   _heads(v, heads, dh), impl=self.attn_impl)
        x = row_linear(out.transpose(1, 2).reshape(b, 1, -1), self.proj, self.tp)
        x = x + self.mlp(self.norm(x))
        return x[:, 0]


class SiglipTrunk(nn.Module):
    """The timm trunk's parameters, under timm's names (the tower's
    ``forward`` runs them)."""

    def __init__(self, cfg: SiglipVisionCfg, attn_impl: str = "auto"):
        super().__init__()
        side = cfg.image_size // cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.width, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, side * side, cfg.width))
        self.blocks = nn.ModuleList(Block(cfg, attn_impl) for _ in range(cfg.layers))
        self.norm = LayerNorm(cfg.width, cfg.norm_eps)
        self.attn_pool = AttentionPoolLatent(cfg, attn_impl)


class SiglipVisionTower(nn.Module):
    """The SigLIP vision tower over NHWC (or NCHW) images: pooled features
    [B, width] in ``compute_dtype`` (``(pooled, tokens)`` with
    ``output_tokens``); parameters are fp32. Any image size works: the
    positions are resized to the input's grid."""

    patch_dropout = None  # the JAX tower has none

    def __init__(self, cfg: SiglipVisionCfg, output_tokens: bool = False,
                 attn_impl: str = "auto", compute_dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False, remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.cfg = cfg
        self.image_size = (cfg.image_size, cfg.image_size)
        self.output_tokens = output_tokens
        self.compute_dtype = compute_dtype
        self.grad_checkpointing = grad_checkpointing
        self.remat_policy = remat_policy
        self.trunk = SiglipTrunk(cfg, attn_impl)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    def _patch_embed(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """[B, H, W, 3] -> ([B, gh*gw, width], gh, gw): the stride-patch
        convolution (VALID) as one matmul over (channel, row, col)-ordered
        patches, which keeps fp32 off cuDNN's TF32 convolutions."""
        b, h, w, _ = x.shape
        p = self.cfg.patch_size
        gh, gw = h // p, w // p
        conv = self.trunk.patch_embed.proj
        patches = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, gh * gw, 3 * p * p)
        out = patches @ conv.weight.to(x.dtype).reshape(self.cfg.width, -1).t()
        return out + conv.bias.to(x.dtype), gh, gw

    def _positions(self, gh: int, gw: int) -> torch.Tensor:
        """The position table at a (gh, gw) grid: resized bicubically with
        antialias (``jax.image.resize(..., "cubic")``) off the native one."""
        from .dinov2 import resize_position_table

        pos = self.trunk.pos_embed[0]
        side = self.cfg.image_size // self.cfg.patch_size
        if gh * gw == side * side:
            return pos
        grid = resize_position_table(pos.float().reshape(side, side, -1), (gh, gw))
        return grid.reshape(gh * gw, -1)

    def forward(self, x: torch.Tensor, patch_dropout_generator=None):
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # accept NCHW at the boundary
        x, gh, gw = self._patch_embed(x.to(self.compute_dtype))
        x = x + self._positions(gh, gw).to(x.dtype)
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        x = run_blocks(self.trunk.blocks, x, remat, self.remat_policy)
        tokens = self.trunk.norm(x)
        pooled = self.trunk.attn_pool(tokens)
        return (pooled, tokens) if self.output_tokens else pooled

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """The JAX initialisers' draws for the tower's own tensors: the
        patch kernel normal(fan_in^-1/2) and zero bias, positions and probe
        normal(0.02); ``normal_`` draws from the model's generator."""
        conv = self.trunk.patch_embed.proj
        normal_(conv.weight, conv.weight[0].numel() ** -0.5)
        conv.bias.zero_()
        normal_(self.trunk.pos_embed, 0.02)
        normal_(self.trunk.attn_pool.latent, 0.02)
