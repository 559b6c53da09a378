"""ViTamin vision towers (timm ``vitamin_{small,base,large,large2,xlarge}_*``).

The port of the JAX package's ``models/vitamin.py``, a three-stage hybrid:

  stem     3x3 s2 convolution -> LayerNorm over channels -> GELU -> 3x3 s1
           convolution (no norm after it)                       (H/2)
  stage 1  MBConv-LN blocks, the first at stride 2              (H/4)
  stage 2  MBConv-LN blocks, the first at stride 2              (H/8)
  embed    LayerNorm over channels -> 3x3 s2 convolution to the ViT width
           (H/16 tokens, no class token, a learned ``[1, gh gw, D]`` table)
  stage 3  pre-LN ViT blocks whose FFN is a GeGLU with an inner LayerNorm:
           ``w2(gelu(w0 n) * (w1 n))``, ``n = norm(x)``, hidden ratio 2
  head     the mean over tokens, then ``fc_norm``, then the projection
           (``head``, biased where ``timm_proj_bias`` says)

An MBConv-LN block is ``shortcut(x) + conv3(gelu(dw3x3(gelu(conv1(
pre_norm(x))))))``: the expansion ``mid = round(out * 4)``, the depthwise 3x3
convolution (``groups = mid``) carrying the block's stride; the shortcut
takes the un-normed input: a 2x2 average pool then a 1x1 convolution at
stride 2, the 1x1 convolution alone where only the width changes, else the
identity. A 3x3 convolution pads 1 on each side, a 1x1 none. Every
LayerNorm has eps 1e-6 and fp32 statistics; GELU is erf under fp32 and tanh
under bf16, as the port's other towers; no drop path is applied (the
configs' ``timm_drop_path`` is not applied in JAX either). Images are NCHW
inside (NHWC accepted at the boundary); the LayerNorms over channels read
an NHWC view. The ViT stage's attention runs
``ops/attention.py:multi_head_attention`` with the tower's ``attn_impl``, so
on a card it takes the fused kernels (``[B, 16, 196, 64]`` at ViTamin-L,
the flash forward at 576 tokens under ``"flash"``); ``grad_checkpointing``
recomputes each ViT block in the backward (the JAX tower's ``nn.remat``
wraps only those).

Parameter names are open_clip's timm layout under the tower (``visual.`` in
a CLIP), as the JAX exporter writes them (``tpu/models/vitamin.py:330-404``):
``trunk.patch_embed.backbone.stem.{conv1, norm1, conv2}``,
``trunk.patch_embed.backbone.stages.S.blocks.B.{pre_norm, conv1_1x1,
conv2_kxk, conv3_1x1, shortcut}``, ``trunk.patch_embed.pool.{norm, proj}``,
``trunk.pos_embed``, ``trunk.blocks.I.{norm1, attn.qkv, attn.proj, norm2,
mlp.norm, mlp.w0, mlp.w1, mlp.w2}``, ``trunk.fc_norm`` and ``trunk.head``.
``convert_timm_vitamin_state_dict`` is the port of the JAX importer
(``tpu/models/vitamin.py:212-327``): it flattens a nested shortcut
(``shortcut.expand.weight`` -> ``shortcut.weight``), takes ``fc1_g``,
``fc1_x``, ``fc2`` for ``w0``, ``w1``, ``w2``, warns on and drops a trunk
``norm`` key, and raises ``KeyError`` on any key it does not know.

Neither package is value-verified against timm: the JAX tower was rebuilt
from the paper and timm's structure and never held against a real
checkpoint (``tpu/models/vitamin.py:18-24``); ``large2`` is mapped to the
large trunk unverified (``:56-57``); and the JAX exporter writes
``shortcut.weight`` where its importer takes any nested ``shortcut.*``. The
port holds to the JAX package, its reference.

Under a model group (``parallel/tensor.py:shard_module``) the ViT stage
splits as ``_param_spec`` says: ``attn.qkv`` by heads, ``attn.proj`` by
rows, ``mlp.w0``/``mlp.w1`` column- and ``mlp.w2`` row-parallel; the GeGLU's
inner ``norm`` acts on the whole width before ``w0``/``w1`` and stays whole;
the stem, the MBConv stages and the embed convolution stay whole.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import copy_to_model, row_linear
from .convnext import _channel_norm
from .layers import LayerNorm, _linear, gelu
from .resnet import _conv
from .siglip import Attention
from .transformer import run_blocks, saved_ops

TRUNK = "visual.trunk."


@dataclasses.dataclass(frozen=True)
class ViTaminCfg:
    stem_width: int
    conv_dims: Tuple[int, int]
    conv_depths: Tuple[int, int]
    embed_dim: int
    depth: int
    heads: int
    image_size: int = 224
    mlp_ratio: float = 2.0     # GeGLU hidden ratio
    expand_ratio: float = 4.0  # MBConv expansion
    norm_eps: float = 1e-6


# the JAX package's table (``large2`` mapped to the large trunk, unverified)
VITAMIN_DIMS: Dict[str, ViTaminCfg] = {}
for _name, _c in {
    "small": ViTaminCfg(64, (64, 128), (2, 4), 384, 14, 6),
    "base": ViTaminCfg(128, (128, 256), (2, 4), 768, 14, 12),
    "large": ViTaminCfg(160, (160, 320), (2, 4), 1024, 31, 16),
    "large2": ViTaminCfg(160, (160, 320), (2, 4), 1024, 31, 16),
    "xlarge": ViTaminCfg(192, (192, 384), (2, 4), 1152, 32, 18),
}.items():
    for _res in (224, 256, 336, 384):
        VITAMIN_DIMS[f"vitamin_{_name}_{_res}"] = dataclasses.replace(_c, image_size=_res)


class MbConvLNBlock(nn.Module):
    """The MBConv-LN block (the module docstring)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int, expand_ratio: float = 4.0,
                 norm_eps: float = 1e-6):
        super().__init__()
        mid = int(round(out_chs * expand_ratio))
        self.stride = stride
        self.shortcut = (nn.Conv2d(in_chs, out_chs, 1) if stride == 2 or in_chs != out_chs
                         else None)
        self.pre_norm = LayerNorm(in_chs, norm_eps)
        self.conv1_1x1 = nn.Conv2d(in_chs, mid, 1)
        self.conv2_kxk = nn.Conv2d(mid, mid, 3, stride=stride, padding=1, groups=mid)
        self.conv3_1x1 = nn.Conv2d(mid, out_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            short = _conv(F.avg_pool2d(x, 2), self.shortcut)
        else:
            short = x if self.shortcut is None else _conv(x, self.shortcut)
        y = gelu(_conv(_channel_norm(x, self.pre_norm), self.conv1_1x1))
        y = gelu(_conv(y, self.conv2_kxk))
        return short + _conv(y, self.conv3_1x1)


class GeGluMlp(nn.Module):
    """The FFN: the inner LayerNorm, then ``w2(gelu(w0 n) * (w1 n))``;
    under a model group (``tp``) ``w0``/``w1`` column- and ``w2``
    row-parallel, the norm whole."""

    tp = None

    def __init__(self, dim: int, hidden: int, norm_eps: float = 1e-6):
        super().__init__()
        self.norm = LayerNorm(dim, norm_eps)
        self.w0 = nn.Linear(dim, hidden)
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(self.norm(x), self.tp)  # one all-reduce of the gradient for both
        h = gelu(_linear(x, self.w0)) * _linear(x, self.w1)
        return row_linear(h, self.w2, self.tp)


class ViTaminBlock(nn.Module):
    """Pre-LN: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, norm_eps: float,
                 attn_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, heads, attn_impl)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = GeGluMlp(dim, int(dim * mlp_ratio), norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Stage(nn.Module):
    def __init__(self, in_chs: int, dim: int, depth: int, cfg: ViTaminCfg):
        super().__init__()
        self.blocks = nn.ModuleList(
            MbConvLNBlock(in_chs if i == 0 else dim, dim, 2 if i == 0 else 1, cfg.expand_ratio,
                          cfg.norm_eps) for i in range(depth))


class ViTaminVisionTower(nn.Module):
    """``tpu/models/vitamin.py:ViTaminVisionTower`` (the module docstring).
    ``cfg.image_size`` is the size it is built and served at: the registry
    config's image size replaces the trunk's (``tpu/models/clip.py:
    146-148``), so ``ViTamin-XL-384``, whose config says 256, is built at
    256. ``output_tokens`` also returns the ViT stage's tokens."""

    patch_dropout = None

    def __init__(self, cfg: ViTaminCfg, output_dim: int, proj_bias: bool = False,
                 output_tokens: bool = False, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.cfg, self.output_tokens, self.compute_dtype = cfg, output_tokens, compute_dtype
        self.image_size = (cfg.image_size, cfg.image_size)
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy
        grid = cfg.image_size // 16
        self.grid_size = (grid, grid)
        eps, d = cfg.norm_eps, cfg.embed_dim
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        backbone = self.trunk.patch_embed.backbone = nn.Module()
        backbone.stem = nn.Module()
        backbone.stem.conv1 = nn.Conv2d(3, cfg.stem_width, 3, stride=2, padding=1)
        backbone.stem.norm1 = LayerNorm(cfg.stem_width, eps)
        backbone.stem.conv2 = nn.Conv2d(cfg.stem_width, cfg.stem_width, 3, padding=1)
        backbone.stages = nn.ModuleList(
            _Stage(cfg.stem_width if s == 0 else cfg.conv_dims[s - 1], dim, depth, cfg)
            for s, (dim, depth) in enumerate(zip(cfg.conv_dims, cfg.conv_depths)))
        pool = self.trunk.patch_embed.pool = nn.Module()
        pool.norm = LayerNorm(cfg.conv_dims[-1], eps)
        pool.proj = nn.Conv2d(cfg.conv_dims[-1], d, 3, stride=2, padding=1)
        self.trunk.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, d))
        self.trunk.blocks = nn.ModuleList(
            ViTaminBlock(d, cfg.heads, cfg.mlp_ratio, eps, attn_impl) for _ in range(cfg.depth))
        self.trunk.fc_norm = LayerNorm(d, eps)
        self.trunk.head = nn.Linear(d, output_dim, bias=proj_bias)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """Convolutions normal(fan_in^-1/2) with zero bias, the position table
        normal(0.02), as the JAX initialisers; the LayerNorms and Linears are
        ``models/clip.py:init_weights``'."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                m.bias.zero_()
        normal_(self.trunk.pos_embed, 0.02)

    def forward(self, x: torch.Tensor, patch_dropout_generator: Optional[torch.Generator] = None):
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        if tuple(x.shape[2:]) != self.image_size:
            raise ValueError(f"expected {self.image_size} images, got {tuple(x.shape)}")
        x = x.to(self.compute_dtype)
        backbone = self.trunk.patch_embed.backbone
        x = gelu(_channel_norm(_conv(x, backbone.stem.conv1), backbone.stem.norm1))
        x = _conv(x, backbone.stem.conv2)
        for stage in backbone.stages:
            for blk in stage.blocks:
                x = blk(x)
        pool = self.trunk.patch_embed.pool
        x = _conv(_channel_norm(x, pool.norm), pool.proj)
        x = x.flatten(2).transpose(1, 2) + self.trunk.pos_embed.to(x.dtype)
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        tokens = run_blocks(self.trunk.blocks, x, remat, self.remat_policy)
        pooled = _linear(self.trunk.fc_norm(tokens.mean(dim=1)), self.trunk.head)
        return (pooled, tokens) if self.output_tokens else pooled


# ---------------------------------------------------------------------------
# timm / open_clip checkpoints
# ---------------------------------------------------------------------------

def _leaf(name: str) -> str:
    """The JAX importer's rule: a ``weight`` leaf is the kernel or scale,
    any other leaf the bias."""
    return "weight" if name == "weight" else "bias"


def convert_timm_vitamin_state_dict(state_dict: Mapping[str, torch.Tensor],
                                    prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """A timm ViTamin trunk (keys under ``prefix``) -> the port's keys under
    ``prefix``, as ``tpu/models/vitamin.py:convert_timm_vitamin_state_dict``
    reads it (the module docstring); keys outside ``prefix`` are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(".")
        if parts[0] == "patch_embed":
            rest = parts[1:]
            if rest[0] == "backbone":
                rest = rest[1:]
            if rest[0] == "stem":
                if rest[1] in ("conv1", "conv2"):
                    out[f"{prefix}patch_embed.backbone.stem.{rest[1]}.{_leaf(rest[2])}"] = val
                elif rest[1] in ("norm1", "norm"):
                    out[f"{prefix}patch_embed.backbone.stem.norm1.{_leaf(rest[2])}"] = val
                else:
                    raise KeyError(key)
            elif rest[0] == "stages":
                blk = f"{prefix}patch_embed.backbone.stages.{int(rest[1])}.blocks.{int(rest[3])}"
                r = rest[4:]
                if r[0] == "pre_norm":
                    out[f"{blk}.pre_norm.{_leaf(r[1])}"] = val
                elif r[0] in ("conv1_1x1", "conv2_kxk", "conv3_1x1", "shortcut"):
                    # timm's shortcut may nest (.conv / .expand): flattened
                    out[f"{blk}.{r[0]}.{_leaf(r[-1])}"] = val
                else:
                    raise KeyError(key)
            elif rest[0] == "pool":  # StridedConv: norm + proj
                if rest[1] in ("norm", "proj"):
                    out[f"{prefix}patch_embed.pool.{rest[1]}.{_leaf(rest[2])}"] = val
                else:
                    raise KeyError(key)
            else:
                raise KeyError(key)
        elif parts == ["pos_embed"]:
            out[prefix + "pos_embed"] = val.reshape(1, val.shape[-2], val.shape[-1])
        elif parts[0] == "blocks":
            blk, rest = f"{prefix}blocks.{int(parts[1])}", parts[2:]
            if rest[0] in ("norm1", "norm2"):
                out[f"{blk}.{rest[0]}.{_leaf(rest[1])}"] = val
            elif rest[0] == "attn":
                if rest[1] not in ("qkv", "proj"):
                    raise KeyError(key)
                out[f"{blk}.attn.{rest[1]}.{_leaf(rest[2])}"] = val
            elif rest[0] == "mlp":
                if rest[1] == "norm":
                    out[f"{blk}.mlp.norm.{_leaf(rest[2])}"] = val
                elif rest[1] in ("w0", "w1", "w2", "fc1_g", "fc1_x", "fc2"):
                    sub = {"fc1_g": "w0", "fc1_x": "w1", "fc2": "w2"}.get(rest[1], rest[1])
                    out[f"{blk}.mlp.{sub}.{_leaf(rest[2])}"] = val
                else:
                    raise KeyError(key)
            else:
                raise KeyError(key)
        elif parts[0] == "fc_norm":
            out[f"{prefix}fc_norm.{_leaf(parts[1])}"] = val
        elif parts[0] == "norm":
            # Identity under fc_norm in timm's avg-pool config; a checkpoint
            # may serialize it anyway
            logging.warning("vitamin converter: ignoring trunk norm key %s", key)
        elif parts[0] == "head":
            out[f"{prefix}head.{_leaf(parts[1])}"] = val
        else:
            raise KeyError(key)
    return out


def convert_vitamin_clip_state_dict(state_dict: Mapping[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """An open_clip file with a timm ViTamin trunk -> the port's keys: the
    trunk through ``convert_timm_vitamin_state_dict``, the rest kept."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(TRUNK)}
    out.update(convert_timm_vitamin_state_dict(state_dict))
    return out
