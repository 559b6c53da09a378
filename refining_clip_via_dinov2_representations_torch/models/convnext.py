"""ConvNeXt vision tower (the ``convnext_*`` CLIPs) as ``nn.Module``s.

The port of the JAX package's ``models/convnext.py:31-118`` in open_clip's
timm layout (``visual.trunk.*`` and ``visual.head.*``):

  stem: 4x4/4 convolution + LayerNorm (``trunk.stem.0``, ``.1``); four stages
  of an optional 2x2/2 downsample after a LayerNorm
  (``trunk.stages.S.downsample.0``, ``.1``, stages 1-3) and blocks of
  [7x7 depthwise convolution with bias and padding 3 -> LayerNorm -> 1x1
  expand (4x, ``mlp.fc1``) -> GELU -> 1x1 project (``mlp.fc2``) -> layer
  scale ``gamma`` -> residual] (``trunk.stages.S.blocks.B``); then the mean
  over H and W, the head LayerNorm (``trunk.head.norm``) and the projection:
  ``head.proj`` (``"linear"``), or ``head.mlp.fc1`` (with bias) -> GELU ->
  ``head.mlp.fc2`` (bias only under ``timm_proj_bias``) for ``"mlp"``
  (open_clip's names; the JAX exporter drops the first layer, ROADMAP
  "Found in the JAX package").

Numerics are the JAX tower's: LayerNorm eps 1e-6 with fp32 statistics, GELU
by the repo's rule (erf in fp32, tanh in bf16), no drop path (the configs'
``timm_drop_path`` is not applied there either). Under
``grad_checkpointing`` each block is recomputed in the backward
(``tpu/models/convnext.py:90-93``). The tower has no attention. Images are
NCHW inside, in the channels-last memory format (``memory_format``), so the
per-pixel LayerNorm and MLP read a contiguous NHWC view; NHWC is accepted
at the boundary (``scripts/convnext_memory_format.py`` times the tower in
this format against NCHW-contiguous memory on a card).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .layers import LayerNorm, _linear, gelu
from .resnet import _conv
from .transformer import run_blocks

# timm name -> (depths, dims)
CONVNEXT_DIMS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}
PROJ_TYPES = ("linear", "mlp")


@dataclasses.dataclass(frozen=True)
class ConvNextCfg:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    norm_eps: float = 1e-6


def _channel_norm(x: torch.Tensor, norm: LayerNorm) -> torch.Tensor:
    """``norm`` over the channels of NCHW ``x`` (through its NHWC view)."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, norm_eps: float = 1e-6):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, norm_eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(_conv(x, self.conv_dw).permute(0, 2, 3, 1))
        h = _linear(gelu(_linear(h, self.mlp.fc1)), self.mlp.fc2)
        return x + (h * self.gamma.to(h.dtype)).permute(0, 3, 1, 2)


class _Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool, norm_eps: float):
        super().__init__()
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(LayerNorm(in_dim, norm_eps),
                                            nn.Conv2d(in_dim, dim, 2, stride=2))
        self.blocks = nn.Sequential(*(ConvNextBlock(dim, norm_eps) for _ in range(depth)))


class ConvNextTower(nn.Module):
    """The trunk, the average pool, the head LayerNorm and the projection
    (the module docstring). ``output_tokens`` also returns the last stage's
    map as ``[B, H'W', C]``."""

    memory_format = torch.channels_last

    def __init__(self, cfg: ConvNextCfg, output_dim: int, image_size: int = 224,
                 proj_type: str = "linear", proj_bias: bool = False, output_tokens: bool = False,
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if proj_type not in PROJ_TYPES:
            raise NotImplementedError(f"ConvNeXt projection {proj_type!r}: one of {PROJ_TYPES}")
        self.cfg, self.output_tokens, self.compute_dtype = cfg, output_tokens, compute_dtype
        self.image_size = (image_size, image_size)  # the size it is served at
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy
        eps = cfg.norm_eps
        self.trunk = nn.Module()
        self.trunk.stem = nn.Sequential(nn.Conv2d(3, cfg.dims[0], 4, stride=4),
                                        LayerNorm(cfg.dims[0], eps))
        self.trunk.stages = nn.Sequential(*(
            _Stage(cfg.dims[max(s - 1, 0)], dim, depth, s > 0, eps)
            for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims))))
        self.trunk.head = nn.Module()
        self.trunk.head.norm = LayerNorm(cfg.dims[-1], eps)
        self.head = nn.Module()
        if proj_type == "mlp":
            self.head.mlp = nn.Module()
            self.head.mlp.fc1 = nn.Linear(cfg.dims[-1], 2 * output_dim)
            self.head.mlp.fc2 = nn.Linear(2 * output_dim, output_dim, bias=proj_bias)
        else:
            self.head.proj = nn.Linear(cfg.dims[-1], output_dim, bias=proj_bias)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """Convolutions normal(fan_in^-1/2) with zero bias, ``gamma`` 1e-6
        (the JAX init); the LayerNorms and Linears are ``models/clip.py:
        init_weights``'."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                m.bias.zero_()
            elif isinstance(m, ConvNextBlock):
                m.gamma.fill_(1e-6)

    def forward(self, x: torch.Tensor, patch_dropout_generator=None):
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        x = x.to(self.compute_dtype).contiguous(memory_format=self.memory_format)
        stem_conv, stem_norm = self.trunk.stem
        x = _channel_norm(_conv(x, stem_conv), stem_norm)
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        for stage in self.trunk.stages:
            if stage.downsample is not None:
                norm, conv = stage.downsample
                x = _conv(_channel_norm(x, norm), conv)
            x = run_blocks(stage.blocks, x, remat, self.remat_policy)
        pooled = self.trunk.head.norm(x.mean(dim=(2, 3)))
        if hasattr(self.head, "mlp"):
            pooled = _linear(gelu(_linear(pooled, self.head.mlp.fc1)), self.head.mlp.fc2)
        else:
            pooled = _linear(pooled, self.head.proj)
        if self.output_tokens:
            return pooled, x.flatten(2).transpose(1, 2)
        return pooled
