"""FastViT and MCi vision towers (MobileCLIP's image sides), in timm's layout.

The port of the JAX package's ``models/fastvit.py``:

* ``FastVitTower`` (``fastvit_mci0/1/2``: MobileCLIP-S0/S1/S2): a stem of
  three MobileOne blocks (/4), three RepMixer stages and one attention stage
  (behind a RepCPE), each stage after the first opened by a large-kernel
  downsampler (``PatchEmbed``: a depthwise 7x7/2 + 3x3/2 pair, then a 1x1
  MobileOne block), a depthwise 2x expansion ``final_conv`` with
  Squeeze-Excite, the average pool and the linear ``head.fc`` to the embed
  width.
* ``MciVisionTransformer`` (``vit_base_mci_224``: MobileCLIP-B): a ViT-B/16
  behind a three-convolution stem (4x4/4, 2x2/2, 2x2/2, each with
  BatchNorm and GELU), the position table over the patch tokens only (the
  class token is prepended after it), pre-LN blocks (LayerNorm eps 1e-6,
  fused QKV, a GELU MLP), the final LayerNorm, the class token pooled, the
  linear ``head``.

This is the training form, with a branch for each part of a MobileOne
block: an identity BatchNorm where the block keeps its shape, a 1x1 scale
branch where the kernel is larger, and the k x k branches, summed in that
order (``tpu/models/fastvit.py:142-152``), then Squeeze-Excite (reduction
1/16; 1/4 in the large-kernel downsamplers), then GELU. ``RepMixer`` returns
``x + gamma * (mixer(x) - norm(x))``, its ``norm`` the bare identity
BatchNorm. Every BatchNorm is ``models/resnet.py:BatchNorm2d`` (flax's
numerics; the running statistics are buffers and change only under
``batch_norm_mode``, as the train step sets it). GELU is erf under fp32 and
tanh under bf16 (``models/layers.py:gelu``). Images are NCHW inside (NHWC
accepted at the boundary).

The FastViT attention stage is plain attention, as in the JAX package
whatever ``attn_impl`` says (``tpu/models/fastvit.py:313-336``): head dim
32, no QKV bias, the logits in the compute dtype, the softmax in fp32; it
launches no kernel. The MCi blocks run ``ops/attention.py:
multi_head_attention`` with the tower's ``attn_impl`` (the fused kernels on
a card, ``[B, 12, 197, 64]`` at MobileCLIP-B). ``grad_checkpointing``
recomputes each FastViT stage block (RepMixer and attention) and each MCi
block in the backward, as the JAX towers' ``nn.remat``; a FastViT block's
norms run again in the recompute in the mode of the forward, under
``running_stats_kept``, so their running statistics move once a step.

Parameter names are timm's under the tower's ``trunk`` (``visual.trunk.``
in a CLIP), as the JAX exporters write them (``tpu/models/fastvit.py:
fastvit_params_to_timm_state_dict``, ``mci_vit_params_to_timm_state_dict``):
``stem.N``, ``stages.S.downsample.proj.{0,1}``, ``stages.S.pos_emb.pos_enc``,
``stages.S.blocks.B.{token_mixer, mlp, layer_scale}`` (RepMixer) or
``.{norm, token_mixer.qkv, token_mixer.proj, layer_scale_1, layer_scale_2,
mlp}`` (attention), ``final_conv``, ``head.fc``; a MobileOne block's
``identity``, ``conv_scale.{conv, bn}``, ``conv_kxk.N.{conv, bn}``,
``se.{fc1, fc2}``; the layer scales ``gamma`` [C, 1, 1] (the JAX leaf is
[C]); MCi's ``patch_embed.backbone.N.{conv, bn}``, ``cls_token`` [1, 1, D],
``pos_embed`` [1, N, D], ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``, ``head``. ``convert_timm_fastvit_state_dict``
and ``convert_timm_mci_vit_state_dict`` take what the JAX importers take (the
layer scales with or without ``.gamma``, any shape of the same size) and
refuse with ``ValueError`` what they refuse; BatchNorm's
``num_batches_tracked`` is dropped (the JAX importer refuses it).

The deploy form: ``fuse_fastvit_state_dict`` folds every branch and
BatchNorm of a training-form trunk into one convolution per block
(``tpu/models/fastvit.py:fuse_fastvit_variables``): a MobileOne block, a
downsampler's pair and a RepMixer (identity and layer scale included) each
become ``reparam_conv``, a ConvMlp's depthwise convolution and norm one
biased ``mlp.conv``, an attention block's norm an affine ``norm.weight``/
``norm.bias``, the RepCPE's identity its kernel's centre. A tower built
with ``inference_mode=True`` takes its output; ``fuse_fastvit(model)``
returns a copy of a CLIP (or tower) in that form. Nothing in the port calls
it: it is for a deployer, as in the JAX package.

Neither package is value-verified against a real MobileCLIP checkpoint
(``tpu/models/fastvit.py:25-31``: the key names and the SE ratios are
flagged); the port holds to the JAX package, its reference.

Under a model group (``parallel/tensor.py:shard_module``) the MCi blocks
split as the JAX ``_param_spec`` splits them (``attn.qkv`` by heads,
``attn.proj`` by rows, ``mlp.fc1``/``mlp.fc2`` column- then row-parallel);
every FastViT tensor stays whole (``_WHOLE_TOWERS``), as the JAX spec's
docstring says of the convolution towers.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import re
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import LayerNorm, _linear, gelu
from .resnet import BN_EPS, BatchNorm2d, _conv, batch_norm_mode, running_stats_kept
from .siglip import Attention
from .swin import Mlp
from .transformer import remat_kwargs, run_blocks, saved_ops

TRUNK = "visual.trunk."
LS_INIT = 1e-5  # the JAX blocks' layer-scale init


@dataclasses.dataclass(frozen=True)
class FastVitCfg:
    layers: Tuple[int, ...] = (4, 12, 20, 4)
    embed_dims: Tuple[int, ...] = (64, 128, 256, 512)
    mlp_ratios: Tuple[int, ...] = (3, 3, 3, 3)
    se_downsamples: Tuple[bool, ...] = (False, False, True, True)
    token_mixers: Tuple[str, ...] = ("repmixer", "repmixer", "repmixer", "attention")
    pos_emb_stages: Tuple[bool, ...] = (False, False, False, True)
    cls_ratio: float = 2.0
    image_size: int = 256
    lkc_use_act: bool = True  # GELU after the large-kernel downsampler


# the JAX package's table (timm's mci entry points)
FASTVIT_DIMS: Dict[str, FastVitCfg] = {
    "fastvit_mci0": FastVitCfg(layers=(2, 6, 10, 2)),
    "fastvit_mci1": FastVitCfg(layers=(4, 12, 20, 4)),
    "fastvit_mci2": FastVitCfg(layers=(4, 12, 24, 4), embed_dims=(80, 160, 320, 640)),
}


@dataclasses.dataclass(frozen=True)
class MciCfg:
    width: int = 768
    layers: int = 12
    heads: int = 12
    image_size: int = 224
    norm_eps: float = 1e-6


# ``tpu/models/fastvit.py:MciVisionTransformer``'s defaults, by timm name
MCI_DIMS: Dict[str, MciCfg] = {"vit_base_mci_224": MciCfg()}


class ConvBN(nn.Module):
    """A bias-free convolution (padding ``k // 2``), then BatchNorm."""

    def __init__(self, in_chs: int, out_chs: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_chs, out_chs, k, stride, k // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(out_chs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(_conv(x, self.conv))


class SqueezeExcite(nn.Module):
    """Global pool -> 1x1 reduce -> ReLU -> 1x1 expand -> sigmoid gate."""

    def __init__(self, chs: int, rd_chs: int):
        super().__init__()
        self.fc1 = nn.Conv2d(chs, rd_chs, 1)
        self.fc2 = nn.Conv2d(rd_chs, chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(_conv(x.mean((2, 3), keepdim=True), self.fc1))
        return x * torch.sigmoid(_conv(s, self.fc2))


class MobileOneBlock(nn.Module):
    """The branches summed (the module docstring), then SE and GELU; in
    ``inference_mode`` one biased ``reparam_conv``."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, use_se: bool = False, use_act: bool = True,
                 use_scale_branch: bool = True, num_conv_branches: int = 1,
                 inference_mode: bool = False):
        super().__init__()
        self.use_act = use_act
        self.reparam_conv = self.identity = self.conv_scale = self.conv_kxk = None
        if inference_mode:
            self.reparam_conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride,
                                          kernel_size // 2, groups=groups)
        else:
            if in_chs == out_chs and stride == 1:
                self.identity = BatchNorm2d(in_chs)
            if use_scale_branch and kernel_size > 1:
                self.conv_scale = ConvBN(in_chs, out_chs, 1, stride, groups)
            self.conv_kxk = nn.ModuleList(ConvBN(in_chs, out_chs, kernel_size, stride, groups)
                                          for _ in range(num_conv_branches))
        self.se = SqueezeExcite(out_chs, max(1, out_chs // 16)) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reparam_conv is not None:
            out = _conv(x, self.reparam_conv)
        else:
            parts = [] if self.identity is None else [self.identity(x)]
            if self.conv_scale is not None:
                parts.append(self.conv_scale(x))
            parts += [branch(x) for branch in self.conv_kxk]
            out = parts[0]
            for p in parts[1:]:
                out = out + p
        if self.se is not None:
            out = self.se(out)
        return gelu(out) if self.use_act else out


class ReparamLargeKernelConv(nn.Module):
    """The downsampler's depthwise 7x7/2 + 3x3/2 pair (groups = in
    channels), SE (1/4) where the config says, GELU where ``use_act``."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 7, stride: int = 2,
                 small_kernel: int = 3, use_se: bool = False, use_act: bool = True,
                 inference_mode: bool = False):
        super().__init__()
        self.use_act = use_act
        self.reparam_conv = self.large_conv = self.small_conv = None
        if inference_mode:
            self.reparam_conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride,
                                          kernel_size // 2, groups=in_chs)
        else:
            self.large_conv = ConvBN(in_chs, out_chs, kernel_size, stride, in_chs)
            self.small_conv = ConvBN(in_chs, out_chs, small_kernel, stride, in_chs)
        self.se = SqueezeExcite(out_chs, max(1, out_chs // 4)) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = (_conv(x, self.reparam_conv) if self.reparam_conv is not None
               else self.large_conv(x) + self.small_conv(x))
        if self.se is not None:
            out = self.se(out)
        return gelu(out) if self.use_act else out


class PatchEmbed(nn.Module):
    """A stage's downsampler: ``proj.0`` the large-kernel pair, ``proj.1`` a
    1x1 MobileOne block."""

    def __init__(self, in_chs: int, out_chs: int, use_se: bool, lkc_use_act: bool,
                 inference_mode: bool = False):
        super().__init__()
        self.proj = nn.Sequential(
            ReparamLargeKernelConv(in_chs, out_chs, use_se=use_se, use_act=lkc_use_act,
                                   inference_mode=inference_mode),
            MobileOneBlock(out_chs, out_chs, 1, inference_mode=inference_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class LayerScale2d(nn.Module):
    """A per-channel scale over NCHW: timm's ``gamma`` [C, 1, 1]."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim, 1, 1), LS_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gamma.to(x.dtype) * x


class AffineChannel(nn.Module):
    """An eval-mode BatchNorm folded: ``x * weight + bias`` per channel."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class RepMixer(nn.Module):
    """``x + gamma * (mixer(x) - norm(x))``; in ``inference_mode`` one
    depthwise ``reparam_conv``."""

    def __init__(self, dim: int, inference_mode: bool = False):
        super().__init__()
        self.reparam_conv = self.norm = self.mixer = self.layer_scale = None
        if inference_mode:
            self.reparam_conv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)
        else:
            self.norm = MobileOneBlock(dim, dim, 3, groups=dim, use_act=False,
                                       use_scale_branch=False, num_conv_branches=0)
            self.mixer = MobileOneBlock(dim, dim, 3, groups=dim, use_act=False)
            self.layer_scale = LayerScale2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reparam_conv is not None:
            return _conv(x, self.reparam_conv)
        normed = self.norm(x)
        return x + self.layer_scale(self.mixer(x) - normed)


class ConvMlp(nn.Module):
    """A depthwise 7x7 convolution and BatchNorm (one biased convolution in
    ``inference_mode``), then 1x1 expand -> GELU -> 1x1 project."""

    def __init__(self, dim: int, hidden: int, inference_mode: bool = False):
        super().__init__()
        self.conv = (nn.Conv2d(dim, dim, 7, 1, 3, groups=dim) if inference_mode
                     else ConvBN(dim, dim, 7, groups=dim))
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(x, self.conv) if isinstance(self.conv, nn.Conv2d) else self.conv(x)
        return _conv(gelu(_conv(h, self.fc1)), self.fc2)


class RepMixerBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int = 3, inference_mode: bool = False):
        super().__init__()
        self.token_mixer = RepMixer(dim, inference_mode)
        self.mlp = ConvMlp(dim, mlp_ratio * dim, inference_mode)
        self.layer_scale = LayerScale2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.token_mixer(x)
        return x + self.layer_scale(self.mlp(x))


class SpatialAttention(nn.Module):
    """Plain multi-head self-attention over the flattened map (head dim
    32, no QKV bias): the logits in the compute dtype, the softmax in fp32,
    as ``tpu/models/fastvit.py:313-336``; never a kernel."""

    def __init__(self, dim: int, head_dim: int = 32):
        super().__init__()
        self.head_dim, self.heads = head_dim, dim // head_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        qkv = _linear(t, self.qkv).view(b, h * w, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        scores = (q @ k.transpose(-2, -1)) / math.sqrt(self.head_dim)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, h * w, c)
        return _linear(out, self.proj).transpose(1, 2).reshape(b, c, h, w)


class AttentionBlock(nn.Module):
    """BatchNorm (an affine in ``inference_mode``) -> attention, layer-scaled
    residual; ConvMlp, layer-scaled residual."""

    def __init__(self, dim: int, mlp_ratio: int = 3, inference_mode: bool = False):
        super().__init__()
        self.norm = AffineChannel(dim) if inference_mode else BatchNorm2d(dim)
        self.token_mixer = SpatialAttention(dim)
        self.layer_scale_1 = LayerScale2d(dim)
        self.mlp = ConvMlp(dim, mlp_ratio * dim, inference_mode)
        self.layer_scale_2 = LayerScale2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.layer_scale_1(self.token_mixer(self.norm(x)))
        return x + self.layer_scale_2(self.mlp(x))


class RepCPE(nn.Module):
    """``x + dwconv7x7(x)``; in ``inference_mode`` the identity sits in the
    kernel's centre and the convolution alone runs."""

    def __init__(self, dim: int, inference_mode: bool = False):
        super().__init__()
        self.inference_mode = inference_mode
        self.pos_enc = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = _conv(x, self.pos_enc)
        return pe if self.inference_mode else x + pe


class FastVitStage(nn.Module):
    def __init__(self, cfg: FastVitCfg, s: int, inference_mode: bool):
        super().__init__()
        dim = cfg.embed_dims[s]
        self.downsample = (PatchEmbed(cfg.embed_dims[s - 1], dim, cfg.se_downsamples[s],
                                      cfg.lkc_use_act, inference_mode) if s > 0 else None)
        self.pos_emb = RepCPE(dim, inference_mode) if cfg.pos_emb_stages[s] else None
        block = AttentionBlock if cfg.token_mixers[s] == "attention" else RepMixerBlock
        self.blocks = nn.ModuleList(block(dim, cfg.mlp_ratios[s], inference_mode)
                                    for _ in range(cfg.layers[s]))


def _recompute_keeping_stats(extra: dict) -> dict:
    """``extra`` (``remat_kwargs``) with ``running_stats_kept`` around the
    recompute, the policy's own contexts kept."""
    inner = extra.get("context_fn")

    def context_fn():
        fwd, rec = inner() if inner else (contextlib.nullcontext(), contextlib.nullcontext())
        return fwd, _both(rec, running_stats_kept())

    return {**extra, "context_fn": context_fn}


def _in_this_mode(blk: nn.Module):
    """``blk`` as a function that runs its norms in the mode they are in now
    (``batch_norm_mode``): the recompute runs in the backward, after the
    step has left that mode."""
    norm = next(m for m in blk.modules() if isinstance(m, BatchNorm2d))
    train, group = norm.train_stats, norm.group

    def run(x: torch.Tensor) -> torch.Tensor:
        with batch_norm_mode(blk, train, group):
            return blk(x)

    return run


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _init_convs_and_norms(module: nn.Module, normal_) -> None:
    """Convolutions normal(fan_in^-1/2) with zero bias, BatchNorm at 1/0 with
    running statistics 0/1, layer scales at ``LS_INIT``, affines at 1/0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, LayerScale2d):
            m.gamma.fill_(LS_INIT)
        elif isinstance(m, AffineChannel):
            m.weight.fill_(1.0)
            m.bias.zero_()


class FastVitTower(nn.Module):
    """``tpu/models/fastvit.py:FastVitTower`` (the module docstring);
    ``output_tokens`` also returns the final map's tokens [B, HW, C]."""

    patch_dropout = None

    def __init__(self, cfg: FastVitCfg, output_dim: int, output_tokens: bool = False,
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full", inference_mode: bool = False):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.cfg, self.output_dim, self.output_tokens = cfg, output_dim, output_tokens
        self.compute_dtype, self.inference_mode = compute_dtype, inference_mode
        self.image_size = (cfg.image_size, cfg.image_size)
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy
        e0, last = cfg.embed_dims[0], cfg.embed_dims[-1]
        inf = dict(inference_mode=inference_mode)
        self.trunk = nn.Module()
        self.trunk.stem = nn.Sequential(MobileOneBlock(3, e0, 3, 2, **inf),
                                        MobileOneBlock(e0, e0, 3, 2, groups=e0, **inf),
                                        MobileOneBlock(e0, e0, 1, **inf))
        self.trunk.stages = nn.ModuleList(FastVitStage(cfg, s, inference_mode)
                                          for s in range(len(cfg.layers)))
        final = int(last * cfg.cls_ratio)
        self.trunk.final_conv = MobileOneBlock(last, final, 3, groups=last, use_se=True, **inf)
        self.trunk.head = nn.Module()
        self.trunk.head.fc = nn.Linear(final, output_dim)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """``_init_convs_and_norms``; the head is ``models/clip.py:
        init_weights``'."""
        _init_convs_and_norms(self, normal_)

    def forward(self, x: torch.Tensor, patch_dropout_generator=None):
        if x.shape[-1] == 3 and x.shape[1] != 3:
            # NHWC at the boundary, made contiguous: torch 2.13's CPU backward of
            # the stem's 1x1 stride-2 branch over a channels-last 3-channel image
            # corrupts the heap
            x = x.permute(0, 3, 1, 2).contiguous()
        x = self.trunk.stem(x.to(self.compute_dtype))
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        extra = _recompute_keeping_stats(remat_kwargs(self.remat_policy)) if remat else {}
        for stage in self.trunk.stages:
            if stage.downsample is not None:
                x = stage.downsample(x)
            if stage.pos_emb is not None:
                x = stage.pos_emb(x)
            for blk in stage.blocks:
                x = (checkpoint(_in_this_mode(blk), x, use_reentrant=False, **extra) if remat
                     else blk(x))
        x = self.trunk.final_conv(x)
        pooled = _linear(x.mean((2, 3)), self.trunk.head.fc)
        return (pooled, x.flatten(2).transpose(1, 2)) if self.output_tokens else pooled


class _StemConv(nn.Module):
    """A bias-free convolution at stride = kernel, then BatchNorm (GELU in the
    tower)."""

    def __init__(self, in_chs: int, out_chs: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(in_chs, out_chs, k, k, bias=False)
        self.bn = BatchNorm2d(out_chs)


class MciBlock(nn.Module):
    """Pre-LN: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``."""

    def __init__(self, dim: int, heads: int, norm_eps: float, attn_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, heads, attn_impl)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class MciVisionTransformer(nn.Module):
    """``tpu/models/fastvit.py:MciVisionTransformer`` (the module docstring);
    ``output_tokens`` also returns the patch tokens after the final norm."""

    patch_dropout = None

    def __init__(self, cfg: MciCfg, output_dim: int, output_tokens: bool = False,
                 attn_impl: str = "auto", compute_dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False, remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)
        self.cfg, self.output_tokens, self.compute_dtype = cfg, output_tokens, compute_dtype
        self.image_size = (cfg.image_size, cfg.image_size)
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy
        w, mid, grid = cfg.width, cfg.width // 4, cfg.image_size // 16
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.backbone = nn.ModuleList(
            _StemConv(i, o, k) for i, o, k in ((3, mid, 4), (mid, mid, 2), (mid, w, 2)))
        self.trunk.cls_token = nn.Parameter(torch.zeros(1, 1, w))
        self.trunk.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, w))
        self.trunk.blocks = nn.ModuleList(MciBlock(w, cfg.heads, cfg.norm_eps, attn_impl)
                                          for _ in range(cfg.layers))
        self.trunk.norm = LayerNorm(w, cfg.norm_eps)
        self.trunk.head = nn.Linear(w, output_dim)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """The stem as ``_init_convs_and_norms``, the class token and the
        position table normal(0.02), as the JAX initialisers."""
        _init_convs_and_norms(self.trunk.patch_embed, normal_)
        normal_(self.trunk.cls_token, 0.02)
        normal_(self.trunk.pos_embed, 0.02)

    def forward(self, x: torch.Tensor, patch_dropout_generator=None):
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        x = x.to(self.compute_dtype)
        for stem in self.trunk.patch_embed.backbone:
            x = gelu(stem.bn(_conv(x, stem.conv)))
        tokens = x.flatten(2).transpose(1, 2) + self.trunk.pos_embed.to(x.dtype)
        cls = self.trunk.cls_token.to(x.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        tokens = self.trunk.norm(run_blocks(self.trunk.blocks, tokens, remat, self.remat_policy))
        pooled = _linear(tokens[:, 0], self.trunk.head)
        return (pooled, tokens[:, 1:]) if self.output_tokens else pooled


# ---------------------------------------------------------------------------
# timm / open_clip checkpoints
# ---------------------------------------------------------------------------

_BN = r"(?:weight|bias|running_mean|running_var)"
_CONVBN = rf"(?:conv\.weight|bn\.{_BN})"
_SE = r"se\.fc[12]\.(?:weight|bias)"
_MOBILEONE = rf"(?:identity\.{_BN}|conv_scale\.{_CONVBN}|conv_kxk\.\d+\.{_CONVBN}|{_SE})"
_BLOCK = r"stages\.\d+\.blocks\.\d+\."
# every trunk key the JAX importer takes (``tpu/models/fastvit.py:652-765``),
# the layer scales' ``.gamma`` optional
_FASTVIT_KEY = re.compile(
    rf"^(?:(?:stem\.\d+|final_conv|stages\.\d+\.downsample\.proj\.1)\.{_MOBILEONE}"
    rf"|stages\.\d+\.downsample\.proj\.0\.(?:(?:large|small)_conv\.{_CONVBN}|{_SE})"
    rf"|stages\.\d+\.pos_emb\.pos_enc\.(?:weight|bias)"
    rf"|{_BLOCK}token_mixer\.(?:norm|mixer)\.{_MOBILEONE}"
    rf"|{_BLOCK}token_mixer\.layer_scale(?:\.gamma)?"
    rf"|{_BLOCK}token_mixer\.(?:qkv|proj)\.\w+"
    rf"|{_BLOCK}norm\.{_BN}"
    rf"|{_BLOCK}mlp\.conv\.{_CONVBN}|{_BLOCK}mlp\.fc[12]\.(?:weight|bias)"
    rf"|{_BLOCK}layer_scale\w*(?:\.gamma)?"
    r"|head\.fc\.(?:weight|bias))$")


def convert_timm_fastvit_state_dict(state_dict: Mapping[str, torch.Tensor],
                                    prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """A timm FastViT trunk (keys under ``prefix``) -> the port's keys under
    ``prefix``, as ``tpu/models/fastvit.py:convert_timm_fastvit_state_dict``
    reads it: a layer scale without ``.gamma`` takes it and the [C, 1, 1]
    shape, an attention projection's leaf other than ``weight`` is its
    bias, ``num_batches_tracked`` is dropped; a key the JAX importer refuses
    raises ``ValueError``. Keys outside ``prefix`` are left out."""
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, val in state_dict.items():
        if not key.startswith(prefix) or key.endswith("num_batches_tracked"):
            continue
        k = key[len(prefix):]
        if not _FASTVIT_KEY.match(k):
            unmatched.append(key)
            continue
        parts = k.split(".")
        if parts[-1] != "gamma" and (parts[-1].startswith("layer_scale")
                                     or parts[-2:] == ["token_mixer", "layer_scale"]):
            k, val = k + ".gamma", val
        if k.endswith(".gamma"):
            val = val.reshape(-1, 1, 1)
        elif parts[-3] == "token_mixer" and parts[-2] in ("qkv", "proj") and parts[-1] != "weight":
            k = k.rsplit(".", 1)[0] + ".bias"
        out[prefix + k] = val
    if unmatched:
        raise ValueError(f"unrecognized fastvit keys (first 10): {unmatched[:10]}")
    return out


_MCI_KEY = re.compile(
    rf"^(?:patch_embed\.backbone\.\d+\.(?:conv\.weight|bn\.{_BN})|cls_token|pos_embed"
    r"|norm\.\w+|head\.\w+|blocks\.\d+\.(?:norm[12]\.\w+|attn\.(?:qkv|proj)\.\w+"
    r"|mlp\.fc[12]\.\w+))$")


def _weight_or_bias(key: str) -> str:
    """The JAX importer's rule: a ``weight`` leaf is the kernel or scale,
    any other leaf the bias."""
    head, leaf = key.rsplit(".", 1)
    return key if leaf == "weight" else head + ".bias"


def convert_timm_mci_vit_state_dict(state_dict: Mapping[str, torch.Tensor],
                                    prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """A timm ``vit_base_mci_224`` trunk -> the port's keys, as
    ``tpu/models/fastvit.py:convert_timm_mci_vit_state_dict`` reads it: the
    class token and position table of any shape of their size, a norm's,
    projection's or head's leaf other than ``weight`` its bias,
    ``num_batches_tracked`` dropped; a key the JAX importer refuses raises
    ``ValueError``."""
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, val in state_dict.items():
        if not key.startswith(prefix) or key.endswith("num_batches_tracked"):
            continue
        k = key[len(prefix):]
        if not _MCI_KEY.match(k):
            unmatched.append(key)
        elif k == "cls_token":
            out[prefix + k] = val.reshape(1, 1, -1)
        elif k == "pos_embed":
            out[prefix + k] = val.reshape(1, -1, val.shape[-1])
        elif k.startswith("patch_embed."):
            out[prefix + k] = val
        else:
            out[prefix + _weight_or_bias(k)] = val
    if unmatched:
        raise ValueError(f"unrecognized mci-vit keys (first 10): {unmatched[:10]}")
    return out


def convert_mobileclip_clip_state_dict(state_dict: Mapping[str, torch.Tensor], mci: bool
                                       ) -> Dict[str, torch.Tensor]:
    """An open_clip MobileCLIP file (a FastViT or, ``mci``, an MCi trunk under
    ``visual.trunk.``) -> the port's keys: the trunk through its importer,
    the rest kept."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(TRUNK)}
    convert = convert_timm_mci_vit_state_dict if mci else convert_timm_fastvit_state_dict
    out.update(convert(state_dict))
    return out


# ---------------------------------------------------------------------------
# the deploy form (``tpu/models/fastvit.py:781-908``)
# ---------------------------------------------------------------------------

def _fold_bn(kernel: torch.Tensor, sd: Mapping[str, torch.Tensor], bn: str):
    """A convolution kernel and the BatchNorm after it -> (kernel, bias)."""
    scale = sd[bn + ".weight"] / torch.sqrt(sd[bn + ".running_var"] + BN_EPS)
    return kernel * scale[:, None, None, None], sd[bn + ".bias"] - sd[bn + ".running_mean"] * scale


def _pad_center(kernel: torch.Tensor, k: int) -> torch.Tensor:
    off = (k - kernel.shape[-1]) // 2
    return F.pad(kernel, (off, off, off, off))


def _identity_kernel(k: int, in_pg: int, out_chs: int) -> torch.Tensor:
    """The OIHW identity kernel of a grouped convolution with out == in
    channels."""
    w = torch.zeros(out_chs, in_pg, k, k)
    o = torch.arange(out_chs)
    w[o, o % in_pg, k // 2, k // 2] = 1.0
    return w


def _identity_bn(sd: Mapping[str, torch.Tensor], bn: str, k: int, in_pg: int, out_chs: int):
    scale = sd[bn + ".weight"] / torch.sqrt(sd[bn + ".running_var"] + BN_EPS)
    return (_identity_kernel(k, in_pg, out_chs) * scale[:, None, None, None],
            sd[bn + ".bias"] - sd[bn + ".running_mean"] * scale)


def _fuse_mobileone(sd: Mapping[str, torch.Tensor], p: str):
    """A MobileOne block at ``p`` -> its ``reparam_conv`` (kernel, bias):
    the k x k branches, the padded scale branch, the identity, in the JAX
    order."""
    kxk = sorted({int(k[len(p) + 10:].split(".")[0]) for k in sd
                  if k.startswith(p + ".conv_kxk.")})
    ref = sd[f"{p}.conv_kxk.{kxk[0]}.conv.weight"]
    out_chs, in_pg, k = ref.shape[0], ref.shape[1], ref.shape[-1]
    w, b = torch.zeros_like(ref), torch.zeros(out_chs)
    for i in kxk:
        wi, bi = _fold_bn(sd[f"{p}.conv_kxk.{i}.conv.weight"], sd, f"{p}.conv_kxk.{i}.bn")
        w, b = w + wi, b + bi
    if p + ".conv_scale.conv.weight" in sd:
        wi, bi = _fold_bn(sd[p + ".conv_scale.conv.weight"], sd, p + ".conv_scale.bn")
        w, b = w + _pad_center(wi, k), b + bi
    if p + ".identity.weight" in sd:
        wi, bi = _identity_bn(sd, p + ".identity", k, in_pg, out_chs)
        w, b = w + wi, b + bi
    return w, b


def fuse_fastvit_state_dict(state_dict: Mapping[str, torch.Tensor], prefix: str = TRUNK
                            ) -> Dict[str, torch.Tensor]:
    """A training-form FastViT trunk's state dict (keys under ``prefix``) ->
    the deploy form's (the module docstring), in fp32; keys outside
    ``prefix`` are kept as they are."""
    sd = {k[len(prefix):]: v.detach().float().cpu() for k, v in state_dict.items()
          if k.startswith(prefix)}
    out = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    fused: Dict[str, torch.Tensor] = {}
    used = set()

    def put(name: str, wb, src: str) -> None:
        """``name``'s weight and bias; the keys under ``src`` consumed, but a
        Squeeze-Excite's, which the deploy form keeps."""
        fused[name + ".weight"], fused[name + ".bias"] = wb
        used.update(k for k in sd if k.startswith(src + ".") and not k.startswith(src + ".se."))

    for p in sorted({k.rsplit(".conv_kxk.", 1)[0] for k in sd if ".conv_kxk." in k}):
        if not p.endswith("token_mixer.mixer"):
            put(p + ".reparam_conv", _fuse_mobileone(sd, p), p)
            continue
        tm = p[:-len(".mixer")]  # RepMixer: x + gamma (mixer(x) - norm(x))
        wm, bm = _fuse_mobileone(sd, p)
        out_chs, in_pg, k = wm.shape[0], wm.shape[1], wm.shape[-1]
        wn, bn = _identity_bn(sd, tm + ".norm.identity", k, in_pg, out_chs)
        gamma = sd[tm + ".layer_scale.gamma"].reshape(-1)
        put(tm + ".reparam_conv", (_identity_kernel(k, in_pg, out_chs)
                                   + gamma[:, None, None, None] * (wm - wn), gamma * (bm - bn)), tm)
    for p in sorted({k.rsplit(".large_conv.", 1)[0] for k in sd if ".large_conv." in k}):
        w, b = _fold_bn(sd[p + ".large_conv.conv.weight"], sd, p + ".large_conv.bn")
        ws, bs = _fold_bn(sd[p + ".small_conv.conv.weight"], sd, p + ".small_conv.bn")
        put(p + ".reparam_conv", (w + _pad_center(ws, w.shape[-1]), b + bs), p)
    for k in sorted(sd):
        if k.endswith(".mlp.conv.conv.weight"):
            p = k[:-len(".conv.weight")]
            put(p, _fold_bn(sd[k], sd, p + ".bn"), p)
        elif re.match(r"^stages\.\d+\.blocks\.\d+\.norm\.running_mean$", k):
            p = k[:-len(".running_mean")]
            scale = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + BN_EPS)
            put(p, (scale, sd[p + ".bias"] - sd[p + ".running_mean"] * scale), p)
        elif k.endswith(".pos_emb.pos_enc.weight"):
            w = sd[k]
            fused[k] = w + _identity_kernel(w.shape[-1], w.shape[1], w.shape[0])
            used.add(k)
    for k, v in sd.items():
        if k not in used and k not in fused:
            fused[k] = v
    leftover = [k for k in fused if "running_" in k]
    if leftover:
        raise ValueError(f"fuse_fastvit_state_dict: BatchNorm left unfolded at {leftover[:5]}")
    out.update({prefix + k: v for k, v in fused.items()})
    return out


def fuse_fastvit(model: nn.Module) -> nn.Module:
    """A copy of ``model`` (a CLIP with a FastViT tower, or the tower) whose
    tower is the deploy form holding ``fuse_fastvit_state_dict``'s weights,
    on ``model``'s device, in eval mode."""
    tower = model if isinstance(model, FastVitTower) else model.visual
    if not isinstance(tower, FastVitTower) or tower.inference_mode:
        raise ValueError("fuse_fastvit takes a training-form FastViT tower or a CLIP holding one")
    device = next(tower.parameters()).device
    fused = FastVitTower(tower.cfg, tower.output_dim, tower.output_tokens, tower.compute_dtype,
                         inference_mode=True)
    fused.load_state_dict(fuse_fastvit_state_dict(tower.state_dict(), "trunk."), strict=True)
    fused = fused.to(device).eval()
    if model is tower:
        return fused
    visual, model.visual = model.visual, None
    try:
        out = copy.deepcopy(model)
    finally:
        model.visual = visual
    out.visual = fused
    return out.eval()
