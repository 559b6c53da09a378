"""ModifiedResNet vision tower (OpenAI's RN50 family) as ``nn.Module``s.

The port of the JAX package's ``models/resnet.py`` in open_clip's torch
layout (``modified_resnet.py``): a three-convolution stem (``conv1`` is
stride 2 with symmetric (1, 1) padding) and a 2 x 2 average pool, four
stages of ``Bottleneck`` blocks whose stride is an average pool after
``conv2`` (and, in the ``downsample`` branch, before its 1 x 1
convolution: ``downsample.-1`` pool, ``.0`` convolution, ``.1`` norm), then
``AttentionPool2d``: the mean token joined to the HW tokens, a positional
table, and one query, the mean token's, over all HW + 1 keys through the
port's attention (the fused kernel on a CUDA tensor). Images are NCHW
inside; NHWC is accepted at the boundary.

``BatchNorm2d`` follows flax's ``nn.BatchNorm``, the JAX package's, not
``torch.nn.BatchNorm2d``: the statistics are reduced in fp32, the biased
batch variance ``max(0, E[x^2] - E[x]^2)`` both normalises the batch and
updates the running variance, the running update is ``0.99 * running +
0.01 * batch`` (flax's ``momentum=0.99``, torch's ``0.01``), eps 1e-5, the
output in the input's dtype. The running statistics are the buffers
``running_mean`` and ``running_var`` (open_clip's names); there is no
``num_batches_tracked`` (the JAX package neither writes nor reads it;
``models/factory.py:load_weights`` drops it from a checkpoint).

A tower normalises with its running statistics and never changes them (the
JAX ``deterministic=True`` default) unless ``batch_norm_mode(model,
train=True)`` is in force, as the train step sets it: then every
``BatchNorm2d`` normalises with the batch's statistics and updates its
running ones once a forward. With a ``group`` (the data axis), the per-channel
mean and mean square are averaged over the group's ranks, forward and
backward (``_AllReduceMean``): the statistics of the global batch, as GSPMD
reduces them over every row of the JAX step. Inside ``running_stats_kept()``
the batch's statistics still normalise but the running ones are left as they
are: the recompute of a checkpointed block (``models/fastvit.py``) runs its
norms a second time, and the JAX ``nn.remat`` updates them once.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import _linear

BN_MOMENTUM, BN_EPS = 0.99, 1e-5  # flax nn.BatchNorm's defaults
_KEPT = threading.local()  # running_stats_kept's depth, per thread


class _AllReduceMean(torch.autograd.Function):
    """The mean over ``group``'s ranks; its backward is the mean of the
    cotangents (each rank's loss reads every rank's statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW (the module docstring)."""

    def __init__(self, num_features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.train_stats = False  # set by batch_norm_mode
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.train_stats:
            moments = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
            if self.group is not None and dist.get_world_size(self.group) > 1:
                moments = _AllReduceMean.apply(moments, self.group)
            mean, mean2 = moments[0], moments[1]
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if getattr(_KEPT, "depth", 0) == 0:
                self._update(mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean.float() + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var.float() + (1 - m) * var)


@contextlib.contextmanager
def running_stats_kept():
    """Inside (on this thread), ``BatchNorm2d`` in training mode normalises
    with the batch's statistics and leaves its running ones as they are."""
    _KEPT.depth = getattr(_KEPT, "depth", 0) + 1
    try:
        yield
    finally:
        _KEPT.depth -= 1


@contextlib.contextmanager
def batch_norm_mode(model: nn.Module, train: bool, group=None):
    """Inside, every ``BatchNorm2d`` of ``model`` normalises with the batch's
    statistics and updates its running ones (``train``), over the rows of
    every rank of ``group``; or, not ``train``, with its running ones. The
    modes before are restored on leaving."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    before = [(m.train_stats, m.group) for m in norms]
    for m in norms:
        m.train_stats, m.group = train, group
    try:
        yield
    finally:
        for m, (t, g) in zip(norms, before):
            m.train_stats, m.group = t, g


def has_batch_norm(model: nn.Module) -> bool:
    return any(isinstance(m, BatchNorm2d) for m in model.modules())


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on ``x`` with its weight (and bias) cast to ``x``'s dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k == 1 else F.avg_pool2d(x, k)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool) -> 1x1 with BatchNorm and ReLU, and the
    downsample branch (avg pool -> 1x1 -> BatchNorm) where the stride or the
    width changes (``tpu/models/resnet.py:30-61``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.stride = stride
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, out, 1, bias=False)),
                ("1", BatchNorm2d(out)),
            ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = F.relu(self.bn2(_conv(out, self.conv2)))
        out = self.bn3(_conv(_avg_pool(out, self.stride), self.conv3))
        identity = x
        if self.downsample is not None:
            ds = self.downsample
            identity = getattr(ds, "1")(_conv(_avg_pool(x, self.stride), getattr(ds, "0")))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The mean token's query over the HW + 1 tokens (``tpu/models/
    resnet.py:64-105``): only ``tokens[:, :1]`` goes through ``q_proj``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, attn_impl: str = "auto"):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)
        self.num_heads, self.attn_impl = num_heads, attn_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        h, dh = self.num_heads, c // self.num_heads

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, -1, h, dh).transpose(1, 2).contiguous()

        q = heads(_linear(tokens[:, :1], self.q_proj))
        k = heads(_linear(tokens, self.k_proj))
        v = heads(_linear(tokens, self.v_proj))
        out = multi_head_attention(q, k, v, impl=self.attn_impl)
        out = out.transpose(1, 2).reshape(b, 1, c)
        return _linear(out, self.c_proj)[:, 0]


class ModifiedResNet(nn.Module):
    """The stem, four Bottleneck stages and the attention pool
    (``tpu/models/resnet.py:108-163``); ``compute_dtype`` is the dtype the
    tower computes in (parameters stay fp32)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 image_size: int = 224, width: int = 64, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.image_size = (image_size, image_size)
        half = width // 2
        self.conv1 = nn.Conv2d(3, half, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(half)
        self.conv2 = nn.Conv2d(half, half, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(half)
        self.conv3 = nn.Conv2d(half, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(width)
        inplanes = width
        for stage, n_blocks in enumerate(layers, start=1):
            planes = width * 2 ** (stage - 1)
            blocks = []
            for i in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, 1 if stage == 1 or i else 2))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads, output_dim,
                                        attn_impl)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        """No per-block recompute: the JAX tower has none."""

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """Convolutions normal(fan_in^-1/2), BatchNorm at 1/0 with running
        statistics 0/1, the pool's positions normal(width^-1/2) (its Linear
        layers are ``models/clip.py:init_weights``')."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        pos = self.attnpool.positional_embedding
        normal_(pos, pos.shape[1] ** -0.5)

    def forward(self, x: torch.Tensor, patch_dropout_generator=None) -> torch.Tensor:
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        x = x.to(self.compute_dtype)
        x = F.relu(self.bn1(_conv(x, self.conv1)))
        x = F.relu(self.bn2(_conv(x, self.conv2)))
        x = F.relu(self.bn3(_conv(x, self.conv3)))
        x = F.avg_pool2d(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)
