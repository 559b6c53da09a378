"""The Swin Transformer vision tower (timm ``swin_base_patch4_window7_224``).

The port of the JAX package's ``models/swin.py`` (Swin v1, Liu et al., ICCV
2021): a biased 4x4/4 patch embedding and its LayerNorm; stages of blocks
whose attention runs inside windows of ``window x window`` tokens with a
learned relative-position bias (a table of ``(2 window - 1)^2`` rows by
heads), every odd block on windows cyclically shifted by half a window with
the cross-window mask (-100 between tokens from different regions); patch
merging between stages (the 2x2 neighbours concatenated in the order (0,
0), (1, 0), (0, 1), (1, 1), a LayerNorm, a bias-free reduction to twice the
width); a final LayerNorm, the mean over tokens and the projection
(``head``, biased where ``timm_proj_bias`` says). A stage whose grid is no
larger than the window runs one full window with no shift (the last stage
at 224 px is 7x7); a grid that the window does not divide raises, with the
JAX tower's message. LayerNorm eps 1e-5 with fp32 statistics; GELU by the
repo's rule (erf in fp32, tanh in bf16).

Every window attention carries an additive mask (the bias ``[1, H, N, N]``,
plus on shifted blocks the cyclic mask tiled over the windows of the
batch), so it goes through ``ops/attention.py:multi_head_attention`` with
``mask=`` and never through the fused kernels, as the JAX tower's does:
plain attention in fp32, and under bf16 ``"xla_bf16_bwd"`` (the JAX
package's bf16 backward, which gives the learned table its cotangent)
unless the tower was built with ``"xla"``. The shifted-window masks are
built once per shape with numpy (non-persistent buffers).

Parameter names are timm's under the tower's ``trunk`` (``visual.trunk.`` in
a CLIP), as the JAX exporter writes them (``tpu/models/swin.py:466``):
``patch_embed.{proj, norm}``, ``layers.S.blocks.B.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.S.downsample.{norm, reduction}`` (the merge after stage S),
``norm`` and ``head``. ``convert_timm_swin_state_dict`` and
``convert_hf_swin_state_dict`` are the ports of the JAX package's two
importers (timm's layout, and HF ``SwinModel``'s with separate query, key
and value).

Under a model group (``parallel/tensor.py:shard_module``) each block's
``attn.qkv`` holds this rank's heads and ``attn.proj`` its columns,
``mlp.fc1``/``mlp.fc2`` are a column/row pair, and each table stays whole,
feeding its rank's heads' columns (``model_slice``); the patch embedding
and ``downsample.reduction`` stay whole, as they match no JAX pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import column_linear, copy_to_model, model_slice, row_linear
from .layers import LayerNorm, _linear, gelu
from .resnet import _conv
from .transformer import run_blocks, saved_ops

TRUNK = "visual.trunk."


@dataclasses.dataclass(frozen=True)
class SwinCfg:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    norm_eps: float = 1e-5

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


SWIN_DIMS: Dict[str, SwinCfg] = {
    "swin_base_patch4_window7_224": SwinCfg(embed_dim=128, depths=(2, 2, 18, 2),
                                            num_heads=(4, 8, 16, 32)),
}


def rel_pos_index(window: int) -> np.ndarray:
    """[w*w, w*w] rows of the ``(2w-1)^2`` bias table (the official scheme)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B nW, w*w, C]."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """[B nW, w*w, C] -> [B, H, W, C]."""
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, -1)


def shift_attn_mask(h: int, wd: int, w: int, shift: int) -> np.ndarray:
    """The additive [nW, w*w, w*w] mask of shifted windows: -100 between
    tokens of different regions, 0 within one."""
    img = np.zeros((1, h, wd, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, h // w, w, wd // w, w, 1).transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Fused-QKV attention inside windows with the learned relative-position
    bias; under a model group (``tp``) this rank's heads and their columns
    of the whole table."""

    tp = None

    def __init__(self, dim: int, heads: int, window: int, qkv_bias: bool = True,
                 attn_impl: str = "auto"):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} is not divisible by {heads} heads")
        self.num_heads, self.attn_impl = heads, attn_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rel_pos_index(window).reshape(-1)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        nwb, n, c = x.shape
        heads = self.num_heads // (self.tp.world if self.tp else 1)
        bias = None if self.qkv.bias is None else self.qkv.bias.to(x.dtype)
        qkv = F.linear(copy_to_model(x, self.tp), self.qkv.weight.to(x.dtype), bias)
        q, k, v = qkv.view(nwb, n, 3, heads, c // self.num_heads).permute(
            2, 0, 3, 1, 4).contiguous().unbind(0)
        table = model_slice(self.relative_position_bias_table, 1, self.tp)
        add = table[self.relative_position_index].reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:  # [nW, N, N] tiled over the batch's windows
            add = add + mask.repeat(nwb // mask.shape[0], 1, 1)[:, None]
        impl = ("xla_bf16_bwd" if x.dtype == torch.bfloat16 and self.attn_impl != "xla"
                else "xla")
        out = multi_head_attention(q, k, v, mask=add, impl=impl)
        return row_linear(out.transpose(1, 2).reshape(nwb, n, -1), self.proj, self.tp)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2; under a model group (``tp``) column- then
    row-parallel."""

    tp = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_linear(gelu(column_linear(x, self.fc1, self.tp)), self.fc2, self.tp)


class SwinBlock(nn.Module):
    """LayerNorm -> (shifted) window attention -> residual; LayerNorm -> MLP
    -> residual."""

    def __init__(self, dim: int, heads: int, input_hw: Tuple[int, int], window: int, shift: int,
                 mlp_ratio: float, qkv_bias: bool, norm_eps: float, attn_impl: str = "auto"):
        super().__init__()
        self.input_hw, self.window, self.shift = input_hw, window, shift
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = WindowAttention(dim, heads, window, qkv_bias, attn_impl)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = shift_attn_mask(*input_hw, window, shift) if shift > 0 else None
        self.register_buffer("shift_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, wd), w, s = self.input_hw, self.window, self.shift
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, wd, c)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, w), self.shift_mask), w, h, wd)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """The 2x2 neighbours concatenated, a LayerNorm, the bias-free reduction
    to twice the width."""

    def __init__(self, dim: int, input_hw: Tuple[int, int], norm_eps: float):
        super().__init__()
        self.input_hw = input_hw
        self.norm = LayerNorm(4 * dim, norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, wd), (b, l, c) = self.input_hw, x.shape
        x = x.reshape(b, h, wd, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, l // 4, 4 * c)
        return _linear(self.norm(x), self.reduction)


class _Stage(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinVisionTower(nn.Module):
    """``tpu/models/swin.py:SwinVisionTower`` (the module docstring).
    ``output_tokens`` also returns the final tokens (after ``norm``)."""

    patch_dropout = None

    def __init__(self, cfg: SwinCfg, output_dim: int, proj_bias: bool = False,
                 output_tokens: bool = False, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        # the window must divide every stage grid it is smaller than (no
        # padding to window multiples, as in JAX)
        g = cfg.image_size // cfg.patch_size
        for _ in range(len(cfg.depths)):
            if min(g, cfg.window_size) < g and g % cfg.window_size != 0:
                raise ValueError(
                    f"Swin image_size {cfg.image_size}: stage grid {g} is not "
                    f"divisible by window {cfg.window_size}; use a size whose "
                    "stage grids divide the window (e.g. 224 for window 7)")
            g //= 2
        self.cfg, self.output_tokens, self.compute_dtype = cfg, output_tokens, compute_dtype
        self.image_size = (cfg.image_size, cfg.image_size)
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy
        eps, grid = cfg.norm_eps, cfg.image_size // cfg.patch_size
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)
        self.trunk.patch_embed.norm = LayerNorm(cfg.embed_dim, eps)
        hw, dim, stages = (grid, grid), cfg.embed_dim, []
        for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            # a window no smaller than the map: one full window, no shift
            win = min(cfg.window_size, min(hw))
            no_shift = min(hw) <= cfg.window_size
            blocks = [SwinBlock(dim, heads, hw, win, 0 if (bi % 2 == 0 or no_shift) else win // 2,
                                cfg.mlp_ratio, cfg.qkv_bias, eps, attn_impl)
                      for bi in range(depth)]
            last = si == len(cfg.depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(dim, hw, eps)))
            if not last:
                hw, dim = (hw[0] // 2, hw[1] // 2), dim * 2
        self.trunk.layers = nn.ModuleList(stages)
        self.trunk.norm = LayerNorm(dim, eps)
        self.trunk.head = nn.Linear(dim, output_dim, bias=proj_bias)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """The patch kernel normal(fan_in^-1/2) with a zero bias, the fused
        ``qkv`` normal(width^-1/2) with a zero bias, the tables normal(0.02);
        the LayerNorms and other Linears are ``models/clip.py:init_weights``'."""
        conv = self.trunk.patch_embed.proj
        normal_(conv.weight, conv.weight[0].numel() ** -0.5)
        conv.bias.zero_()
        for m in self.modules():
            if isinstance(m, WindowAttention):
                normal_(m.relative_position_bias_table, 0.02)

    def forward(self, x: torch.Tensor, patch_dropout_generator: Optional[torch.Generator] = None):
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        if tuple(x.shape[2:]) != self.image_size:
            raise ValueError(f"expected {self.image_size} images, got {tuple(x.shape)}")
        x = _conv(x.to(self.compute_dtype), self.trunk.patch_embed.proj)
        x = self.trunk.patch_embed.norm(x.flatten(2).transpose(1, 2))
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        for stage in self.trunk.layers:
            x = run_blocks(stage.blocks, x, remat, self.remat_policy)
            if stage.downsample is not None:
                x = stage.downsample(x)
        tokens = self.trunk.norm(x)
        pooled = _linear(tokens.mean(dim=1), self.trunk.head)
        return (pooled, tokens) if self.output_tokens else pooled


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _leaf(name: str) -> str:
    return "weight" if name == "weight" else "bias"


def convert_hf_swin_state_dict(state_dict: Mapping[str, torch.Tensor],
                               prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """An HF ``SwinModel`` state dict -> the port's keys under ``prefix``
    (``tpu/models/swin.py:convert_hf_swin_state_dict``): query, key and
    value fused into ``qkv``, ``relative_position_index`` and the pooler
    skipped, any other unknown key a ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in state_dict.items():
        k = key.replace("swin.", "")
        parts = k.split(".")
        if k.startswith("embeddings.patch_embeddings.projection."):
            out[f"{prefix}patch_embed.proj.{parts[-1]}"] = val
        elif k.startswith("embeddings.norm."):
            out[f"{prefix}patch_embed.norm.{_leaf(parts[-1])}"] = val
        elif k.startswith("layernorm."):
            out[f"{prefix}norm.{_leaf(parts[-1])}"] = val
        elif parts[0] == "encoder" and parts[1] == "layers":
            si = int(parts[2])
            if parts[3] == "blocks":
                blk, rest = f"{prefix}layers.{si}.blocks.{int(parts[4])}", parts[5:]
                if rest[0] in ("layernorm_before", "layernorm_after"):
                    norm = "norm1" if rest[0] == "layernorm_before" else "norm2"
                    out[f"{blk}.{norm}.{_leaf(rest[1])}"] = val
                elif rest[0] == "attention":
                    if rest[1] == "self" and rest[2] in ("query", "key", "value"):
                        qkv.setdefault(blk, {})[f"{rest[2]}.{rest[3]}"] = val
                    elif rest[1] == "self" and rest[2] == "relative_position_bias_table":
                        out[f"{blk}.attn.relative_position_bias_table"] = val
                    elif rest[1] == "self" and rest[2] == "relative_position_index":
                        pass  # recomputed
                    elif rest[1] == "output" and rest[2] == "dense":
                        out[f"{blk}.attn.proj.{_leaf(rest[3])}"] = val
                    else:
                        raise KeyError(key)
                elif rest[0] == "intermediate":
                    out[f"{blk}.mlp.fc1.{_leaf(rest[2])}"] = val
                elif rest[0] == "output":
                    out[f"{blk}.mlp.fc2.{_leaf(rest[2])}"] = val
                else:
                    raise KeyError(key)
            elif parts[3] == "downsample":
                ds = f"{prefix}layers.{si}.downsample"
                if parts[4] == "reduction":
                    out[f"{ds}.reduction.weight"] = val
                elif parts[4] == "norm":
                    out[f"{ds}.norm.{_leaf(parts[5])}"] = val
                else:
                    raise KeyError(key)
            else:
                raise KeyError(key)
        elif parts[0] == "pooler":
            pass  # HF's pooler head is not used
        else:
            raise KeyError(key)
    for blk, d in qkv.items():
        out[f"{blk}.attn.qkv.weight"] = torch.cat(
            [d["query.weight"], d["key.weight"], d["value.weight"]])
        out[f"{blk}.attn.qkv.bias"] = torch.cat([d["query.bias"], d["key.bias"], d["value.bias"]])
    return out


def convert_timm_swin_state_dict(state_dict: Mapping[str, torch.Tensor],
                                 prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """timm's Swin layout (keys under ``prefix``) -> the port's keys under
    ``prefix`` (``tpu/models/swin.py:convert_timm_swin_state_dict``):
    ``relative_position_index`` dropped, any unknown key a ``KeyError``;
    keys outside ``prefix`` are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        parts = k.split(".")
        if k in ("patch_embed.proj.weight", "patch_embed.proj.bias"):
            out[key] = val
        elif k.startswith("patch_embed.norm."):
            out[f"{prefix}patch_embed.norm.{_leaf(parts[-1])}"] = val
        elif parts[0] == "layers":
            si = int(parts[1])
            if parts[2] == "blocks":
                blk, rest = f"{prefix}layers.{si}.blocks.{int(parts[3])}", parts[4:]
                if rest[0] in ("norm1", "norm2"):
                    out[f"{blk}.{rest[0]}.{_leaf(rest[1])}"] = val
                elif rest[0] == "attn":
                    if rest[1] in ("qkv", "proj"):
                        out[f"{blk}.attn.{rest[1]}.{_leaf(rest[2])}"] = val
                    elif rest[1] == "relative_position_bias_table":
                        out[f"{blk}.attn.relative_position_bias_table"] = val
                    elif rest[1] != "relative_position_index":
                        raise KeyError(key)
                elif rest[0] == "mlp":
                    out[f"{blk}.mlp.{rest[1]}.{_leaf(rest[2])}"] = val
                else:
                    raise KeyError(key)
            elif parts[2] == "downsample":
                ds = f"{prefix}layers.{si}.downsample"
                if parts[3] == "reduction":
                    out[f"{ds}.reduction.weight"] = val
                elif parts[3] == "norm":
                    out[f"{ds}.norm.{_leaf(parts[4])}"] = val
                else:
                    raise KeyError(key)
            else:
                raise KeyError(key)
        elif parts[0] == "norm":
            out[f"{prefix}norm.{_leaf(parts[1])}"] = val
        elif parts[0] == "head":
            out[f"{prefix}head.{_leaf(parts[1])}"] = val
        else:
            raise KeyError(key)
    return out


def convert_swin_clip_state_dict(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """An open_clip file with a timm Swin trunk -> the port's keys: the trunk
    through ``convert_timm_swin_state_dict``, the rest kept."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(TRUNK)}
    out.update(convert_timm_swin_state_dict(state_dict))
    return out
