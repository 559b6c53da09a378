"""EVA02 vision towers (timm ``eva02_*_clip_*``).

The port of the JAX package's ``models/eva02.py``. EVA02's block differs
from the standard ViT's in three ways:

1. a 2D axial rotary position embedding on q and k, the class token left
   as it is (timm's ``RotaryEmbeddingCat``: per-axis frequency bands
   ``1 / 10000 ** (i / bands)``, rotation of interleaved pairs), its
   coordinates rescaled to ``ref_feat_shape`` (16 x 16) so that the 336-px
   tower sees the 224-px one's angles;
2. a SwiGLU MLP, ``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``, whose inner
   LayerNorm (timm ``scale_mlp``) normalises over the whole hidden width;
3. sub-LN in the attention (timm ``scale_attn_inner``): a LayerNorm over
   the merged heads before ``out_proj``.

EVA02-E (``eva02_enormous_*``) has none of them: a GELU MLP of 15360, no
rope, and post-norm blocks (timm ``EvaBlockPostNorm``). Every LayerNorm has
eps 1e-6; GELU is erf under fp32 and tanh under bf16, as the port's other
towers. The attention runs ``ops/attention.py:multi_head_attention`` with
the tower's ``attn_impl``, so on a card it takes the fused kernels (head
dim 64 for B and L, 112 for E, the kernels' ``DP = 128`` path); q, k and v
are made contiguous first, as the kernels take them.

The rope table is computed in float64 numpy and kept as non-persistent
fp32 buffers (``rope_sin``, ``rope_cos``): it is in no state dict, as the
JAX tree has no rope parameter.

Parameter names are the port's own, in the standard ViT's places under
``visual.``: ``conv1.weight``/``bias`` (the biased patch embedding, applied
as a matmul so that fp32 stays off TF32), ``class_embedding``,
``positional_embedding``, ``transformer.resblocks.{i}.{ln_1, attn, ln_2,
mlp}`` with ``attn.in_proj_weight``/``in_proj_bias`` (fused q, k, v),
``attn.norm``, ``attn.out_proj``, ``mlp.fc1_g``, ``mlp.fc1_x``,
``mlp.norm``, ``mlp.fc2`` (or ``mlp.fc1``, ``mlp.fc2``), ``ln_post`` and
the biased ``proj`` Linear (timm's head). ``convert_timm_eva02_state_dict``
maps a timm trunk (``visual.trunk.``: separate ``q_proj``, ``k_proj``
without a bias and ``v_proj``, or E's fused ``qkv`` with ``q_bias`` and
``v_bias``) to these names, and ``eva02_params_to_timm_state_dict`` goes
back, emitting the split projections as the JAX exporter does (a nonzero
key bias raises: no timm key holds it, and under rope dropping it changes
the output).
``convert_eva02_clip_state_dict`` takes a whole open_clip CustomTextCLIP
state dict to the port's CLIP layout (``models/factory.py:load_weights``).

Under a model group (``parallel/tensor.py:shard_module``) the parameters
are placed as the JAX ``_param_spec`` places them: the fused ``in_proj``
split by heads, ``out_proj`` by rows, ``fc1_g``/``fc1_x`` (or ``fc1``)
column- and ``fc2`` row-parallel, every LayerNorm whole. The attention runs
this rank's heads (rope is per head and per position, so it needs no
change); the sub-LN normalises the merged local heads ``[B, L, d/m]`` and
the SwiGLU norm the local hidden ``[B, L, h/m]`` over the whole width
(``split_layer_norm``: statistics summed over the group, this rank's slice
of the whole scale and bias). E's post-norm blocks need only the
column/row pair.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import column_linear, copy_to_model, row_linear, split_layer_norm
from .layers import LayerNorm, _linear, gelu
from .transformer import run_blocks, saved_ops

TRUNK = "visual.trunk."


@dataclasses.dataclass(frozen=True)
class Eva02Cfg:
    width: int
    layers: int
    heads: int
    mlp_hidden: int
    patch_size: int
    image_size: int = 224
    swiglu: bool = True
    rope: bool = True
    subln: bool = True          # sub-LN in attention (scale_attn_inner)
    post_norm: bool = False     # EVA-CLIP-E block style
    ref_feat_shape: Optional[Tuple[int, int]] = (16, 16)
    norm_eps: float = 1e-6
    rope_temperature: float = 10000.0


# timm name -> cfg (hidden = int(width * 4 * 2 / 3) for the SwiGLU towers;
# E has a plain GELU MLP of 15360)
EVA02_DIMS: Dict[str, Eva02Cfg] = {
    "eva02_base_patch16_clip_224": Eva02Cfg(
        width=768, layers=12, heads=12, mlp_hidden=2048, patch_size=16),
    "eva02_large_patch14_clip_224": Eva02Cfg(
        width=1024, layers=24, heads=16, mlp_hidden=2730, patch_size=14),
    "eva02_large_patch14_clip_336": Eva02Cfg(
        width=1024, layers=24, heads=16, mlp_hidden=2730, patch_size=14, image_size=336),
    "eva02_enormous_patch14_clip_224": Eva02Cfg(
        width=1792, layers=64, heads=16, mlp_hidden=15360, patch_size=14, swiglu=False,
        rope=False, subln=False, post_norm=True, ref_feat_shape=None),
}


def build_rope_embed(grid: Tuple[int, int], head_dim: int,
                     ref_feat_shape: Optional[Tuple[int, int]],
                     temperature: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos), each fp32 ``[grid_h * grid_w, head_dim]``, computed in
    float64: half the rotated dims encode y, half x; ``head_dim // 4``
    bands an axis, each repeated for its interleaved pair."""
    num_bands = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(num_bands, dtype=np.float64) / num_bands))
    coords = []
    for axis, size in enumerate(grid):
        t = np.arange(size, dtype=np.float64)
        if ref_feat_shape is not None:
            t = t / size * ref_feat_shape[axis]
        coords.append(t)
    gy, gx = np.meshgrid(coords[0], coords[1], indexing="ij")
    pos = np.stack([gy, gx], axis=-1).reshape(-1, 2)
    ang = (pos[:, :, None] * bands[None, None, :]).reshape(pos.shape[0], -1)
    return (np.repeat(np.sin(ang), 2, axis=-1).astype(np.float32),
            np.repeat(np.cos(ang), 2, axis=-1).astype(np.float32))


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotates the patch tokens of ``x`` [B, H, 1 + N, D] in fp32 (the class
    token at index 0 untouched) and casts back; the result is contiguous."""
    patches = x[:, :, 1:].float()
    rotated = patches * cos + _rotate_pairs(patches) * sin
    return torch.cat([x[:, :, :1], rotated.to(x.dtype)], dim=2)


class Eva02Attention(nn.Module):
    """Fused-QKV attention with rope on q and k and sub-LN before
    ``out_proj``; under a model group (``tp``) this rank's heads."""

    tp = None

    def __init__(self, cfg: Eva02Cfg, attn_impl: str = "auto"):
        super().__init__()
        d = cfg.width
        self.num_heads, self.rope, self.attn_impl = cfg.heads, cfg.rope, attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.norm = LayerNorm(d, cfg.norm_eps) if cfg.subln else None
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, sin: Optional[torch.Tensor] = None,
                cos: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads // (self.tp.world if self.tp else 1)
        qkv = F.linear(copy_to_model(x, self.tp), self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.view(b, l, 3, h, d // self.num_heads).permute(2, 0, 3, 1, 4).unbind(0)
        if self.rope and sin is not None:
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        # the kernels refuse strided views: v (and, without rope, q and k)
        # is one of the split's
        out = multi_head_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   impl=self.attn_impl)
        out = out.transpose(1, 2).reshape(b, l, -1)
        if self.norm is not None:
            out = split_layer_norm(out, self.norm, self.tp)
        return row_linear(out, self.out_proj, self.tp)


class Eva02Mlp(nn.Module):
    """SwiGLU with its inner LayerNorm, or the plain GELU MLP (E); under a
    model group (``tp``) column- then row-parallel."""

    tp = None

    def __init__(self, cfg: Eva02Cfg):
        super().__init__()
        self.swiglu = cfg.swiglu
        if cfg.swiglu:
            self.fc1_g = nn.Linear(cfg.width, cfg.mlp_hidden)
            self.fc1_x = nn.Linear(cfg.width, cfg.mlp_hidden)
            self.norm = LayerNorm(cfg.mlp_hidden, cfg.norm_eps)
        else:
            self.fc1 = nn.Linear(cfg.width, cfg.mlp_hidden)
        self.fc2 = nn.Linear(cfg.mlp_hidden, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            x = copy_to_model(x, self.tp)  # one all-reduce of the gradient for both
            h = split_layer_norm(F.silu(_linear(x, self.fc1_g)) * _linear(x, self.fc1_x),
                                 self.norm, self.tp)
        else:
            h = gelu(column_linear(x, self.fc1, self.tp))
        return row_linear(h, self.fc2, self.tp)


class Eva02Block(nn.Module):
    """Pre-norm, or E's post-norm (the LayerNorm after each sublayer)."""

    def __init__(self, cfg: Eva02Cfg, attn_impl: str = "auto"):
        super().__init__()
        self.post_norm = cfg.post_norm
        self.ln_1 = LayerNorm(cfg.width, cfg.norm_eps)
        self.attn = Eva02Attention(cfg, attn_impl)
        self.ln_2 = LayerNorm(cfg.width, cfg.norm_eps)
        self.mlp = Eva02Mlp(cfg)

    def forward(self, x: torch.Tensor, sin: Optional[torch.Tensor] = None,
                cos: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.post_norm:
            x = x + self.ln_1(self.attn(x, sin, cos))
            return x + self.ln_2(self.mlp(x))
        x = x + self.attn(self.ln_1(x), sin, cos)
        return x + self.mlp(self.ln_2(x))


class Eva02Transformer(nn.Module):
    """The blocks, each recomputed in the backward under ``remat_policy``
    where ``grad_checkpointing`` is on (training under autograd)."""

    def __init__(self, cfg: Eva02Cfg, attn_impl: str, grad_checkpointing: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.resblocks = nn.ModuleList(Eva02Block(cfg, attn_impl) for _ in range(cfg.layers))
        self.grad_checkpointing, self.remat_policy = grad_checkpointing, remat_policy

    def forward(self, x: torch.Tensor, sin: Optional[torch.Tensor],
                cos: Optional[torch.Tensor]) -> torch.Tensor:
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        return run_blocks(self.resblocks, x, remat, self.remat_policy, sin=sin, cos=cos)


class Eva02VisionTower(nn.Module):
    """``tpu/models/eva02.py:Eva02VisionTower``: the biased patch embedding,
    the class token and position table, the blocks, ``ln_post``, the class
    token's row through the biased projection (timm's head is the CLIP
    projection where ``timm_proj`` is null). NHWC images (NCHW accepted)."""

    patch_dropout = None

    def __init__(self, cfg: Eva02Cfg, output_dim: int, output_tokens: bool = False,
                 attn_impl: str = "auto", compute_dtype: torch.dtype = torch.float32,
                 grad_checkpointing: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.cfg = cfg
        self.width, self.heads = cfg.width, cfg.heads
        self.image_size = (cfg.image_size, cfg.image_size)
        self.patch_size = (cfg.patch_size, cfg.patch_size)
        self.grid_size = (cfg.image_size // cfg.patch_size,) * 2
        self.compute_dtype, self.output_tokens = compute_dtype, output_tokens
        n = self.grid_size[0] * self.grid_size[1]
        self.conv1 = nn.Conv2d(3, cfg.width, kernel_size=cfg.patch_size,
                               stride=cfg.patch_size, bias=True)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros(n + 1, cfg.width))
        if cfg.rope:
            sin, cos = build_rope_embed(self.grid_size, cfg.width // cfg.heads,
                                        cfg.ref_feat_shape, cfg.rope_temperature)
            self.register_buffer("rope_sin", torch.tensor(sin), persistent=False)
            self.register_buffer("rope_cos", torch.tensor(cos), persistent=False)
        else:
            self.rope_sin = self.rope_cos = None
        self.transformer = Eva02Transformer(cfg, attn_impl, grad_checkpointing, remat_policy)
        self.ln_post = LayerNorm(cfg.width, cfg.norm_eps)
        self.proj = nn.Linear(cfg.width, output_dim)

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, normal_) -> None:
        """JAX's initialisers for the tower's own tensors (the Linears and
        LayerNorms take ``models/clip.py:init_weights``' rules): the patch
        kernel normal(fan_in^-1/2) with a zero bias, the class token and
        position table normal(0.02), the fused in_proj normal(width^-1/2)."""
        normal_(self.conv1.weight, self.conv1.weight[0].numel() ** -0.5)
        self.conv1.bias.zero_()
        normal_(self.class_embedding, 0.02)
        normal_(self.positional_embedding, 0.02)
        for blk in self.transformer.resblocks:
            normal_(blk.attn.in_proj_weight, self.width ** -0.5)
            blk.attn.in_proj_bias.zero_()

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
        x = x + self.positional_embedding.to(dtype)
        x = self.ln_post(self.transformer(x, self.rope_sin, self.rope_cos))
        pooled = _linear(x[:, 0], self.proj)
        return (pooled, x[:, 1:]) if self.output_tokens else pooled


# ---------------------------------------------------------------------------
# open_clip / timm checkpoints
# ---------------------------------------------------------------------------

# timm block name -> the port's, for the parts that map one to one
_BLOCK = {"norm1": "ln_1", "norm2": "ln_2", "attn.norm": "attn.norm",
          "attn.proj": "attn.out_proj", "mlp.fc1_g": "mlp.fc1_g", "mlp.fc1_x": "mlp.fc1_x",
          "mlp.w1": "mlp.fc1_g", "mlp.w2": "mlp.fc1_x", "mlp.norm": "mlp.norm",
          "mlp.ffn_ln": "mlp.norm", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2",
          "mlp.w3": "mlp.fc2"}
_QKV = ("attn.q_proj.", "attn.k_proj.", "attn.v_proj.", "attn.qkv.", "attn.q_bias",
        "attn.k_bias", "attn.v_bias")


def _rename(rest: str) -> str:
    for src, dst in _BLOCK.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    raise KeyError(rest)


def convert_timm_eva02_state_dict(state_dict: Mapping[str, torch.Tensor], prefix: str = TRUNK
                                  ) -> Dict[str, torch.Tensor]:
    """A timm EVA02 trunk (keys under ``prefix``) -> the port's ``visual.``
    keys; q, k and v fused into ``in_proj_weight``/``in_proj_bias`` (a
    missing key bias is zero), timm's non-learned ``rope`` buffers skipped.
    (``tpu/models/eva02.py:289``.)"""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in state_dict.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        if key == "cls_token":
            out["visual.class_embedding"] = val.reshape(-1)
        elif key == "pos_embed":
            out["visual.positional_embedding"] = val.reshape(val.shape[-2], val.shape[-1])
        elif key.startswith("patch_embed.proj."):
            out["visual.conv1." + key.rsplit(".", 1)[1]] = val
        elif key.startswith("blocks."):
            _, i, rest = key.split(".", 2)
            pre = f"visual.transformer.resblocks.{i}."
            if rest.startswith(_QKV):
                qkv.setdefault(pre, {})[rest] = val
            elif rest.startswith(("gamma_1", "gamma_2")):
                raise KeyError(f"layer-scale EVA02 variants are not supported: {key}")
            else:
                out[pre + _rename(rest)] = val
        elif key.startswith("norm."):
            out["visual.ln_post." + key.split(".", 1)[1]] = val
        elif key.startswith("head."):
            out["visual.proj." + key.split(".", 1)[1]] = val
        elif key.startswith("rope."):
            continue  # recomputed (``build_rope_embed``)
        else:
            raise KeyError(f"unmapped EVA02 key: {prefix}{key}")
    for pre, raw in qkv.items():
        if "attn.qkv.weight" in raw:
            weight = raw["attn.qkv.weight"]
            if "attn.q_bias" in raw:
                q_b = raw["attn.q_bias"]
                bias = torch.cat([q_b, torch.zeros_like(q_b), raw["attn.v_bias"]])
            else:
                bias = raw.get("attn.qkv.bias", weight.new_zeros(weight.shape[0]))
        else:
            ws = [raw[f"attn.{p}_proj.weight"] for p in "qkv"]
            weight = torch.cat(ws)
            bias = torch.cat([raw.get(f"attn.{p}_proj.bias", w.new_zeros(w.shape[0]))
                              for p, w in zip("qkv", ws)])
        out[pre + "attn.in_proj_weight"] = weight
        out[pre + "attn.in_proj_bias"] = bias
    return out


def eva02_params_to_timm_state_dict(state_dict: Mapping[str, torch.Tensor],
                                    prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """The port's EVA02 ``visual.`` keys -> timm's under ``prefix``: split
    ``q_proj``, ``k_proj`` (no bias) and ``v_proj``, as the JAX exporter
    writes them (``tpu/models/eva02.py:415``). timm's layout has no key
    bias, so a nonzero one raises: the JAX exporter drops it, which softmax
    over the keys cancels without rope but not under rope, whose rotation
    differs by position (ROADMAP Queue 3, JAX list)."""
    back = {v: k for k, v in _BLOCK.items() if not k.startswith("mlp.w") and k != "mlp.ffn_ln"}
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if not key.startswith("visual."):
            continue
        key = key[len("visual."):]
        if key == "class_embedding":
            out[prefix + "cls_token"] = val.reshape(1, 1, -1)
        elif key == "positional_embedding":
            out[prefix + "pos_embed"] = val.reshape(1, *val.shape)
        elif key.startswith("conv1."):
            out[prefix + "patch_embed.proj." + key.split(".", 1)[1]] = val
        elif key.startswith("transformer.resblocks."):
            i, rest = key[len("transformer.resblocks."):].split(".", 1)
            pre = f"{prefix}blocks.{i}."
            if rest == "attn.in_proj_weight":
                for p, w in zip("qkv", val.chunk(3)):
                    out[f"{pre}attn.{p}_proj.weight"] = w
            elif rest == "attn.in_proj_bias":
                q_b, k_b, v_b = val.chunk(3)
                if bool(k_b.any()):
                    raise ValueError(f"visual.{key}: a nonzero key bias has no place in timm's "
                                     "EVA02 layout")
                out[pre + "attn.q_proj.bias"], out[pre + "attn.v_proj.bias"] = q_b, v_b
            else:
                name, leaf = rest.rsplit(".", 1)
                out[f"{pre}{back[name]}.{leaf}"] = val
        elif key.startswith("ln_post."):
            out[prefix + "norm." + key.split(".", 1)[1]] = val
        elif key.startswith("proj."):
            out[prefix + "head." + key.split(".", 1)[1]] = val
        else:
            raise KeyError(f"visual.{key}")
    return out


def convert_eva02_clip_state_dict(state_dict: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    """An open_clip CustomTextCLIP state dict with a timm EVA02 trunk -> the
    port's CLIP keys: the trunk converted, ``text.`` taken to the top level,
    the rest kept."""
    out = convert_timm_eva02_state_dict(state_dict)
    for k, v in state_dict.items():
        if k.startswith(TRUNK):
            continue
        out[k[len("text."):] if k.startswith("text.") else k] = v
    return out
