"""DINOv2 vision transformer: the frozen structural teacher.

The port of the JAX package's ``models/dinov2.py``: a patch-14 ViT with a
CLS token and a learned position table (resized bicubically off its native
grid), pre-LN blocks with LayerScale, LayerNorm at eps 1e-6 with fp32
statistics, CLS features out. The giant variant's SwiGLU FFN is built too.

Parameter names are HF ``Dinov2Model``'s state-dict keys, so an HF
checkpoint loads with ``strict=True`` once ``embeddings.mask_token`` (unused
here, skipped by the JAX converter too) is dropped. ``load_dinov2_model``
reads such a checkpoint from a local directory or a hub-cache snapshot; it
never downloads.

Numerics, as the JAX module:

* Images are NCHW (NHWC is accepted and transposed once), cast to the
  compute dtype; the 14x14 stride-14 patch convolution runs as a reshape and
  one matmul over ``projection.weight`` (in fp32 that keeps it off cuDNN's
  TF32 convolutions).
* The CLS token and the position table stay fp32; the table is resized in
  fp32 when the grid differs from the checkpoint's (``F.interpolate``
  bicubic with ``antialias=True``: that is ``jax.image.resize(..., "cubic")``,
  which antialiases when it shrinks, to fp32 rounding; without antialias the
  37 -> 16 resize of every 224-px call differs by O(1)), then cast.
* GELU is erf under fp32 and tanh under bf16 (``layers.gelu``).
* Under a model group (``parallel/tensor.py:shard_module``) the attention
  and the MLP run on this rank's heads and columns.
* Attention goes through ``ops.attention.multi_head_attention`` with the
  module's ``attn_impl``, whose default is ``"xla"`` as in JAX; the loader
  defaults to the port's ``"auto"`` (the fused kernel on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import column_linear, copy_to_model, row_linear
from .factory import _resolve_device
from .layers import LayerNorm, _linear, gelu
from .pretrained import hub_snapshot_dirs

# name -> (hidden, layers, heads, swiglu)
DINOV2_CONFIGS = {
    "facebook/dinov2-small": (384, 12, 6, False),
    "facebook/dinov2-base": (768, 12, 12, False),
    "facebook/dinov2-large": (1024, 24, 16, False),
    "facebook/dinov2-giant": (1536, 40, 24, True),
}
# HF keys the port's module does not hold
_SKIPPED_KEYS = ("embeddings.mask_token",)


@dataclasses.dataclass(frozen=True)
class Dinov2Cfg:
    hidden_size: int = 384
    layers: int = 12
    heads: int = 6
    patch_size: int = 14
    mlp_ratio: float = 4.0
    layerscale_value: float = 1.0
    norm_eps: float = 1e-6
    use_swiglu_ffn: bool = False
    # resolution the checkpoint's position table was trained at
    native_image_size: int = 224


def dinov2_cfg_from_name(name: str) -> Dinov2Cfg:
    hidden, layers, heads, swiglu = DINOV2_CONFIGS[name]
    return Dinov2Cfg(hidden_size=hidden, layers=layers, heads=heads, use_swiglu_ffn=swiglu)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1.to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)


class _SelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, dim)


class _Attention(nn.Module):
    """HF's separate query, key and value Linears; the attention core wants
    contiguous [B, H, L, Dh] tensors. Under a model group (``tp``) each
    Linear holds this rank's heads and ``output.dense`` its columns."""

    tp = None

    def __init__(self, dim: int, heads: int, attn_impl: str):
        super().__init__()
        self.heads = heads
        self.attn_impl = attn_impl
        self.attention = _SelfAttention(dim)
        self.output = _SelfOutput(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        heads, dh = self.heads // (self.tp.world if self.tp else 1), d // self.heads
        x = copy_to_model(x, self.tp)

        def split(layer):
            return _linear(x, layer).view(b, l, heads, dh).transpose(1, 2).contiguous()

        a = self.attention
        out = multi_head_attention(split(a.query), split(a.key), split(a.value),
                                   impl=self.attn_impl)
        return row_linear(out.transpose(1, 2).reshape(b, l, heads * dh), self.output.dense,
                          self.tp)


class _Mlp(nn.Module):
    tp = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_linear(gelu(column_linear(x, self.fc1, self.tp)), self.fc2, self.tp)


class _SwiGLUFFN(nn.Module):
    """``weights_in`` packs the gate and the value; under a model group each
    rank holds its rows of both (``parallel/tensor.py:Split(0, packs=2)``)."""

    tp = None

    def __init__(self, dim: int, hidden_features: int):
        super().__init__()
        h = (int(hidden_features * 2 / 3) + 7) // 8 * 8  # dinov2 rounding
        self.weights_in = nn.Linear(dim, 2 * h)
        self.weights_out = nn.Linear(h, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = column_linear(x, self.weights_in, self.tp).chunk(2, dim=-1)
        return row_linear(F.silu(x1) * x2, self.weights_out, self.tp)


class Dinov2Block(nn.Module):
    """Pre-LN: ``x + ls1(attn(norm1(x)))`` then ``x + ls2(mlp(norm2(x)))``."""

    def __init__(self, cfg: Dinov2Cfg, attn_impl: str = "xla"):
        super().__init__()
        d, hidden = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        self.norm1 = LayerNorm(d, cfg.norm_eps)
        self.attention = _Attention(d, cfg.heads, attn_impl)
        self.layer_scale1 = _LayerScale(d, cfg.layerscale_value)
        self.norm2 = LayerNorm(d, cfg.norm_eps)
        self.mlp = _SwiGLUFFN(d, hidden) if cfg.use_swiglu_ffn else _Mlp(d, hidden)
        self.layer_scale2 = _LayerScale(d, cfg.layerscale_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.layer_scale1(self.attention(self.norm1(x)))
        return x + self.layer_scale2(self.mlp(self.norm2(x)))


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: Dinov2Cfg):
        super().__init__()
        p = cfg.patch_size
        self.projection = nn.Conv2d(3, cfg.hidden_size, kernel_size=p, stride=p)


class _Embeddings(nn.Module):
    def __init__(self, cfg: Dinov2Cfg):
        super().__init__()
        native = cfg.native_image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, native * native + 1, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: Dinov2Cfg, attn_impl: str):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Block(cfg, attn_impl) for _ in range(cfg.layers))


def resize_position_table(grid: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[n, n, D] fp32 position grid -> [gh, gw, D], bicubic with antialias
    (``jax.image.resize(..., "cubic")``)."""
    out = F.interpolate(grid.permute(2, 0, 1)[None], size=size, mode="bicubic",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0)


class Dinov2(nn.Module):
    """DINOv2 over NCHW (or NHWC) images, already ImageNet-normalised.
    ``forward`` returns CLS features [B, D], or ``(cls, tokens)`` with
    ``output_tokens``, in the compute dtype ``dtype``; parameters are fp32."""

    def __init__(self, cfg: Dinov2Cfg = Dinov2Cfg(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, attn_impl)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.norm_eps)

    def _positions(self, gh: int, gw: int) -> torch.Tensor:
        c = self.cfg
        native = c.native_image_size // c.patch_size
        pos = self.embeddings.position_embeddings[0].float()
        if (gh, gw) == (native, native):
            return pos
        grid = resize_position_table(pos[1:].reshape(native, native, -1), (gh, gw))
        return torch.cat([pos[:1], grid.reshape(gh * gw, -1)], dim=0)

    def forward(self, pixel_values: torch.Tensor, output_tokens: bool = False):
        c, p = self.cfg, self.cfg.patch_size
        x = pixel_values
        if x.shape[-1] == 3 and x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC at the boundary
        x = x.to(self.dtype)
        b, _, h, w = x.shape
        gh, gw = h // p, w // p
        # the VALID stride-p convolution as a matmul over (channel, row, col)
        patches = x[:, :, :gh * p, :gw * p].reshape(b, 3, gh, p, gw, p)
        patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, 3 * p * p)
        proj = self.embeddings.patch_embeddings.projection
        x = F.linear(patches, proj.weight.reshape(c.hidden_size, -1).to(x.dtype),
                     proj.bias.to(x.dtype))
        cls = self.embeddings.cls_token.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self._positions(gh, gw).to(x.dtype)
        for blk in self.encoder.layer:
            x = blk(x)
        x = self.layernorm(x)
        if output_tokens:
            return x[:, 0], x[:, 1:]
        return x[:, 0]

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Dinov2":
        """Seeded random init on the parameters' device: matmul and patch
        weights, the CLS token and the position table normal(0.02), biases
        0, LayerNorms 1/0, LayerScale at ``layerscale_value`` (HF's
        ``Dinov2PreTrainedModel`` init, without the truncation)."""
        dev = self.embeddings.cls_token.device
        g = torch.Generator(device=dev).manual_seed(int(seed))
        for name, prm in self.named_parameters():
            if name.endswith("lambda1"):
                prm.fill_(self.cfg.layerscale_value)
            elif isinstance(self.get_submodule(name.rsplit(".", 1)[0]), LayerNorm):
                prm.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                prm.zero_()
            else:
                prm.copy_(torch.randn(prm.shape, generator=g, device=dev) * 0.02)
        return self


def _config_from_hf(hf: Dict) -> Dinov2Cfg:
    return Dinov2Cfg(
        hidden_size=int(hf["hidden_size"]), layers=int(hf["num_hidden_layers"]),
        heads=int(hf["num_attention_heads"]), patch_size=int(hf.get("patch_size", 14)),
        mlp_ratio=float(hf.get("mlp_ratio", 4.0)),
        layerscale_value=float(hf.get("layerscale_value", 1.0)),
        norm_eps=float(hf.get("layer_norm_eps", 1e-6)),
        use_swiglu_ffn=bool(hf.get("use_swiglu_ffn", False)),
        native_image_size=int(hf.get("image_size", 224)),
    )


def _checkpoint_dirs(model_name: str, cache_dir: Optional[str]):
    """Where ``model_name`` may lie: itself as a directory, then its hub-cache
    snapshots under ``cache_dir`` (``pretrained.hub_snapshot_dirs``)."""
    dirs = [model_name]
    if cache_dir:
        snaps = os.path.join(cache_dir, "models--" + model_name.replace("/", "--"), "snapshots")
        dirs += hub_snapshot_dirs(model_name, cache_dir) or [os.path.join(snaps, "*")]
    return dirs


def _read_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    st = os.path.join(directory, "model.safetensors")
    bin_path = os.path.join(directory, "pytorch_model.bin")
    if os.path.isfile(st):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            if not os.path.isfile(bin_path):
                raise NotImplementedError(
                    f"{st}: reading .safetensors needs the safetensors package, which this "
                    "environment lacks; save the teacher as pytorch_model.bin") from e
        else:
            return load_file(st)
    return torch.load(bin_path, map_location="cpu", weights_only=True)


def load_dinov2_model(model_name: str = "facebook/dinov2-small",
                      dtype: torch.dtype = torch.float32, cache_dir: Optional[str] = None,
                      device: Union[str, torch.device] = "cuda",
                      attn_impl: str = "auto") -> Dinov2:
    """A DINOv2 from an HF checkpoint on local disk: ``model_name`` is a
    directory holding ``config.json`` and ``pytorch_model.bin`` (or
    ``model.safetensors``, read where the ``safetensors`` package imports),
    or a hub name found under ``cache_dir`` in the hub-cache layout. Never
    downloads: with no files it raises ``FileNotFoundError`` naming the
    paths it looked in. The model is in eval mode on ``device`` (a missing
    card raises), computing in ``dtype`` with ``attn_impl``."""
    device = _resolve_device(device)
    looked = _checkpoint_dirs(model_name, cache_dir)
    found = next((d for d in looked if os.path.isfile(os.path.join(d, "config.json"))
                  and any(os.path.isfile(os.path.join(d, w))
                          for w in ("pytorch_model.bin", "model.safetensors"))), None)
    if found is None:
        raise FileNotFoundError(
            f"no DINOv2 checkpoint for {model_name!r}: looked for config.json with "
            f"pytorch_model.bin or model.safetensors in {looked}; the port does not "
            "download weights: pass a local HF directory (save_pretrained layout) or "
            "--cache-dir holding the hub cache")
    with open(os.path.join(found, "config.json")) as f:
        cfg = _config_from_hf(json.load(f))
    sd = {k: v for k, v in _read_state_dict(found).items() if k not in _SKIPPED_KEYS}
    model = Dinov2(cfg, dtype=dtype, attn_impl=attn_impl)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def save_hf_checkpoint(model: Dinov2, directory: str) -> str:
    """``model`` as an HF directory (``config.json`` + ``pytorch_model.bin``)
    that ``load_dinov2_model`` and ``transformers.Dinov2Model`` read."""
    c = model.cfg
    os.makedirs(directory, exist_ok=True)
    config = {"architectures": ["Dinov2Model"], "model_type": "dinov2",
              "hidden_size": c.hidden_size, "num_hidden_layers": c.layers,
              "num_attention_heads": c.heads, "patch_size": c.patch_size,
              "mlp_ratio": c.mlp_ratio, "layerscale_value": c.layerscale_value,
              "layer_norm_eps": c.norm_eps, "use_swiglu_ffn": c.use_swiglu_ffn,
              "image_size": c.native_image_size, "num_channels": 3, "hidden_act": "gelu",
              "qkv_bias": True, "drop_path_rate": 0.0, "hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0, "initializer_range": 0.02}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    sd = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    sd["embeddings.mask_token"] = torch.zeros(1, c.hidden_size)
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))
    return directory
