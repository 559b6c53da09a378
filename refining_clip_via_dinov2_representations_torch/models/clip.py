"""The two-tower CLIP model as an ``nn.Module``.

The port of the JAX package's ``models/clip.py`` for the standard ViT +
causal text-transformer CLIP. Parameter layout is open_clip's ``CLIP``: the
vision tower under ``visual.``, the text tower's parts at top level
(``token_embedding``, ``positional_embedding``, ``transformer``,
``ln_final``, ``text_projection``), then ``logit_scale``. Other towers
(timm, ResNet, HF text, CoCa) raise ``NotImplementedError``.

``forward`` matches the JAX module: a dict of L2-normalised
``image_features``, ``text_features`` and the exponentiated ``logit_scale``
(plus ``logit_bias`` where the config has one).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_INIT_LOGIT_SCALE
from .config import CLIPModelCfg, CLIPTextCfg, CLIPVisionCfg, to_2tuple
from .layers import LayerNorm, MultiheadAttention, gelu, quick_gelu
from .transformer import TextTransformer, VisionTransformer, encode_text_tokens


def _unsupported(what: str):
    return NotImplementedError(
        f"{what}: the PyTorch port builds the standard ViT + text-transformer "
        "CLIP so far (ROADMAP Queue 1)"
    )


def _build_vision_tower(embed_dim: int, cfg: CLIPVisionCfg, use_quick_gelu: bool,
                        dtype: torch.dtype, attn_impl: str,
                        grad_checkpointing: bool = False) -> VisionTransformer:
    if cfg.timm_model_name is not None:
        raise _unsupported(f"timm vision tower {cfg.timm_model_name!r}")
    if cfg.is_resnet:
        raise _unsupported("ModifiedResNet vision tower")
    if cfg.attentional_pool:
        raise _unsupported("attentional pooling (CoCa)")
    variants = {"pos_embed_type": cfg.pos_embed_type != "learnable",
                "pool_type": cfg.pool_type != "tok", "no_ln_pre": cfg.no_ln_pre,
                "final_ln_after_pool": cfg.final_ln_after_pool,
                "patch_dropout (a training feature)": cfg.patch_dropout > 0,
                "output_tokens": cfg.output_tokens, "act_kwargs": bool(cfg.act_kwargs),
                "norm_kwargs": bool(cfg.norm_kwargs)}
    for what, present in variants.items():
        if present:
            raise _unsupported(f"vision tower with {what}")
    return VisionTransformer(
        image_size=to_2tuple(cfg.image_size),
        patch_size=to_2tuple(cfg.patch_size),
        width=cfg.width,
        layers=cfg.layers,
        heads=cfg.heads,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        output_dim=embed_dim,
        act=quick_gelu if use_quick_gelu else gelu,
        attn_impl=attn_impl,
        compute_dtype=dtype,
        grad_checkpointing=grad_checkpointing,
    )


def _build_text_tower(embed_dim: int, cfg: CLIPTextCfg, use_quick_gelu: bool,
                      dtype: torch.dtype, attn_impl: str,
                      grad_checkpointing: bool = False) -> TextTransformer:
    if cfg.hf_model_name is not None:
        raise _unsupported(f"HF text tower {cfg.hf_model_name!r}")
    if cfg.embed_cls or cfg.output_tokens:
        raise _unsupported("CoCa text tower (embed_cls / output_tokens)")
    variants = {"a projection other than linear": cfg.proj_bias or cfg.proj_type != "linear",
                "no_causal_mask": cfg.no_causal_mask, "pool_type": cfg.pool_type != "argmax",
                "act_kwargs": bool(cfg.act_kwargs), "norm_kwargs": bool(cfg.norm_kwargs)}
    for what, present in variants.items():
        if present:
            raise _unsupported(f"text tower with {what}")
    return TextTransformer(
        context_length=cfg.context_length,
        vocab_size=cfg.vocab_size,
        width=cfg.width,
        heads=cfg.heads,
        layers=cfg.layers,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        output_dim=embed_dim,
        act=quick_gelu if use_quick_gelu else gelu,
        attn_impl=attn_impl,
        compute_dtype=dtype,
        grad_checkpointing=grad_checkpointing,
    )


class CLIP(nn.Module):
    """Two-tower contrastive model. ``dtype`` is the compute dtype;
    parameters are fp32."""

    def __init__(self, embed_dim: int, vision_cfg: CLIPVisionCfg,
                 text_cfg: CLIPTextCfg, quick_gelu: bool = False,
                 init_logit_scale: float = DEFAULT_INIT_LOGIT_SCALE,
                 init_logit_bias: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 grad_checkpointing: bool = False):
        super().__init__()
        self.visual = _build_vision_tower(embed_dim, vision_cfg, quick_gelu, dtype, attn_impl,
                                          grad_checkpointing)
        text = _build_text_tower(embed_dim, text_cfg, quick_gelu, dtype, attn_impl,
                                 grad_checkpointing)
        # open_clip's CLIP layout: the text tower's parts sit at top level
        self.token_embedding = text.token_embedding
        self.positional_embedding = text.positional_embedding
        self.transformer = text.transformer
        self.ln_final = text.ln_final
        self.text_projection = text.text_projection
        self.context_length = text.context_length
        self.compute_dtype = dtype
        self.logit_scale = nn.Parameter(torch.tensor(float(init_logit_scale)))
        self.logit_bias = (None if init_logit_bias is None
                           else nn.Parameter(torch.tensor(float(init_logit_bias))))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        """Per-block activation checkpointing in both towers (open_clip's
        method; ``Transformer``)."""
        self.visual.set_grad_checkpointing(enable)
        self.transformer.grad_checkpointing = enable

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Seeded random init (torch.Generator on the CPU): LayerNorms at
        1/0, biases 0, matmul weights normal(fan_in^-1/2), token embedding
        normal(0.02), text positions normal(0.01), vision CLS/positions
        normal(width^-1/2), as the JAX package's initialisers."""
        g = torch.Generator().manual_seed(int(seed))

        def normal_(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=g) * std)

        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Linear):
                normal_(m.weight, m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 0.02)
            elif isinstance(m, VisionTransformer):
                normal_(m.conv1.weight, m.conv1.weight[0].numel() ** -0.5)
                for p in (m.class_embedding, m.positional_embedding, m.proj):
                    normal_(p, m.width ** -0.5)
        normal_(self.positional_embedding, 0.01)
        normal_(self.text_projection, self.text_projection.shape[0] ** -0.5)

    def encode_image(self, image: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        features = self.visual(image)
        return F.normalize(features, dim=-1) if normalize else features

    def encode_text(self, text: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        features = encode_text_tokens(self, text)
        return F.normalize(features, dim=-1) if normalize else features

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None) -> dict:
        out = {
            "image_features": None if image is None else self.encode_image(image, True),
            "text_features": None if text is None else self.encode_text(text, True),
            "logit_scale": self.logit_scale.exp(),
        }
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def build_model(cfg: CLIPModelCfg, dtype: torch.dtype = torch.float32,
                attn_impl: str = "auto", seed: int = 0,
                grad_checkpointing: bool = False) -> CLIP:
    """Instantiate CLIP from a parsed registry config, seeded-random weights
    on the CPU. ``grad_checkpointing`` recomputes each residual block of both
    towers in the backward (the JAX ``remat=True``)."""
    if cfg.multimodal_cfg is not None:
        raise _unsupported("CoCa (multimodal_cfg)")
    model = CLIP(
        embed_dim=cfg.embed_dim,
        vision_cfg=cfg.vision_cfg,
        text_cfg=cfg.text_cfg,
        quick_gelu=cfg.quick_gelu,
        init_logit_scale=cfg.init_logit_scale or DEFAULT_INIT_LOGIT_SCALE,
        init_logit_bias=cfg.init_logit_bias,
        dtype=dtype,
        attn_impl=attn_impl,
        grad_checkpointing=grad_checkpointing,
    )
    model.init_weights(seed)
    return model
