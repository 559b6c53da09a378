"""The two-tower CLIP model as an ``nn.Module``.

The port of the JAX package's ``models/clip.py`` for the standard ViT +
causal text-transformer CLIP. Parameter layout is open_clip's ``CLIP``: the
vision tower under ``visual.``, the text tower's parts at top level
(``token_embedding``, ``positional_embedding``, ``transformer``,
``ln_final``, ``text_projection``), then ``logit_scale``, also for the
``custom_text`` configs (EVA01 and EVA02), whose open_clip checkpoints
``models/eva.py`` and ``models/eva02.py`` convert. A SigLIP model keeps open_clip's
``CustomTextCLIP`` layout, as its hub checkpoints do: the timm trunk under
``visual.trunk.`` (``models/siglip.py``) and the text tower under ``text.``,
then ``logit_scale`` and ``logit_bias``. The vision tower is the ViT in each of
its variants (CoCa's attentional pooler, CLIPA's average pool with
``ln_post`` after it, timm's ``vit_medium_patch16_gap_256``), the EVA01
trunk (``models/eva.py``), the EVA02 trunks (``models/eva02.py``: rope,
SwiGLU, sub-LN), the SigLIP trunk, the relative-position ViT
(``models/relpos_vit.py``), OpenAI's ModifiedResNet (``models/resnet.py``,
with BatchNorm's running statistics as buffers), the ConvNeXt trunk
(``models/convnext.py``, open_clip's timm layout under ``visual.trunk.``
and ``visual.head.``), the ViTamin hybrids (``models/vitamin.py``), the
Swin trunk (``models/swin.py``) or MobileCLIP's FastViT and MCi trunks
(``models/fastvit.py``), all in timm's layout under ``visual.trunk.``; the HF
text towers raise ``NotImplementedError``. A MobileCLIP model keeps open_clip's
CustomTextCLIP layout, as SigLIP's does and its hub checkpoints hold it.
``build_model`` builds ``models/coca.py:CoCa`` where the config has a
``multimodal_cfg``.

``forward`` matches the JAX module: a dict of L2-normalised
``image_features``, ``text_features`` and the exponentiated ``logit_scale``
(plus ``logit_bias`` where the config has one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_INIT_LOGIT_SCALE
from .config import CLIPModelCfg, CLIPTextCfg, CLIPVisionCfg, to_2tuple
from .convnext import CONVNEXT_DIMS, ConvNextCfg, ConvNextTower
from .eva import EVA01_DIMS
from .eva02 import EVA02_DIMS, Eva02VisionTower
from .fastvit import FASTVIT_DIMS, MCI_DIMS, FastVitTower, MciVisionTransformer
from .layers import (AttentionalPooler, LayerNorm, MultiheadAttention, PoolerAttention, gelu,
                     quick_gelu)
from .relpos_vit import RelPosVisionTower
from .resnet import ModifiedResNet
from .siglip import SiglipVisionCfg, SiglipVisionTower, gelu_tanh, parse_siglip_timm_name
from .swin import SWIN_DIMS, SwinVisionTower
from .transformer import (TEXT_POOL_TYPES, MultimodalTransformer, TextTransformer,
                          VisionTransformer, encode_text_tokens, remat_args)
from .vitamin import VITAMIN_DIMS, ViTaminVisionTower


def _unsupported(what: str, item: str = "14"):
    return NotImplementedError(
        f"{what}: the PyTorch port builds the ViT, ModifiedResNet, ConvNeXt, ViTamin, Swin, "
        f"FastViT, MCi and text-transformer CLIPs, EVA01, EVA02, SigLIP and CoCa so far "
        f"(ROADMAP Queue 1 item {item})"
    )


# the plain timm ViTs of the registry (``tpu/models/clip.py:135-141``): no
# class token, average pool, no QKV bias, LayerScale 1e-6
TIMM_PLAIN_VIT = {
    "vit_medium_patch16_gap_256": dict(width=512, layers=12, heads=8, patch=16,
                                       class_token=False, pool_type="avg", qkv_bias=False,
                                       ls_init_value=1e-6),
}
RELPOS_VIT = "vit_relpos_medium_patch16_cls_224"


def _build_vision_tower(embed_dim: int, cfg: CLIPVisionCfg, use_quick_gelu: bool,
                        dtype: torch.dtype, attn_impl: str, grad_checkpointing: bool = False,
                        remat_policy: str = "full") -> Union[VisionTransformer,
                                                             SiglipVisionTower,
                                                             RelPosVisionTower,
                                                             Eva02VisionTower,
                                                             ModifiedResNet, ConvNextTower,
                                                             ViTaminVisionTower,
                                                             SwinVisionTower, FastVitTower,
                                                             MciVisionTransformer]:
    common = dict(output_dim=embed_dim, attn_impl=attn_impl, compute_dtype=dtype,
                  grad_checkpointing=grad_checkpointing, remat_policy=remat_policy,
                  output_tokens=cfg.output_tokens)
    if cfg.timm_model_name is not None:
        dims = parse_siglip_timm_name(cfg.timm_model_name)
        if dims is not None:
            if dims["width"] != embed_dim and cfg.timm_proj in (None, "none"):
                raise NotImplementedError(
                    f"SigLIP tower {cfg.timm_model_name!r} width {dims['width']} != "
                    f"embed_dim {embed_dim} without a projection")
            # the config's image size wins (the -378 variants), as in JAX
            return SiglipVisionTower(
                SiglipVisionCfg(width=dims["width"], layers=dims["layers"], heads=dims["heads"],
                                mlp_dim=dims["mlp_dim"], patch_size=dims["patch_size"],
                                image_size=to_2tuple(cfg.image_size)[0]),
                output_tokens=cfg.output_tokens, attn_impl=attn_impl, compute_dtype=dtype,
                grad_checkpointing=grad_checkpointing, remat_policy=remat_policy)
        if cfg.timm_model_name in EVA02_DIMS:  # ``tpu/models/clip.py:114-131``
            e_cfg = EVA02_DIMS[cfg.timm_model_name]
            img = to_2tuple(cfg.image_size)[0]
            if img != e_cfg.image_size:  # the config's image size wins, as in JAX
                e_cfg = dataclasses.replace(e_cfg, image_size=img)
            return Eva02VisionTower(e_cfg, **common)
        if cfg.timm_model_name in VITAMIN_DIMS:  # ``tpu/models/clip.py:142-159``
            v_cfg = VITAMIN_DIMS[cfg.timm_model_name]
            img = to_2tuple(cfg.image_size)[0]
            if img != v_cfg.image_size:  # the config's image size wins, as in JAX
                v_cfg = dataclasses.replace(v_cfg, image_size=img)
            return ViTaminVisionTower(v_cfg, proj_bias=cfg.timm_proj_bias, **common)
        if cfg.timm_model_name == RELPOS_VIT:  # ``tpu/models/clip.py:160-170``
            return RelPosVisionTower(width=512, layers=12, heads=8, patch_size=16,
                                     image_size=to_2tuple(cfg.image_size)[0], **common)
        if cfg.timm_model_name in TIMM_PLAIN_VIT:  # ``tpu/models/clip.py:171-193``
            d = TIMM_PLAIN_VIT[cfg.timm_model_name]
            return VisionTransformer(
                image_size=to_2tuple(cfg.image_size), patch_size=to_2tuple(d["patch"]),
                width=d["width"], layers=d["layers"], heads=d["heads"],
                class_token=d["class_token"], pool_type=d["pool_type"], qkv_bias=d["qkv_bias"],
                ls_init_value=d["ls_init_value"], no_ln_pre=True, patch_embed_bias=True,
                act=gelu, norm_eps=1e-6, **common)
        if cfg.timm_model_name in SWIN_DIMS:  # ``tpu/models/clip.py:197-213``
            s_cfg = SWIN_DIMS[cfg.timm_model_name]
            img = to_2tuple(cfg.image_size)[0]
            if img != s_cfg.image_size:  # the config's image size wins, as in JAX
                s_cfg = dataclasses.replace(s_cfg, image_size=img)
            return SwinVisionTower(s_cfg, proj_bias=cfg.timm_proj_bias, **common)
        if cfg.timm_model_name in FASTVIT_DIMS:  # ``tpu/models/clip.py:231-245``
            f_cfg = FASTVIT_DIMS[cfg.timm_model_name]
            img = to_2tuple(cfg.image_size)[0]
            if img != f_cfg.image_size:  # the config's image size wins, as in JAX
                f_cfg = dataclasses.replace(f_cfg, image_size=img)
            # no attention kernel: the attention stage is plain, as in JAX
            return FastVitTower(f_cfg, embed_dim, output_tokens=cfg.output_tokens,
                                compute_dtype=dtype, grad_checkpointing=grad_checkpointing,
                                remat_policy=remat_policy)
        if cfg.timm_model_name in MCI_DIMS:  # ``tpu/models/clip.py:246-257``
            m_cfg = dataclasses.replace(MCI_DIMS[cfg.timm_model_name],
                                        image_size=to_2tuple(cfg.image_size)[0])
            return MciVisionTransformer(m_cfg, **common)
        if cfg.timm_model_name in CONVNEXT_DIMS:  # ``tpu/models/clip.py:240-253``
            depths, dims = CONVNEXT_DIMS[cfg.timm_model_name]
            return ConvNextTower(ConvNextCfg(depths=depths, dims=dims), embed_dim,
                                 image_size=to_2tuple(cfg.image_size)[0],
                                 proj_type=cfg.timm_proj or "linear",
                                 proj_bias=cfg.timm_proj_bias, output_tokens=cfg.output_tokens,
                                 compute_dtype=dtype, grad_checkpointing=grad_checkpointing,
                                 remat_policy=remat_policy)
        if cfg.timm_model_name not in EVA01_DIMS:
            raise _unsupported(f"timm vision tower {cfg.timm_model_name!r}")
        # the EVA01 trunk: the standard ViT with timm's four differences
        # (``models/eva.py``), GELU whatever quick_gelu says, as in JAX
        width, layers, heads, mlp_ratio, patch = EVA01_DIMS[cfg.timm_model_name]
        if cfg.output_tokens:
            raise _unsupported("EVA01 tower with output_tokens")
        return VisionTransformer(
            image_size=to_2tuple(cfg.image_size), patch_size=to_2tuple(patch), width=width,
            layers=layers, heads=heads, mlp_ratio=mlp_ratio, output_dim=embed_dim, act=gelu,
            attn_impl=attn_impl, compute_dtype=dtype, grad_checkpointing=grad_checkpointing,
            remat_policy=remat_policy, no_ln_pre=True, proj_bias=True, patch_embed_bias=True,
            norm_eps=1e-6)
    if cfg.is_resnet:  # ``tpu/models/clip.py:283-294``: heads of 64 channels
        return ModifiedResNet(tuple(cfg.layers), embed_dim, cfg.width * 32 // cfg.head_width,
                              image_size=to_2tuple(cfg.image_size)[0], width=cfg.width,
                              attn_impl=attn_impl, compute_dtype=dtype)
    act = quick_gelu if use_quick_gelu else gelu
    if (cfg.act_kwargs or {}).get("approximate") == "tanh":
        act = gelu_tanh
    return VisionTransformer(
        image_size=to_2tuple(cfg.image_size),
        patch_size=to_2tuple(cfg.patch_size),
        width=cfg.width,
        layers=cfg.layers,
        heads=cfg.heads,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        act=act,
        patch_dropout=cfg.patch_dropout,
        no_ln_pre=cfg.no_ln_pre,
        pos_embed_type=cfg.pos_embed_type,
        pool_type=cfg.pool_type,
        final_ln_after_pool=cfg.final_ln_after_pool,
        norm_eps=(cfg.norm_kwargs or {}).get("eps", 1e-5),
        attentional_pool=cfg.attentional_pool,
        attn_pooler_queries=cfg.attn_pooler_queries,
        attn_pooler_heads=cfg.attn_pooler_heads,
        **common,
    )


def _build_text_tower(embed_dim: int, cfg: CLIPTextCfg, use_quick_gelu: bool,
                      dtype: torch.dtype, attn_impl: str, grad_checkpointing: bool = False,
                      remat_policy: str = "full", coca: bool = False) -> TextTransformer:
    """The text transformer (``tpu/models/clip.py:329-380``); ``coca``
    admits CoCa's appended CLS and token outputs (a ``CLIP`` holds the
    tower's parts at top level, as open_clip's, and has no place for them).
    The activation is GELU under the dtype rule (QuickGELU where asked), the
    tanh form whatever the dtype where ``act_kwargs`` asks for it (every
    SigLIP2 config); ``norm_kwargs``' eps is every LayerNorm's."""
    if cfg.hf_model_name is not None:
        raise _unsupported(f"HF text tower {cfg.hf_model_name!r}")
    if not coca and (cfg.embed_cls or cfg.output_tokens):
        raise _unsupported("CoCa's text tower (embed_cls / output_tokens) outside CoCa")
    if cfg.proj_type not in ("linear", "none"):
        raise _unsupported(f"text projection {cfg.proj_type!r}", "2-3")
    if cfg.pool_type not in TEXT_POOL_TYPES:
        raise _unsupported(f"text pool_type {cfg.pool_type!r}", "2-3")
    act = quick_gelu if use_quick_gelu else gelu
    if (cfg.act_kwargs or {}).get("approximate") == "tanh":
        act = gelu_tanh
    return TextTransformer(
        context_length=cfg.context_length,
        vocab_size=cfg.vocab_size,
        width=cfg.width,
        heads=cfg.heads,
        layers=cfg.layers,
        mlp_ratio=cfg.mlp_ratio,
        ls_init_value=cfg.ls_init_value,
        output_dim=embed_dim,
        act=act,
        attn_impl=attn_impl,
        compute_dtype=dtype,
        grad_checkpointing=grad_checkpointing,
        remat_policy=remat_policy,
        embed_cls=cfg.embed_cls,
        pad_id=cfg.pad_id,
        output_tokens=cfg.output_tokens,
        no_causal_mask=cfg.no_causal_mask,
        pool_type=cfg.pool_type,
        proj_type=cfg.proj_type,
        proj_bias=cfg.proj_bias,
        norm_eps=(cfg.norm_kwargs or {}).get("eps", 1e-5),
    )


class _SkipDefaultInit(torch.overrides.TorchFunctionMode):
    """torch's default random parameter init skipped while a model is built
    (its cost is that of the seeded draw): the seeded init, or the strict load
    of a checkpoint, that follows writes every parameter. A function mode, so
    it holds for the building thread alone."""

    SKIPPED = frozenset({nn.init.uniform_, nn.init.normal_, nn.init.trunc_normal_,
                         nn.init.kaiming_uniform_, nn.init.kaiming_normal_,
                         nn.init.xavier_uniform_, nn.init.xavier_normal_})

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.SKIPPED:
            return args[0] if args else kwargs["tensor"]
        return func(*args, **kwargs)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0):
    """Seeded random init of ``model``'s layers (torch.Generator on the
    CPU): LayerNorms at 1/0, biases 0, matmul weights normal(fan_in^-1/2),
    token embeddings normal(0.02), vision CLS/positions/projection
    normal(width^-1/2); CoCa's text tower positions and CLS normal(0.01),
    its projection and the decoder's normal(width^-1/2), the pooler's
    queries normal(1), as the JAX package's initialisers. Returns the
    ``normal_(tensor, std)`` drawing from the same generator."""
    g = torch.Generator().manual_seed(int(seed))

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=g) * std)

    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            if m.in_proj_bias is not None:
                m.in_proj_bias.zero_()
        elif isinstance(m, PoolerAttention):
            for w in m.weights():
                normal_(w, w.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, VisionTransformer):
            normal_(m.conv1.weight, m.conv1.weight[0].numel() ** -0.5)
            if m.conv1.bias is not None:
                m.conv1.bias.zero_()
            for p in (m.class_embedding, m.positional_embedding, m.proj):
                if isinstance(p, nn.Parameter):  # a Linear proj: the branch above
                    normal_(p, m.width ** -0.5)
        elif isinstance(m, AttentionalPooler):
            normal_(m.query, 1.0)
        elif isinstance(m, TextTransformer):
            for p in (m.positional_embedding, m.cls_emb):
                if p is not None:
                    normal_(p, 0.01)
            if isinstance(m.text_projection, nn.Parameter):  # a Linear: the branch above
                normal_(m.text_projection, m.text_projection.shape[0] ** -0.5)
        elif isinstance(m, (SiglipVisionTower, RelPosVisionTower, Eva02VisionTower,
                            ModifiedResNet, ConvNextTower, ViTaminVisionTower,
                            SwinVisionTower, FastVitTower, MciVisionTransformer)):
            m.init_weights(normal_)
        elif isinstance(m, MultimodalTransformer):
            normal_(m.text_projection, m.text_projection.shape[0] ** -0.5)
    return normal_


class CLIP(nn.Module):
    """Two-tower contrastive model. ``dtype`` is the compute dtype;
    parameters are fp32."""

    def __init__(self, embed_dim: int, vision_cfg: CLIPVisionCfg,
                 text_cfg: CLIPTextCfg, quick_gelu: bool = False,
                 init_logit_scale: float = DEFAULT_INIT_LOGIT_SCALE,
                 init_logit_bias: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 grad_checkpointing: Union[bool, str] = False):
        super().__init__()
        remat, policy = remat_args(grad_checkpointing)
        self.embed_dim = embed_dim
        self.visual = _build_vision_tower(embed_dim, vision_cfg, quick_gelu, dtype, attn_impl,
                                          remat, policy)
        text = _build_text_tower(embed_dim, text_cfg, quick_gelu, dtype, attn_impl, remat,
                                 policy)
        self.context_length = text.context_length
        self.compute_dtype = dtype
        if isinstance(self.visual, (SiglipVisionTower, FastVitTower, MciVisionTransformer)):
            # open_clip's CustomTextCLIP layout, as SigLIP's and MobileCLIP's hub
            # checkpoints hold it
            self.text = text
        else:
            # open_clip's CLIP layout: the text tower's parts sit at top level
            self.token_embedding = text.token_embedding
            self.positional_embedding = text.positional_embedding
            self.transformer = text.transformer
            self.ln_final = text.ln_final
            self.text_projection = text.text_projection
            self.causal, self.pool_type = text.causal, text.pool_type
        # open_clip's CustomTextCLIP semantics for locking and the param
        # groups (``train/main.py:text_tower_style``), whatever the layout
        self.custom_text = False
        self.logit_scale = nn.Parameter(torch.tensor(float(init_logit_scale)))
        self.logit_bias = (None if init_logit_bias is None
                           else nn.Parameter(torch.tensor(float(init_logit_bias))))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        """Per-block activation checkpointing in both towers (open_clip's
        method; ``Transformer``), under the policy the model was built with."""
        self.visual.set_grad_checkpointing(enable)
        self._text_parts().transformer.grad_checkpointing = enable

    def _text_parts(self) -> nn.Module:
        """The module holding the text tower's parts: ``text`` in the
        CustomTextCLIP layout, else the model itself."""
        return self.text if "text" in self._modules else self

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Seeded random init (``init_weights``); the top-level text
        positions normal(0.01) and projection normal(width^-1/2)."""
        normal_ = init_weights(self, seed)
        if "text" not in self._modules:
            normal_(self.positional_embedding, 0.01)
            if isinstance(self.text_projection, nn.Parameter):
                normal_(self.text_projection, self.text_projection.shape[0] ** -0.5)

    def encode_image(self, image: torch.Tensor, normalize: bool = False,
                     patch_dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        features = self.visual(image, patch_dropout_generator)
        if isinstance(features, tuple):  # a tower with output_tokens
            features = features[0]
        return F.normalize(features, dim=-1) if normalize else features

    def encode_text(self, text: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        features = encode_text_tokens(self._text_parts(), text)
        return F.normalize(features, dim=-1) if normalize else features

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                patch_dropout_generator: Optional[torch.Generator] = None) -> dict:
        """Patch dropout (where the vision config has it) draws from
        ``patch_dropout_generator`` in training; without one the towers are
        deterministic."""
        out = {
            "image_features": None if image is None else self.encode_image(
                image, True, patch_dropout_generator),
            "text_features": None if text is None else self.encode_text(text, True),
            "logit_scale": self.logit_scale.exp(),
        }
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def build_model(cfg: CLIPModelCfg, dtype: torch.dtype = torch.float32,
                attn_impl: str = "auto", seed: int = 0,
                grad_checkpointing: Union[bool, str] = False,
                init: bool = True) -> Union[CLIP, "CoCa"]:
    """Instantiate CLIP (or CoCa, where the config has a ``multimodal_cfg``)
    from a parsed registry config, seeded-random weights on the CPU (not
    ``init``: torch's default init only, for a caller that loads every
    tensor strictly next). ``grad_checkpointing`` recomputes each residual
    block of every tower in the backward: true for the ``"full"`` policy, or
    a policy name of ``models/transformer.py:REMAT_POLICIES`` (the JAX
    ``remat``)."""
    kwargs = dict(init_logit_scale=cfg.init_logit_scale or DEFAULT_INIT_LOGIT_SCALE,
                  init_logit_bias=cfg.init_logit_bias, dtype=dtype, attn_impl=attn_impl,
                  grad_checkpointing=grad_checkpointing)
    if cfg.multimodal_cfg is not None:
        from .coca import CoCa

        with _SkipDefaultInit():
            model = CoCa(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg, cfg.multimodal_cfg,
                         quick_gelu_act=cfg.quick_gelu, **kwargs)
        if init:
            init_weights(model, seed)
        return model
    with _SkipDefaultInit():
        model = CLIP(
            embed_dim=cfg.embed_dim,
            vision_cfg=cfg.vision_cfg,
            text_cfg=cfg.text_cfg,
            quick_gelu=cfg.quick_gelu,
            **kwargs,
        )
    model.custom_text = cfg.custom_text
    if init:
        model.init_weights(seed)
    return model
