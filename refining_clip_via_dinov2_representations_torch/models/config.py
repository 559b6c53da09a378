"""Typed model configuration tree + named-architecture registry.

The port's copy of the JAX package's ``models/config.py``: the same
dataclasses (field names and defaults), ``parse_model_cfg`` and the registry
lookups. The registry holds the names whose towers the port builds
(``_registry_data.py``); ``register_model_config`` adds more at run time.
Fields of towers the port does not build yet (other timm and the HF towers)
are kept so configs parse; ``models/clip.py`` raises ``NotImplementedError``
when asked to build one.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ._registry_data import MODEL_CONFIGS as _BUILTIN_CONFIGS


@dataclass
class CLIPVisionCfg:
    layers: Union[Tuple[int, int, int, int], List[int], int] = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: Optional[int] = 16
    image_size: Union[Tuple[int, int], int] = 224

    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: Union[bool, str] = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = "avg"
    timm_proj: Optional[str] = "linear"
    timm_proj_bias: bool = False
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.layers, (tuple, list))

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> Tuple[int, int]:
        ih, iw = to_2tuple(self.image_size)
        ph, pw = to_2tuple(self.patch_size)
        return ih // ph, iw // pw

    @property
    def seq_len(self) -> int:
        gh, gw = self.grid_size
        return gh * gw + 1  # + CLS


@dataclass
class CLIPTextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    hf_tokenizer_name: Optional[str] = None
    tokenizer_kwargs: Optional[dict] = None

    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    pad_id: int = 0
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"
    proj_bias: bool = False
    proj_type: str = "linear"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    hf_model_name: Optional[str] = None
    hf_model_pretrained: bool = True
    hf_proj_type: str = "mlp"
    hf_pooler_type: str = "mean_pooler"


@dataclass
class MultimodalCfg(CLIPTextCfg):
    """CoCa decoder config: parsed, not built (CoCa is not ported yet)."""

    mlp_ratio: float = 4.0
    dim_head: int = 64
    heads: int = 8
    n_queries: int = 256
    attn_pooler_heads: int = 8


@dataclass
class CLIPModelCfg:
    embed_dim: int = 512
    vision_cfg: CLIPVisionCfg = field(default_factory=CLIPVisionCfg)
    text_cfg: CLIPTextCfg = field(default_factory=CLIPTextCfg)
    multimodal_cfg: Optional[MultimodalCfg] = None
    quick_gelu: bool = False
    custom_text: bool = False
    init_logit_scale: Optional[float] = None
    init_logit_bias: Optional[float] = None


def to_2tuple(x) -> Tuple[Any, Any]:
    if isinstance(x, (tuple, list)):
        if len(x) != 2:
            raise ValueError(f"expected a pair, got {x!r}")
        return tuple(x)
    return (x, x)


def _filter_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def parse_model_cfg(cfg: Dict[str, Any]) -> CLIPModelCfg:
    """Turn a raw registry dict into the typed config tree."""
    cfg = copy.deepcopy(cfg)
    vision = CLIPVisionCfg(**_filter_fields(CLIPVisionCfg, cfg.get("vision_cfg", {})))
    text = CLIPTextCfg(**_filter_fields(CLIPTextCfg, cfg.get("text_cfg", {})))
    mm = None
    if "multimodal_cfg" in cfg:
        mm = MultimodalCfg(**_filter_fields(MultimodalCfg, cfg["multimodal_cfg"]))
    return CLIPModelCfg(
        embed_dim=cfg["embed_dim"],
        vision_cfg=vision,
        text_cfg=text,
        multimodal_cfg=mm,
        quick_gelu=bool(cfg.get("quick_gelu", False)),
        custom_text=bool(cfg.get("custom_text", False)),
        init_logit_scale=cfg.get("init_logit_scale"),
        init_logit_bias=cfg.get("init_logit_bias"),
    )


_MODEL_CONFIGS: Dict[str, Dict[str, Any]] = dict(_BUILTIN_CONFIGS)


def _natural_key(name: str):
    return [int(s) if s.isdigit() else s for s in re.split(r"(\d+)", name.lower())]


def list_models() -> List[str]:
    """Enumerate registered model architecture names."""
    return sorted(_MODEL_CONFIGS, key=_natural_key)


def get_model_config(model_name: str) -> Optional[Dict[str, Any]]:
    """Fetch a deep copy of a raw registry entry, or None if unknown."""
    if model_name in _MODEL_CONFIGS:
        return copy.deepcopy(_MODEL_CONFIGS[model_name])
    return None


def register_model_config(name: str, cfg: Dict[str, Any]) -> None:
    """Programmatic registration (tests and downstream projects)."""
    _MODEL_CONFIGS[name] = copy.deepcopy(cfg)
