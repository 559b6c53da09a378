"""CLIP towers, registry, weight conversion and the model factory."""

from .clip import CLIP, build_model
from .config import (
    CLIPModelCfg,
    CLIPTextCfg,
    CLIPVisionCfg,
    get_model_config,
    list_models,
    parse_model_cfg,
    register_model_config,
)
from .convert import jax_head_params_to_state_dict, jax_params_to_state_dict
from .factory import create_model, create_model_and_transforms, get_tokenizer
from .transformer import TextTransformer, Transformer, VisionTransformer, text_global_pool
