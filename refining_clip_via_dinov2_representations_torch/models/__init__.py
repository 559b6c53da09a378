"""CLIP towers, the DINOv2 teacher, registry, weight conversion, pretrained
checkpoints and the model factory."""

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
from .convert import (
    jax_dinov2_params_to_state_dict,
    jax_head_params_to_state_dict,
    jax_params_to_state_dict,
    normalize_state_dict_keys,
)
from .dinov2 import Dinov2, Dinov2Cfg, load_dinov2_model
from .factory import (
    create_model,
    create_model_and_transforms,
    create_model_from_pretrained,
    get_tokenizer,
    list_pretrained_tags,
    load_checkpoint,
    load_state_dict,
)
from .openai import infer_openai_config, list_openai_models, load_openai_model
from .pretrained import (
    get_pretrained_cfg,
    get_pretrained_url,
    is_pretrained_cfg,
    list_pretrained,
    list_pretrained_models_by_tag,
    list_pretrained_tags_by_model,
    resolve_pretrained,
)
from .transformer import TextTransformer, Transformer, VisionTransformer, text_global_pool
