"""Model factory: registry name (+ optional local checkpoint) -> model.

The port of the JAX package's ``models/factory.py`` for registry names and
local open_clip-layout state-dict files. Pretrained tags and hub names raise:
there are no weights offline, and downloading is not ported. Without a
checkpoint the weights are a seeded random init.

Entry points place the model on ``device`` ("cuda" by default) and raise
when that device is missing; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from ..tokenizer import DEFAULT_CONTEXT_LENGTH, SimpleTokenizer
from ..transform import PreprocessCfg, image_transform_v2, merge_preprocess_dict
from .clip import CLIP, build_model
from .config import get_model_config, list_models, parse_model_cfg


def _precision_to_dtype(precision: str) -> Tuple[torch.dtype, torch.dtype]:
    """Precision flag -> (compute dtype, parameter dtype), with the JAX
    package's names and mapping: the amp/fp16 flags of the torch reference
    collapse to bf16 compute over fp32 parameters (there is no autocast or
    GradScaler); ``amp`` itself is fp32, as there."""
    if precision in ("fp32", "amp", "float32"):
        return torch.float32, torch.float32
    if precision in ("bf16", "amp_bf16", "bfloat16", "fp16", "amp_bfloat16", "pure_fp16"):
        return torch.bfloat16, torch.float32
    if precision == "pure_bf16":
        return torch.bfloat16, torch.bfloat16
    raise ValueError(f"unknown precision {precision!r}")


def _resolve_device(device) -> torch.device:
    """The requested device, or an error when it is a CUDA device that this
    machine lacks. Never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch paths"
        )
    return device


def load_state_dict(path: str) -> dict:
    """An open_clip-layout state dict saved with ``torch.save`` (a bare dict
    or one under ``"state_dict"``, DDP ``module.`` prefixes stripped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds no state dict")
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def create_model(
    model_name: str,
    pretrained: Optional[str] = None,
    precision: str = "fp32",
    device="cuda",
    attn_impl: str = "auto",
    seed: int = 0,
    force_image_size: Optional[Union[int, Tuple[int, int]]] = None,
    grad_checkpointing: bool = False,
) -> Tuple[CLIP, PreprocessCfg]:
    """Build a model on ``device``. ``pretrained`` may name a local
    state-dict file (loaded with ``strict=True``); without one the weights
    are a seeded random init. ``precision`` takes the training CLI's names
    (``_precision_to_dtype``): "fp32", "bf16" (bf16 compute over fp32
    parameters), "pure_bf16" (bf16 parameters), ... ``force_image_size``
    replaces the vision tower's image size, so its positional embedding is
    built at the new grid and the preprocess config takes that size; a
    checkpoint of another grid raises (positional-embedding resizing is not
    ported). ``grad_checkpointing`` recomputes every residual block in the
    backward. Returns ``(model, preprocess_cfg)``."""
    device = _resolve_device(device)
    compute_dtype, param_dtype = _precision_to_dtype(precision)
    if model_name.startswith("hf-hub:"):
        raise NotImplementedError("hf-hub models: downloading is not ported")
    model_name = model_name.replace("/", "-")
    raw_cfg = get_model_config(model_name)
    if raw_cfg is None:
        raise RuntimeError(f"Model config for {model_name} not found; available "
                           f"models: {', '.join(list_models()[:20])}...")
    if "quickgelu" in model_name.lower():
        raw_cfg["quick_gelu"] = True
    if force_image_size is not None:
        raw_cfg.setdefault("vision_cfg", {})["image_size"] = force_image_size
    if pretrained and not os.path.isfile(pretrained):
        raise RuntimeError(
            f"pretrained={pretrained!r} is not a local checkpoint file; pretrained "
            "tags need downloads, which the PyTorch port does not do"
        )
    cfg = parse_model_cfg(raw_cfg)
    model = build_model(cfg, dtype=compute_dtype, attn_impl=attn_impl, seed=seed,
                        grad_checkpointing=grad_checkpointing)
    if pretrained:
        sd = load_state_dict(pretrained)
        pos, want = "visual.positional_embedding", model.visual.positional_embedding.shape
        if pos in sd and sd[pos].shape != want:
            raise NotImplementedError(
                f"{pretrained} holds {pos} of shape {tuple(sd[pos].shape)} but the model's "
                f"{model.visual.image_size} images need {tuple(want)}: positional-embedding "
                "resizing is not ported (ROADMAP Queue 1)")
        model.load_state_dict(sd, strict=True)
    model = model.to(device=device, dtype=param_dtype).eval()
    preprocess_cfg = PreprocessCfg(**merge_preprocess_dict(
        PreprocessCfg(), {"size": cfg.vision_cfg.image_size}))
    return model, preprocess_cfg


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None,
                                **kwargs):
    """-> ``(model, preprocess_val)``: the serving subset of the JAX
    package's ``(model, variables, preprocess_train, preprocess_val)``."""
    model, pp_cfg = create_model(model_name, pretrained, **kwargs)
    return model, image_transform_v2(pp_cfg, is_train=False)


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None):
    """The CLIP BPE tokenizer at the model's context length."""
    config = get_model_config(model_name.replace("/", "-"))
    if config is None:
        raise RuntimeError(f"No valid model config found for {model_name}.")
    text_config = config.get("text_cfg", {})
    if text_config.get("hf_tokenizer_name"):
        raise NotImplementedError("HF tokenizers are not ported")
    if context_length is None:
        context_length = text_config.get("context_length", DEFAULT_CONTEXT_LENGTH)
    return SimpleTokenizer(context_length=context_length)
