"""Model factory: registry name (+ pretrained tag or checkpoint file) -> model.

The port of the JAX package's ``models/factory.py`` for the standard ViT
CLIPs: registry names (``-quickgelu`` names and ``force_quick_gelu`` select
QuickGELU), ``hf-hub:`` names and pretrained tags read from local caches
(``models/pretrained.py``; nothing is downloaded), and checkpoint files in
four formats (``load_state_dict``): OpenAI TorchScript archives, plain
torch files (the port's epoch checkpoints among them), ``.npz`` and
``.safetensors``. ``load_checkpoint`` also reads big_vision's SigLIP
``.npz`` and Apple's MobileCLIP files (``models/convert_external.py``), and
resizes positional tables of another grid or context length as the JAX
package does. Without a checkpoint the
weights are a seeded random init.

Entry points place the model on ``device`` ("cuda" by default) and raise
when that device is missing; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..tokenizer import DEFAULT_CONTEXT_LENGTH, HFTokenizer, SigLipTokenizer, SimpleTokenizer
from ..transform import PreprocessCfg, image_transform_v2, merge_preprocess_dict
from . import convert_external
from ._safetensors import load_safetensors
from .clip import CLIP, build_model
from .config import get_model_config, list_models, parse_model_cfg
from .convert import normalize_state_dict_keys
from .eva import TRUNK, convert_eva_clip_state_dict
from .eva02 import Eva02VisionTower, convert_eva02_clip_state_dict
from .fastvit import FastVitTower, MciVisionTransformer, convert_mobileclip_clip_state_dict
from .swin import SwinVisionTower, convert_swin_clip_state_dict
from .vitamin import ViTaminVisionTower, convert_vitamin_clip_state_dict
from .pretrained import (HF_HUB_PREFIX, get_pretrained_cfg, list_pretrained_tags_by_model,
                         resolve_hf_file, resolve_pretrained)

# scalars an OpenAI TorchScript archive keeps beside its weights
_OPENAI_EXTRAS = ("input_resolution", "context_length", "vocab_size")


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


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive: a zip holding ``constants.pkl`` and ``code/``,
    which ``torch.save`` files do not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def load_state_dict(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as an open_clip-layout state dict on the CPU, keys
    normalised (``convert.normalize_state_dict_keys``). Reads ``.safetensors``
    (``_safetensors.load_safetensors``), ``.npz`` and torch files: a
    TorchScript archive (OpenAI's, through ``torch.jit.load``, its
    ``input_resolution``, ``context_length`` and ``vocab_size`` dropped), or
    a pickle of tensors read with ``weights_only=True`` (a bare dict or one
    under ``"state_dict"``, as the port's epoch checkpoints hold it)."""
    path = str(checkpoint_path)
    if path.endswith(".safetensors"):
        sd = load_safetensors(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    elif _is_torchscript(path):
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
        for key in _OPENAI_EXTRAS:
            sd.pop(key, None)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds no state dict")
    return normalize_state_dict_keys(sd)


def _interp_vision_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """[1 + n*n, D] -> [target_len, D]: the grid resized bicubically with
    antialias (``jax.image.resize(..., "cubic")``, the JAX package's
    ``_interp_vision_pos_embed``), the CLS row passed through; fp32."""
    from .dinov2 import resize_position_table

    old, new = math.isqrt(pos.shape[0] - 1), math.isqrt(target_len - 1)
    if old * old != pos.shape[0] - 1 or new * new != target_len - 1:
        raise ValueError(f"visual.positional_embedding: {pos.shape[0]} -> {target_len} rows "
                         "is not a square grid (plus CLS) on both sides")
    pos = pos.float()
    grid = resize_position_table(pos[1:].reshape(old, old, -1), (new, new))
    return torch.cat([pos[:1], grid.reshape(new * new, -1)], dim=0)


def _resize_text_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """[L, D] -> [target_len, D]: truncated, or resized linearly
    (``jax.image.resize(..., "linear")``, the JAX package's
    ``_resize_text_pos_embed``); fp32."""
    pos = pos.float()
    if pos.shape[0] >= target_len:
        return pos[:target_len]
    return F.interpolate(pos.t()[None], size=target_len, mode="linear",
                         align_corners=False)[0].t()


def load_weights(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                 strict: bool = True) -> Tuple[List[str], List[str]]:
    """Loads ``state_dict`` into ``model`` as the JAX ``_merge_params``
    merges (an EVA01 or EVA02 CustomTextCLIP layout converted first,
    ``models/eva.py``, ``models/eva02.py``; a SigLIP model takes that
    layout as it is; a ViTamin, Swin, FastViT or MCi trunk goes through its
    timm importer, ``models/vitamin.py``, ``models/swin.py``,
    ``models/fastvit.py``; another model whose text
    tower sits at top level takes
    a ``text.``-prefixed tower there, as the JAX exporter writes it beside a
    ConvNeXt trunk; BatchNorm's ``num_batches_tracked``, which OpenAI's and
    open_clip's ResNet files carry and the JAX package neither writes nor
    reads, is dropped):
    ``visual.positional_embedding`` and ``positional_embedding`` of
    another length are resized, another tensor of the same size reshaped,
    values cast to the parameters' dtype; ``attn_mask`` buffers are skipped.
    Returns ``(missing, unexpected)`` keys; with ``strict`` either raises."""
    own = model.state_dict()
    if any(k.startswith(TRUNK) for k in state_dict) and not any(k.startswith(TRUNK) for k in own):
        # open_clip's EVA01 or EVA02 CustomTextCLIP layout
        convert = (convert_eva02_clip_state_dict
                   if isinstance(getattr(model, "visual", None), Eva02VisionTower)
                   else convert_eva_clip_state_dict)
        state_dict = convert(state_dict)
    elif isinstance(getattr(model, "visual", None), (ViTaminVisionTower, SwinVisionTower)):
        state_dict = (convert_vitamin_clip_state_dict(state_dict)
                      if isinstance(model.visual, ViTaminVisionTower)
                      else convert_swin_clip_state_dict(state_dict))
    elif isinstance(getattr(model, "visual", None), (FastVitTower, MciVisionTransformer)):
        state_dict = convert_mobileclip_clip_state_dict(
            state_dict, mci=isinstance(model.visual, MciVisionTransformer))
    if "token_embedding.weight" in own and "text.token_embedding.weight" in state_dict:
        state_dict = {k[len("text."):] if k.startswith("text.") else k: v
                      for k, v in state_dict.items()}
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith(("attn_mask", "num_batches_tracked"))}
    loaded = {}
    for k, v in sd.items():
        if k not in own:
            continue
        want = own[k].shape
        if v.shape != want:
            if k == "visual.positional_embedding":
                v = _interp_vision_pos_embed(v, want[0])
            elif k == "positional_embedding":
                v = _resize_text_pos_embed(v, want[0])
            elif v.numel() == own[k].numel():
                v = v.reshape(want)
            else:
                raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs "
                                 f"model {tuple(want)}")
        loaded[k] = v
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    if strict and (missing or unexpected):
        raise ValueError(f"checkpoint mismatch: missing={missing[:10]} "
                         f"unexpected={unexpected[:10]}")
    model.load_state_dict(loaded, strict=False)
    return missing, unexpected


def load_checkpoint(model: torch.nn.Module, checkpoint_path: str,
                    strict: bool = True) -> Tuple[List[str], List[str]]:
    """A checkpoint file (``load_state_dict``'s formats) into ``model``
    (``load_weights``); returns ``(missing, unexpected)``. Dispatched as the
    JAX ``load_checkpoint``: a big_vision ``.npz`` (``txt/``/``img/`` keys)
    and Apple's MobileCLIP layout (``image_encoder.model.``) through
    ``models/convert_external.py``, else open_clip's layout. A BatchNorm
    tower's file without running statistics fails ``strict``, as there."""
    path = str(checkpoint_path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            big_vision = convert_external.is_big_vision(z.files)
        if big_vision:
            return load_weights(model, convert_external.load_big_vision_weights(path),
                                strict=strict)
    sd = load_state_dict(checkpoint_path)
    if convert_external.is_mobileclip(sd):
        sd = convert_external.convert_state_dict(sd)
    if not any(k.startswith(("visual.", "text.")) or k == "logit_scale" for k in sd):
        raise ValueError(f"unrecognized checkpoint layout in {checkpoint_path}")
    return load_weights(model, sd, strict=strict)


def _hub_config(model_id: str, cache_dir: Optional[str]) -> Dict[str, Any]:
    with open(resolve_hf_file(model_id, "open_clip_config.json", cache_dir)) as f:
        return json.load(f)


def create_model(
    model_name: str,
    pretrained: Optional[str] = None,
    precision: str = "fp32",
    device="cuda",
    attn_impl: str = "auto",
    seed: int = 0,
    force_quick_gelu: bool = False,
    force_image_size: Optional[Union[int, Tuple[int, int]]] = None,
    force_preprocess_cfg: Optional[Dict[str, Any]] = None,
    cache_dir: Optional[str] = None,
    require_pretrained: bool = False,
    grad_checkpointing: Union[bool, str] = False,
    force_patch_dropout: Optional[float] = None,
) -> Tuple[CLIP, PreprocessCfg]:
    """Build a model on ``device``; returns ``(model, preprocess_cfg)``.

    ``pretrained`` is a tag of ``model_name`` (its file resolved offline
    under ``cache_dir``, its ``mean``/``std``/``interpolation``/
    ``resize_mode`` merged into the preprocess config) or a checkpoint
    file; it loads with ``strict=True`` (``load_checkpoint``), positional
    tables resized to the model's. ``hf-hub:<org>/<name>`` takes the config,
    preprocess config and weights from that repo in the hub cache. Without
    weights the init is seeded random; ``require_pretrained`` makes that an
    error. A tag that expects QuickGELU under a GELU config gets the JAX
    package's warning and keeps GELU; ``force_quick_gelu`` or a
    ``-quickgelu`` name selects QuickGELU. ``precision`` takes the
    training CLI's names (``_precision_to_dtype``). ``force_image_size``
    replaces the vision tower's image size (and the preprocess size);
    ``force_preprocess_cfg`` overrides preprocess keys; ``grad_checkpointing``
    recomputes every residual block in the backward (true: the ``"full"``
    policy; or a policy name, ``models/transformer.py:REMAT_POLICIES``);
    ``force_patch_dropout`` replaces the vision tower's patch-dropout
    probability (applied in training when the caller passes a generator)."""
    device = _resolve_device(device)
    compute_dtype, param_dtype = _precision_to_dtype(precision)
    preprocess_cfg = PreprocessCfg()
    checkpoint_path = None
    if model_name.startswith(HF_HUB_PREFIX):
        model_id = model_name[len(HF_HUB_PREFIX):]
        hub_cfg = _hub_config(model_id, cache_dir)
        raw_cfg = hub_cfg["model_cfg"]
        preprocess_cfg = PreprocessCfg(**merge_preprocess_dict(
            preprocess_cfg, hub_cfg.get("preprocess_cfg", {})))
        checkpoint_path = resolve_hf_file(model_id, cache_dir=cache_dir)
        pretrained = None
    else:
        model_name = model_name.replace("/", "-")
        raw_cfg = get_model_config(model_name)
        if raw_cfg is None:
            raise RuntimeError(f"Model config for {model_name} not found; available "
                               f"models: {', '.join(list_models()[:20])}...")
    if "quickgelu" in model_name.lower() or force_quick_gelu:
        raw_cfg["quick_gelu"] = True
    if force_image_size is not None:
        raw_cfg.setdefault("vision_cfg", {})["image_size"] = force_image_size
    if force_patch_dropout is not None:
        raw_cfg.setdefault("vision_cfg", {})["patch_dropout"] = force_patch_dropout
    if pretrained:
        pcfg = get_pretrained_cfg(model_name, pretrained)
        if pcfg:
            checkpoint_path = resolve_pretrained(pcfg, cache_dir=cache_dir)
            preprocess_cfg = PreprocessCfg(**merge_preprocess_dict(preprocess_cfg, pcfg))
            if pcfg.get("quick_gelu") and not raw_cfg.get("quick_gelu"):
                logging.warning(
                    "%s tag %s expects QuickGELU but config uses GELU; pass the -quickgelu "
                    "model name (reference factory.py:452-463)", model_name, pretrained)
        elif os.path.isfile(pretrained):
            checkpoint_path = pretrained
        else:
            raise RuntimeError(
                f"Pretrained weights ({pretrained}) not found for model {model_name}: not one "
                f"of its tags {list_pretrained_tags(model_name)} nor a local checkpoint file")
    if require_pretrained and not checkpoint_path:
        raise RuntimeError(f"no pretrained weights resolved for {model_name}")
    cfg = parse_model_cfg(raw_cfg)
    # a checkpoint overwrites every tensor (strict), so no seeded draw first
    model = build_model(cfg, dtype=compute_dtype, attn_impl=attn_impl, seed=seed,
                        grad_checkpointing=grad_checkpointing, init=not checkpoint_path)
    if checkpoint_path:
        load_checkpoint(model, checkpoint_path, strict=True)
    model = model.to(device=device, dtype=param_dtype).eval()
    preprocess_cfg = PreprocessCfg(**merge_preprocess_dict(
        preprocess_cfg, {**(force_preprocess_cfg or {}), "size": cfg.vision_cfg.image_size}))
    return model, preprocess_cfg


def list_pretrained_tags(model_name: str) -> List[str]:
    return list_pretrained_tags_by_model(model_name)


def _preprocess_overrides(image_mean=None, image_std=None, image_interpolation=None,
                          image_resize_mode=None) -> Dict[str, Any]:
    """The ``image_*`` arguments that were given, as preprocess keys (the
    reference's ``merge_preprocess_kwargs({}, ...)``: a tag's statistics
    stay where none is given)."""
    given = {"mean": image_mean, "std": image_std, "interpolation": image_interpolation,
             "resize_mode": image_resize_mode}
    return {k: v for k, v in given.items() if v is not None}


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None,
                                image_mean=None, image_std=None, image_interpolation=None,
                                image_resize_mode=None, **kwargs):
    """-> ``(model, preprocess_val)``: the serving subset of the JAX
    package's ``(model, variables, preprocess_train, preprocess_val)``."""
    model, pp_cfg = create_model(model_name, pretrained, force_preprocess_cfg=_preprocess_overrides(
        image_mean, image_std, image_interpolation, image_resize_mode), **kwargs)
    return model, image_transform_v2(pp_cfg, is_train=False)


def create_model_from_pretrained(model_name: str, pretrained: Optional[str] = None,
                                 image_mean=None, image_std=None, image_interpolation=None,
                                 image_resize_mode=None, return_transform: bool = True,
                                 **kwargs):
    """-> ``(model, preprocess_val)``, or the model alone without
    ``return_transform``; pretrained weights are required."""
    model, pp_cfg = create_model(model_name, pretrained, require_pretrained=True,
                                 force_preprocess_cfg=_preprocess_overrides(
                                     image_mean, image_std, image_interpolation,
                                     image_resize_mode), **kwargs)
    if not return_transform:
        return model
    return model, image_transform_v2(pp_cfg, is_train=False)


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None,
                  cache_dir: Optional[str] = None, **kwargs):
    """The model's tokenizer at its context length, dispatched as the JAX
    ``get_tokenizer`` (``tpu/models/factory.py:539-581``): a config's
    ``hf_tokenizer_name`` gives ``HFTokenizer`` over that hub repo's cached
    files (``tokenizer_kwargs``, such as SigLIP's ``clean: canonicalize``,
    and ``kwargs`` passed on); a SigLIP name without one gives
    ``SigLipTokenizer``; else the CLIP BPE. An ``hf-hub:`` name takes its
    cached ``open_clip_config.json``, and without one its own tokenizer
    files. Nothing is downloaded."""
    if model_name.startswith(HF_HUB_PREFIX):
        model_id = model_name[len(HF_HUB_PREFIX):]
        try:
            config = _hub_config(model_id, cache_dir)["model_cfg"]
        except FileNotFoundError:
            return HFTokenizer(model_id, context_length=context_length or DEFAULT_CONTEXT_LENGTH,
                               cache_dir=cache_dir, **kwargs)
    else:
        config = get_model_config(model_name.replace("/", "-"))
    if config is None:
        raise RuntimeError(f"No valid model config found for {model_name}.")
    text_config = config.get("text_cfg", {})
    tokenizer_kwargs = dict(text_config.get("tokenizer_kwargs", {}), **kwargs)
    if context_length is None:
        context_length = text_config.get("context_length", DEFAULT_CONTEXT_LENGTH)
    if text_config.get("hf_tokenizer_name"):
        return HFTokenizer(text_config["hf_tokenizer_name"], context_length=context_length,
                           cache_dir=cache_dir, **tokenizer_kwargs)
    lname = model_name.lower()
    if "siglip" in lname:
        name = "gemma" if "siglip2" in lname else ("mc4" if "i18n" in lname else "c4-en")
        return SigLipTokenizer(name, context_length=context_length)
    return SimpleTokenizer(context_length=context_length, **tokenizer_kwargs)
