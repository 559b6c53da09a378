"""OpenAI CLIP checkpoints: TorchScript archives to the port's CLIP.

The port of the JAX package's ``models/openai.py``. OpenAI ships each model
as a TorchScript archive of fp16 weights in the layout open_clip keeps
(``visual.conv1.weight``, ``transformer.resblocks.N...``, ``logit_scale``)
plus three scalars (``input_resolution``, ``context_length``,
``vocab_size``). ``load_openai_model`` reads one, infers the architecture
from the tensors' shapes, builds the model with QuickGELU (OpenAI's models
were trained with it) and loads the weights strictly, cast to the
parameters' dtype. ``save_openai_archive`` writes a state dict in that form
(seeded weights for tests and the on-card smoke run: the real archives are
not in the repository).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .config import parse_model_cfg
from .pretrained import get_pretrained_cfg, list_pretrained_models_by_tag, resolve_url_file


def list_openai_models() -> List[str]:
    """The models with an ``openai`` tag."""
    return list_pretrained_models_by_tag("openai")


def infer_openai_config(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The model config of an OpenAI state dict, from its tensors' shapes
    (ViT or ModifiedResNet vision tower; text heads = width // 64)."""
    def shape(k):
        return tuple(state_dict[k].shape)

    if "visual.proj" in state_dict:
        vision_patch_size = shape("visual.conv1.weight")[-1]
        grid = round((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        vision_cfg = {
            "layers": len([k for k in state_dict if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
            "width": shape("visual.conv1.weight")[0],
            "patch_size": vision_patch_size,
            "image_size": vision_patch_size * grid,
        }
    else:
        counts = [len({k.split(".")[2] for k in state_dict if k.startswith(f"visual.layer{b}")})
                  for b in (1, 2, 3, 4)]
        output_width = round((shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5)
        vision_cfg = {"layers": counts, "width": shape("visual.layer1.0.conv1.weight")[0],
                      "patch_size": None, "image_size": output_width * 32}
    width = shape("ln_final.weight")[0]
    return {
        "embed_dim": shape("text_projection")[1],
        "quick_gelu": True,  # OpenAI models were trained with QuickGELU
        "vision_cfg": vision_cfg,
        "text_cfg": {
            "context_length": shape("positional_embedding")[0],
            "vocab_size": shape("token_embedding.weight")[0],
            "width": width,
            "heads": width // 64,
            "layers": len({k.split(".")[2] for k in state_dict
                           if k.startswith("transformer.resblocks")}),
        },
    }


def load_openai_state_dict(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """A TorchScript archive (or a plain torch file of tensors) -> its state
    dict on the CPU, without ``input_resolution``, ``context_length`` and
    ``vocab_size`` (``factory.load_state_dict``)."""
    from .factory import load_state_dict

    return load_state_dict(checkpoint_path)


def load_openai_model(name_or_path: str, precision: str = "fp32", device="cuda",
                      cache_dir: Optional[str] = None, attn_impl: str = "auto") -> nn.Module:
    """The CLIP of an OpenAI checkpoint on ``device``, in eval mode.
    ``name_or_path`` is a checkpoint file, or a model with an ``openai`` tag,
    whose archive is read from the URL layout ``<cache_dir>/<name>.pt`` and
    must match the sha256 its URL names (``pretrained.resolve_url_file``;
    nothing is downloaded). QuickGELU always; ``precision`` takes the
    factory's names."""
    from .clip import build_model
    from .factory import _precision_to_dtype, _resolve_device, load_weights

    device = _resolve_device(device)
    if os.path.isfile(name_or_path):
        checkpoint_path = name_or_path
    else:
        entry = get_pretrained_cfg(name_or_path, "openai")
        if not entry:
            raise RuntimeError(f"Model {name_or_path} not found; available openai models: "
                               f"{list_openai_models()}")
        checkpoint_path = resolve_url_file(entry["url"], cache_dir)
    state_dict = load_openai_state_dict(checkpoint_path)
    cfg = parse_model_cfg(infer_openai_config(state_dict))
    compute_dtype, param_dtype = _precision_to_dtype(precision)
    model = build_model(cfg, dtype=compute_dtype, attn_impl=attn_impl)
    load_weights(model, state_dict, strict=True)
    return model.to(device=device, dtype=param_dtype).eval()


class _Holder(nn.Module):
    """One level of the archive's module tree (TorchScript needs a forward)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def save_openai_archive(state_dict: Dict[str, torch.Tensor], path: str,
                        dtype: torch.dtype = torch.float16) -> str:
    """``state_dict`` (open_clip's ViT CLIP layout) as an OpenAI-style
    TorchScript archive: floating tensors in ``dtype`` under the same
    names, and the three integer scalars OpenAI's archives carry."""
    cfg = infer_openai_config(state_dict)
    extras = {"input_resolution": cfg["vision_cfg"]["image_size"],
              "context_length": cfg["text_cfg"]["context_length"],
              "vocab_size": cfg["text_cfg"]["vocab_size"]}
    root = _Holder()
    items = [(k, v.detach().cpu().to(dtype) if v.is_floating_point() else v.detach().cpu())
             for k, v in state_dict.items()]
    items += [(k, torch.tensor(v)) for k, v in extras.items()]
    for key, value in items:
        mod = root
        *parents, leaf = key.split(".")
        for name in parents:
            if not hasattr(mod, name):
                mod.add_module(name, _Holder())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, value.clone())
    torch.jit.script(root).save(path)
    return path
