"""EVA01 vision towers (timm ``eva_giant_patch14_*``) on the port's ViT.

The port of the JAX package's ``models/eva.py``. EVA01-giant, the student of
the ``EVA01-g-14*`` configs (Config 5), is a standard pre-LN ViT: a class
token, a learned position table with a CLS row, no LayerNorm before the
blocks, fused-QKV attention whose key bias timm pins to zero (learnable
``q_bias``/``v_bias``, a zero ``k_bias`` buffer), a GELU MLP of 6144 wide,
the final LayerNorm before token pooling, LayerNorm eps 1e-6, a biased
patch embedding, and timm's biased classifier head as the CLIP projection
(open_clip builds the trunk with ``num_classes=embed_dim`` when
``timm_proj`` is null). So it is ``VisionTransformer(no_ln_pre=True,
proj_bias=True, patch_embed_bias=True, norm_eps=1e-6)`` with GELU
(``models/clip.py``).

Checkpoints of EVA CLIPs are open_clip's ``CustomTextCLIP``: the trunk under
``visual.trunk.`` in timm's names, the text tower under ``text.``.
``convert_timm_eva_state_dict`` maps a trunk to the port's ``visual.``
names (the separate q/v biases with a zero key bias fused into
``in_proj_bias``; a fused ``qkv.bias`` is kept as it is), and
``eva_params_to_timm_state_dict`` is its inverse, emitting the fused
``qkv.bias`` so that a round trip is exact even with a nonzero key part.
``convert_eva_clip_state_dict`` takes a whole CustomTextCLIP state dict to
the port's CLIP layout (``models/factory.py:load_weights`` calls it), and
``eva_clip_state_dict`` goes back. EVA02 (rope, SwiGLU) is not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# timm name -> (width, layers, heads, mlp_ratio, patch)
EVA01_DIMS = {
    "eva_giant_patch14_224": (1408, 40, 16, 6144 / 1408, 14),
    "eva_giant_patch14_336": (1408, 40, 16, 6144 / 1408, 14),
    "eva_giant_patch14_560": (1408, 40, 16, 6144 / 1408, 14),
}
TRUNK = "visual.trunk."

# timm block name -> the port's, for the parts that map one to one
_BLOCK = {"norm1": "ln_1", "norm2": "ln_2", "attn.qkv.weight": "attn.in_proj_weight",
          "attn.qkv.bias": "attn.in_proj_bias", "attn.proj": "attn.out_proj",
          "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}


def _rename(rest: str, table: Mapping[str, str]) -> str:
    for src, dst in table.items():
        if rest == src or rest.startswith(src + "."):
            return dst + rest[len(src):]
    raise KeyError(rest)


def convert_timm_eva_state_dict(state_dict: Mapping[str, torch.Tensor], prefix: str = TRUNK
                                ) -> Dict[str, torch.Tensor]:
    """A timm Eva trunk (keys under ``prefix``) -> the port's ``visual.``
    keys of ``VisionTransformer(no_ln_pre, proj_bias, patch_embed_bias)``."""
    out: Dict[str, torch.Tensor] = {}
    qv: Dict[str, Dict[str, torch.Tensor]] = {}
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
            if rest in ("attn.q_bias", "attn.v_bias"):
                qv.setdefault(pre, {})[rest[5]] = val
            elif rest == "attn.k_bias":
                continue  # a zero buffer
            elif rest.startswith(("attn.q_norm", "attn.k_norm")):
                raise KeyError(f"EVA02-style attention norm not supported: {key}")
            else:
                out[pre + _rename(rest, _BLOCK)] = val
        elif key.startswith("norm."):
            out["visual.ln_post." + key.split(".", 1)[1]] = val
        elif key.startswith("head."):
            out["visual.proj." + key.split(".", 1)[1]] = val
        elif key.startswith("fc_norm."):
            raise KeyError(f"avg-pool EVA variant not supported: {key}")
        else:
            raise KeyError(key)
    for pre, parts in qv.items():  # q and v biases, the key's pinned to zero
        out[pre + "attn.in_proj_bias"] = torch.cat([parts["q"], torch.zeros_like(parts["q"]),
                                                    parts["v"]])
    return out


def eva_params_to_timm_state_dict(state_dict: Mapping[str, torch.Tensor],
                                  prefix: str = TRUNK) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_timm_eva_state_dict``: the port's EVA01
    ``visual.`` keys -> timm's, under ``prefix``."""
    if "visual.ln_pre.weight" in state_dict:
        raise NotImplementedError("tower has ln_pre: not an EVA01 trunk (timm's Eva has no "
                                  "pre-LN)")
    back = {v: k for k, v in _BLOCK.items()}
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
            out[f"{prefix}blocks.{i}.{_rename(rest, back)}"] = val
        elif key.startswith("ln_post."):
            out[prefix + "norm." + key.split(".", 1)[1]] = val
        elif key.startswith("proj."):
            out[prefix + "head." + key.split(".", 1)[1]] = val
        else:
            raise KeyError(f"visual.{key}")
    return out


def convert_eva_clip_state_dict(state_dict: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A CustomTextCLIP state dict with a timm EVA trunk -> the port's CLIP
    keys: the trunk converted, ``text.`` taken to the top level (the port's
    CLIP holds the text tower's parts there), the rest kept."""
    out = convert_timm_eva_state_dict(state_dict)
    for k, v in state_dict.items():
        if k.startswith(TRUNK):
            continue
        out[k[len("text."):] if k.startswith("text.") else k] = v
    return out


def eva_clip_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's EVA01 CLIP keys -> open_clip's CustomTextCLIP layout (the
    inverse of ``convert_eva_clip_state_dict``)."""
    out = eva_params_to_timm_state_dict(state_dict)
    for k, v in state_dict.items():
        if k.startswith("visual."):
            continue
        out[k if k.startswith("logit_") else "text." + k] = v
    return out
