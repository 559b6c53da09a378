"""Writes a MobileCLIP state dict in Apple's raw layout (ml-mobileclip's
``image_encoder.model.*`` and ``text_encoder.*``), the inverse of the renames
that ``models/convert_external.py`` applies when it reads such a file.

The input is the port's state dict of a ``MobileCLIP-S*`` (FastViT trunk) or
``MobileCLIP-B`` (MCi trunk) model: the trunk in timm's names under
``visual.trunk.``, the text tower under ``text.``, ``logit_scale``. The S
layout lists the stages flat as ``network.N`` (a stage's downsampler, its
position encoding where it has one, then its blocks, stage by stage) with
Apple's branch names (``rbr_conv``, ``rbr_scale``, ``rbr_skip``,
``lkb_origin``, ``convffn``, ``se.reduce``/``se.expand``, ``pe``, layer
scales without ``.gamma``); the B layout uses ml-cvnets' ViT names. The
projection head is written as Apple's bare matrix (``head.proj`` for S,
``classifier.proj`` for B), so its bias is dropped: the reader gives it a
zero bias, and a round trip is exact only where the bias is zero. Imports
torch alone (no JAX, nothing of the packages).

    python3 scripts/mobileclip_apple_layout.py PORT_STATE_DICT.pt APPLE.pt
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Mapping

import torch

# inverse of ``convert_external.MOBILECLIP_TEXT_RENAMES``, applied in order
TEXT_RENAMES = (
    ("transformer.resblocks.", "transformer."),
    ("in_proj_weight", "qkv_proj.weight"),
    ("in_proj_bias", "qkv_proj.bias"),
    ("mlp.c_proj", "pre_norm_ffn.4"),
    ("mlp.c_fc", "pre_norm_ffn.1"),
    ("ln_2", "pre_norm_ffn.0"),
    ("attn", "pre_norm_mha.1"),
    ("ln_1", "pre_norm_mha.0"),
    ("ln_final", "final_layer_norm"),
    ("token_embedding", "embedding_layer"),
    ("text_projection", "projection_layer"),
)
# inverse of ``convert_external.APPLE_FASTVIT_RENAMES``
FASTVIT_RENAMES = (
    ("stem.", "patch_embed."),
    ("conv_kxk", "rbr_conv"),
    ("conv_scale", "rbr_scale"),
    ("identity", "rbr_skip"),
    ("final_conv.", "conv_exp."),
    ("large_conv", "lkb_origin"),
    ("mlp", "convffn"),
    ("se.fc1", "se.reduce"),
    ("se.fc2", "se.expand"),
    ("pos_enc", "pe"),
    (".gamma", ""),
)
# inverse of ``convert_external.APPLE_MCI_RENAMES``
MCI_RENAMES = (
    ("patch_embed.backbone.", "patch_emb."),
    (".conv.", ".block.conv."),
    (".bn.", ".block.norm."),
    ("blocks.", "transformer."),
    ("norm1", "pre_norm_mha.0"),
    ("attn.qkv.", "pre_norm_mha.1.qkv_proj."),
    ("attn.proj.", "pre_norm_mha.1.out_proj."),
    ("norm2", "pre_norm_ffn.0"),
    ("mlp.fc1", "pre_norm_ffn.1"),
    ("mlp.fc2", "pre_norm_ffn.4"),
)
TRUNK = "visual.trunk."


def _rename(key: str, renames) -> str:
    for old, new in renames:
        key = key.replace(old, new)
    return key


def _fastvit(trunk: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    stages = sorted({int(k.split(".")[1]) for k in trunk if k.startswith("stages.")})
    net, n = {}, 0
    for s in stages:
        for part in ("downsample", "pos_emb", "blocks"):
            if any(k.startswith(f"stages.{s}.{part}.") for k in trunk):
                net[f"stages.{s}.{part}."] = f"network.{n}."
                n += 1
    out = {}
    for k, v in trunk.items():
        if k == "head.fc.weight":
            out["head.proj"] = v.t().contiguous()
            continue
        if k == "head.fc.bias":
            continue  # Apple's projection is a bare matrix
        m = re.match(r"^stages\.\d+\.(?:downsample|pos_emb|blocks)\.", k)
        if m:
            k = net[m.group(0)] + k[m.end():]
        out[_rename(k, FASTVIT_RENAMES)] = v
    return out


def _mci(trunk: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in trunk.items():
        if k == "head.weight":
            out["classifier.proj"] = v.t().contiguous()
        elif k == "head.bias":
            continue
        elif k == "pos_embed":
            out["pos_embed.pos_embed.pos_embed"] = v.reshape(1, 1, -1, v.shape[-1])
        elif k.startswith("norm."):
            out["post_transformer_norm." + k[len("norm."):]] = v
        else:
            out[_rename(k, MCI_RENAMES)] = v
    return out


def to_apple_layout(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's MobileCLIP state dict -> Apple's raw layout (the module
    docstring)."""
    trunk = {k[len(TRUNK):]: v for k, v in state_dict.items() if k.startswith(TRUNK)}
    image = _mci(trunk) if "cls_token" in trunk else _fastvit(trunk)
    out = {"image_encoder.model." + k: v for k, v in image.items()}
    for k, v in state_dict.items():
        if k.startswith("text."):
            k = k[len("text."):]
            if k == "positional_embedding":
                out["text_encoder.positional_embedding.pos_embed.pos_embed"] = v.reshape(
                    1, 1, *v.shape)
            else:
                out["text_encoder." + _rename(k, TEXT_RENAMES)] = v
        elif k == "logit_scale":
            out[k] = v
    return out


if __name__ == "__main__":
    src, dst = sys.argv[1:3]
    torch.save(to_apple_layout(torch.load(src, map_location="cpu", weights_only=True)), dst)
