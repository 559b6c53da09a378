"""Weights carried across from the JAX package's parameter tree.

``jax_params_to_state_dict`` is the port's own copy of the ViT and text arms
of the JAX package's ``models/convert.py:flax_params_to_torch_state_dict``:
the param tree (nested dicts of numpy arrays, as ``jax.device_get`` returns
it) becomes an open_clip-layout state dict that loads into ``models.clip.CLIP``
with ``strict=True``. Dense kernels are transposed to [out, in], the fused
``in_proj_kernel`` [D, 3D] to ``in_proj_weight`` [3D, D], the HWIO patch
convolution to OIHW. Every operation is a transpose, so the same function
carries a JAX gradient tree across to the port's parameter gradients.
``jax_head_params_to_state_dict`` does the same for the DINO projection
head (``losses/dino.py:DinoProjectionHead``), and
``jax_dinov2_params_to_state_dict`` for the JAX ``Dinov2`` teacher: the
inverse of the JAX ``convert_dinov2_state_dict``, giving HF
``Dinov2Model`` keys that load into ``models/dinov2.py:Dinov2``.
``normalize_state_dict_keys`` cleans the keys of a checkpoint file.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def normalize_state_dict_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """DDP ``module.`` and ``torch.compile`` ``_orig_mod.`` prefixes stripped,
    the HF text tower's ``position_ids`` buffer dropped (the JAX package's
    ``models/convert.py:normalize_state_dict_keys``)."""
    out = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "_orig_mod."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    out.pop("text.transformer.embeddings.position_ids", None)
    return out


def _t(x, transpose: bool = False) -> torch.Tensor:
    arr = np.asarray(x, dtype=np.float32)
    if transpose and arr.ndim == 2:
        arr = arr.T
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _emit_block(sd: Dict[str, torch.Tensor], tree: Mapping[str, Any], prefix: str) -> None:
    for ln in ("ln_1", "ln_2"):
        sd[f"{prefix}.{ln}.weight"] = _t(tree[ln]["scale"])
        sd[f"{prefix}.{ln}.bias"] = _t(tree[ln]["bias"])
    attn = tree["attn"]
    sd[f"{prefix}.attn.in_proj_weight"] = _t(attn["in_proj_kernel"], transpose=True)
    if "in_proj_bias" in attn:
        sd[f"{prefix}.attn.in_proj_bias"] = _t(attn["in_proj_bias"])
    sd[f"{prefix}.attn.out_proj.weight"] = _t(attn["out_proj"]["kernel"], transpose=True)
    sd[f"{prefix}.attn.out_proj.bias"] = _t(attn["out_proj"]["bias"])
    for lin in ("c_fc", "c_proj"):
        sd[f"{prefix}.mlp.{lin}.weight"] = _t(tree["mlp"][lin]["kernel"], transpose=True)
        sd[f"{prefix}.mlp.{lin}.bias"] = _t(tree["mlp"][lin]["bias"])
    for ls in ("ls_1", "ls_2"):
        if ls in tree:
            sd[f"{prefix}.{ls}.gamma"] = _t(tree[ls]["gamma"])


def _blocks(tree: Mapping[str, Any]):
    """``resblocks_{i}`` subtrees in layer order."""
    return sorted(tree.items(), key=lambda kv: int(kv[0].rsplit("_", 1)[-1]))


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIP params (``variables["params"]``) -> open_clip state dict."""
    params = params.get("params", params)
    visual, text = params["visual"], params["text"]
    if "transformer" not in visual or "conv1" not in visual:
        raise NotImplementedError(
            "jax_params_to_state_dict covers the standard ViT vision tower; "
            f"this tree has {sorted(visual)}"
        )
    if "token_embedding" not in text or "cls_emb" in text:
        raise NotImplementedError(
            "jax_params_to_state_dict covers the causal text transformer; "
            f"this tree has {sorted(text)}"
        )
    if "attn_pool" in visual or "text_decoder" in params:
        raise NotImplementedError("CoCa trees are not ported yet")
    sd: Dict[str, torch.Tensor] = {}
    sd["visual.conv1.weight"] = _t(np.transpose(np.asarray(visual["conv1"]["kernel"]), (3, 2, 0, 1)))
    sd["visual.class_embedding"] = _t(visual["class_embedding"])
    sd["visual.positional_embedding"] = _t(visual["positional_embedding"])
    if "ln_pre" in visual:
        sd["visual.ln_pre.weight"] = _t(visual["ln_pre"]["scale"])
        sd["visual.ln_pre.bias"] = _t(visual["ln_pre"]["bias"])
    for name, block in _blocks(visual["transformer"]):
        _emit_block(sd, block, f"visual.transformer.resblocks.{name.rsplit('_', 1)[-1]}")
    sd["visual.ln_post.weight"] = _t(visual["ln_post"]["scale"])
    sd["visual.ln_post.bias"] = _t(visual["ln_post"]["bias"])
    sd["visual.proj"] = _t(visual["proj"])

    sd["token_embedding.weight"] = _t(text["token_embedding"]["embedding"])
    sd["positional_embedding"] = _t(text["positional_embedding"])
    for name, block in _blocks(text["transformer"]):
        _emit_block(sd, block, f"transformer.resblocks.{name.rsplit('_', 1)[-1]}")
    sd["ln_final.weight"] = _t(text["ln_final"]["scale"])
    sd["ln_final.bias"] = _t(text["ln_final"]["bias"])
    sd["text_projection"] = _t(text["text_projection"])

    sd["logit_scale"] = _t(params["logit_scale"])
    if "logit_bias" in params:
        sd["logit_bias"] = _t(params["logit_bias"])
    return sd


def jax_head_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DinoProjectionHead`` params -> the port head's state dict."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("proj", "fc1", "fc2"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["kernel"], transpose=True)
            sd[f"{name}.bias"] = _t(params[name]["bias"])
    if "ln" in params:
        sd["ln.weight"] = _t(params["ln"]["scale"])
        sd["ln.bias"] = _t(params["ln"]["bias"])
    return sd


def jax_dinov2_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Dinov2`` params -> HF ``Dinov2Model`` keys (no ``mask_token``):
    the fused ``in_proj_kernel`` [D, 3D] split back into query, key and value
    [D, D] each, Dense kernels transposed, the HWIO patch kernel to OIHW."""
    params = params.get("params", params)
    pos = np.asarray(params["position_embeddings"])
    d = pos.shape[-1]
    patch = params["patch_embed"]
    sd: Dict[str, torch.Tensor] = {
        "embeddings.cls_token": _t(np.asarray(params["cls_token"]).reshape(1, 1, d)),
        "embeddings.position_embeddings": _t(pos.reshape(1, -1, d)),
        "embeddings.patch_embeddings.projection.weight": _t(
            np.transpose(np.asarray(patch["kernel"]), (3, 2, 0, 1))),
        "embeddings.patch_embeddings.projection.bias": _t(patch["bias"]),
    }
    for name, blk in _blocks({k: v for k, v in params.items() if k.startswith("blocks_")}):
        pre = f"encoder.layer.{name.rsplit('_', 1)[-1]}"
        for ln in ("norm1", "norm2"):
            sd[f"{pre}.{ln}.weight"] = _t(blk[ln]["scale"])
            sd[f"{pre}.{ln}.bias"] = _t(blk[ln]["bias"])
        attn = blk["attn"]
        kernel, bias = np.asarray(attn["in_proj_kernel"]), np.asarray(attn["in_proj_bias"])
        for i, part in enumerate(("query", "key", "value")):
            sd[f"{pre}.attention.attention.{part}.weight"] = _t(
                kernel[:, i * d:(i + 1) * d], transpose=True)
            sd[f"{pre}.attention.attention.{part}.bias"] = _t(bias[i * d:(i + 1) * d])
        sd[f"{pre}.attention.output.dense.weight"] = _t(attn["out_proj"]["kernel"],
                                                        transpose=True)
        sd[f"{pre}.attention.output.dense.bias"] = _t(attn["out_proj"]["bias"])
        sd[f"{pre}.layer_scale1.lambda1"] = _t(blk["ls1"]["gamma"])
        sd[f"{pre}.layer_scale2.lambda1"] = _t(blk["ls2"]["gamma"])
        mlp = blk["mlp"] if "mlp" in blk else blk
        for lin in ("weights_in", "weights_out") if "mlp" in blk else ("fc1", "fc2"):
            sd[f"{pre}.mlp.{lin}.weight"] = _t(mlp[lin]["kernel"], transpose=True)
            sd[f"{pre}.mlp.{lin}.bias"] = _t(mlp[lin]["bias"])
    sd["layernorm.weight"] = _t(params["norm"]["scale"])
    sd["layernorm.bias"] = _t(params["norm"]["bias"])
    return sd
