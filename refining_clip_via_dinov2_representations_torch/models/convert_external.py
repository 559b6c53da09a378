"""Checkpoint layouts from outside open_clip: big_vision's SigLIP ``.npz`` and
Apple's MobileCLIP files.

The port of the JAX package's ``models/convert_external.py``:

* big_vision (``load_big_vision_weights``): the ``txt/`` and ``img/`` trees
  of a SigLIP ``.npz`` become the numpy trees the JAX functions build (the
  per-head query, key and value fused into one ``[D, 3D]`` kernel, the
  position tables flattened), which the port's own emitters
  (``models/convert.py:_emit_text``, ``_emit_siglip_trunk``) then write in
  the port's keys: the text tower under ``text.``, the trunk under
  ``visual.trunk.``, ``logit_scale`` and ``logit_bias`` from ``t`` and
  ``b``. A file without ``img/`` gives the text tower and the scalars
  alone.
* Apple's MobileCLIP (``convert_state_dict``): the text encoder's names
  (``text_encoder.``) renamed onto open_clip's under ``text.``; the image
  encoder (``image_encoder.model.``) renamed onto timm's layout, then through
  ``models/fastvit.py``'s importers. The S layout (``rbr_*`` branch names, a
  flat ``network.N`` list) re-keys each list entry by its role, read from its
  keys: one holding ``proj.`` is a stage's downsampler, one holding
  ``pos_enc.`` (Apple's ``pe.``) its position encoding, any other a stage's
  blocks; a bare ``head.proj`` matrix becomes ``head.fc`` with a zero bias.
  The B layout (ml-cvnets' ViT names) maps as the text side does; its
  ``classifier.proj``/``head.proj`` matrix becomes ``head`` with a zero bias.

Neither layout is value-verified against a published file in either
package (``tpu/models/fastvit.py:25-31``); the port holds to the JAX
package's renames.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .fastvit import convert_timm_fastvit_state_dict, convert_timm_mci_vit_state_dict

MOBILECLIP_S_KEY = "image_encoder.model.patch_embed.0.rbr_conv.0.conv.weight"
MOBILECLIP_PREFIX = "image_encoder.model."


def _fuse_qkv(q_k, k_k, v_k, q_b, k_b, v_b) -> Tuple[np.ndarray, np.ndarray]:
    """big_vision's per-head attention [D, H, Dh] (+ bias [H, Dh]) -> one
    [D, 3D] kernel and its [3D] bias."""
    d = q_k.shape[0]
    kernel = np.concatenate([t.reshape(d, -1) for t in (q_k, k_k, v_k)], axis=1)
    bias = np.concatenate([t.reshape(-1) for t in (q_b, k_b, v_b)])
    return kernel.astype(np.float32), bias.astype(np.float32)


def _getter(npz: Mapping[str, np.ndarray], prefix: str, side: str):
    def g(key: str) -> np.ndarray:
        for cand in (prefix + key, side + key, key):
            if cand in npz:
                return np.asarray(npz[cand], np.float32)
        raise KeyError(prefix + key)
    return g


def _mha(g, mha: str) -> Dict[str, Any]:
    kernel, bias = _fuse_qkv(g(mha + "query/kernel"), g(mha + "key/kernel"),
                             g(mha + "value/kernel"), g(mha + "query/bias"),
                             g(mha + "key/bias"), g(mha + "value/bias"))
    d = kernel.shape[0]
    return {"in_proj_kernel": kernel, "in_proj_bias": bias,
            "out_proj": {"kernel": g(mha + "out/kernel").reshape(d, d),
                         "bias": g(mha + "out/bias")}}


def _norm(g, name: str) -> Dict[str, np.ndarray]:
    return {"scale": g(name + "/scale"), "bias": g(name + "/bias")}


def _dense(g, name: str) -> Dict[str, np.ndarray]:
    return {"kernel": g(name + "/kernel"), "bias": g(name + "/bias")}


def load_big_vision_text_params(npz: Mapping[str, np.ndarray], prefix: str = "params/txt/"
                                ) -> Dict[str, Any]:
    """The ``txt/`` side as the JAX ``TextTransformer`` tree
    (``tpu/models/convert_external.py:load_big_vision_text_params``)."""
    g = _getter(npz, prefix, "txt/")
    emb = g("Embed_0/embedding")
    params: Dict[str, Any] = {
        "token_embedding": {"embedding": emb},
        "positional_embedding": g("pos_embedding").reshape(-1, emb.shape[1]),
        "ln_final": _norm(g, "Encoder_0/encoder_norm"),
        "text_projection": _dense(g, "head"),
        "transformer": {},
    }
    i = 0
    while True:
        bp = f"Encoder_0/encoderblock_{i}/"
        try:
            ln1 = _norm(g, bp + "LayerNorm_0")
        except KeyError:
            break
        params["transformer"][f"resblocks_{i}"] = {
            "ln_1": ln1, "attn": _mha(g, bp + "MultiHeadDotProductAttention_0/"),
            "ln_2": _norm(g, bp + "LayerNorm_1"),
            "mlp": {"c_fc": _dense(g, bp + "MlpBlock_0/Dense_0"),
                    "c_proj": _dense(g, bp + "MlpBlock_0/Dense_1")}}
        i += 1
    return params


def load_big_vision_image_params(npz: Mapping[str, np.ndarray], prefix: str = "params/img/"
                                 ) -> Dict[str, Any]:
    """The ``img/`` side as the JAX ``SiglipVisionTower`` tree
    (``tpu/models/convert_external.py:load_big_vision_image_params``)."""
    g = _getter(npz, prefix, "img/")
    width = g("embedding/bias").shape[0]
    params: Dict[str, Any] = {
        "patch_embedding": _dense(g, "embedding"),
        "position_embedding": g("pos_embedding").reshape(-1, width),
        "post_layernorm": _norm(g, "Transformer/encoder_norm"),
    }
    i = 0
    while True:
        bp = f"Transformer/encoderblock_{i}/"
        try:
            ln1 = _norm(g, bp + "LayerNorm_0")
        except KeyError:
            break
        params[f"layers_{i}"] = {
            "layer_norm1": ln1, "attn": _mha(g, bp + "MultiHeadDotProductAttention_0/"),
            "layer_norm2": _norm(g, bp + "LayerNorm_1"),
            "fc1": _dense(g, bp + "MlpBlock_0/Dense_0"),
            "fc2": _dense(g, bp + "MlpBlock_0/Dense_1")}
        i += 1
    head = "MAPHead_0/"
    params["probe"] = g(head + "probe").reshape(1, width)
    params["head_attn"] = _mha(g, head + "MultiHeadDotProductAttention_0/")
    params["head_layernorm"] = _norm(g, head + "LayerNorm_0")
    params["head_fc1"] = _dense(g, head + "MlpBlock_0/Dense_0")
    params["head_fc2"] = _dense(g, head + "MlpBlock_0/Dense_1")
    return params


def is_big_vision(keys) -> bool:
    """The JAX loader's sniff of a big_vision ``.npz``."""
    return any(("txt/" in k) or ("img/" in k) for k in keys)


def load_big_vision_weights(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """A big_vision SigLIP ``.npz`` -> the port's state dict (the module
    docstring)."""
    from .convert import _emit_siglip_trunk, _emit_text

    with np.load(checkpoint_path) as z:
        npz = {k: np.asarray(z[k]) for k in z.files}
    prefix = "params/" if any(k.startswith("params/") for k in npz) else ""
    sd: Dict[str, torch.Tensor] = {}
    _emit_text(sd, load_big_vision_text_params(npz, prefix + "txt/"), "text.")
    if any(k.startswith((prefix + "img/", "img/")) for k in npz):
        _emit_siglip_trunk(sd, load_big_vision_image_params(npz, prefix + "img/"))
    for name, key in (("logit_scale", "t"), ("logit_bias", "b")):
        for cand in (prefix + key, key):
            if cand in npz:
                sd[name] = torch.tensor(float(np.asarray(npz[cand], np.float32).reshape(())))
    return sd


# Apple's text-encoder names -> open_clip's (``tpu/models/convert_external.py:
# 184-210``), in order
MOBILECLIP_TEXT_RENAMES = (
    ("projection_layer", "text_projection"),
    ("embedding_layer", "token_embedding"),
    ("final_layer_norm", "ln_final"),
    ("pre_norm_mha.0", "ln_1"),
    ("pre_norm_mha.1", "attn"),
    ("pre_norm_ffn.0", "ln_2"),
    ("pre_norm_ffn.1", "mlp.c_fc"),
    ("pre_norm_ffn.4", "mlp.c_proj"),
    ("qkv_proj.weight", "in_proj_weight"),
    ("qkv_proj.bias", "in_proj_bias"),
    ("transformer.", "transformer.resblocks."),
)
MOBILECLIP_POS = "positional_embedding.pos_embed.pos_embed"


def convert_mobileclip_text_state_dict(state_dict: Mapping[str, Any],
                                       prefix: str = "text_encoder.") -> Dict[str, Any]:
    """Apple's text encoder (keys under ``prefix``) -> open_clip's names
    under ``text.``; the position table squeezed."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.startswith(MOBILECLIP_POS):
            k, v = k.replace(MOBILECLIP_POS, "positional_embedding"), v.squeeze()
        for old, new in MOBILECLIP_TEXT_RENAMES:
            k = k.replace(old, new)
        out["text." + k] = v
    return out


# Apple's ml-fastvit names -> timm's (timm's checkpoint_filter_fn)
APPLE_FASTVIT_RENAMES = (
    ("patch_embed.", "stem."),
    ("rbr_conv", "conv_kxk"),
    ("rbr_scale", "conv_scale"),
    ("rbr_skip", "identity"),
    ("conv_exp.", "final_conv."),
    ("lkb_origin", "large_conv"),
    ("convffn", "mlp"),
    ("se.reduce", "se.fc1"),
    ("se.expand", "se.fc2"),
)


def convert_mobileclip_s_image_state_dict(state_dict: Mapping[str, Any],
                                          prefix: str = MOBILECLIP_PREFIX) -> Dict[str, Any]:
    """Apple's S image encoder -> timm's FastViT names under
    ``visual.trunk.`` (the module docstring)."""
    items: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        for old, new in APPLE_FASTVIT_RENAMES:
            k = k.replace(old, new)
        items[k.replace(".pe.", ".pos_enc.")] = v
    net = sorted({int(k.split(".")[1]) for k in items if k.startswith("network.")})
    remap: Dict[int, str] = {}
    stage = 0
    for idx in net:
        rests = [k.split(".", 2)[2] for k in items if k.startswith(f"network.{idx}.")]
        if any(r.startswith("proj.") for r in rests):
            remap[idx] = f"stages.{stage}.downsample"
        elif any(r.startswith("pos_enc.") for r in rests):
            remap[idx] = f"stages.{stage}.pos_emb"
        else:
            remap[idx] = f"stages.{stage}.blocks"
            stage += 1
    out: Dict[str, Any] = {}
    for k, v in items.items():
        if k.startswith("network."):
            parts = k.split(".")
            k = remap[int(parts[1])] + "." + ".".join(parts[2:])
        if k == "head.proj" and v.ndim == 2:  # a bare projection: Linear, zero bias
            out["visual.trunk.head.fc.weight"] = v.t()
            out["visual.trunk.head.fc.bias"] = torch.zeros(v.shape[1], dtype=v.dtype)
            continue
        if k.startswith("head."):
            k = k.replace("head.weight", "head.fc.weight").replace("head.bias", "head.fc.bias")
        out["visual.trunk." + k] = v
    return out


# Apple's MobileCLIP-B image names -> timm's ``vit_base_mci_224``, in order
APPLE_MCI_RENAMES = (
    ("patch_emb.", "patch_embed.backbone."),
    (".block.conv.", ".conv."),
    (".block.norm.", ".bn."),
    ("post_transformer_norm.", "norm."),
    ("pre_norm_mha.0", "norm1"),
    ("pre_norm_mha.1", "attn"),
    ("pre_norm_ffn.0", "norm2"),
    ("pre_norm_ffn.1", "mlp.fc1"),
    ("pre_norm_ffn.4", "mlp.fc2"),
    ("qkv_proj.", "qkv."),
    ("out_proj.", "proj."),
)
APPLE_MCI_POS = "pos_embed.pos_embed.pos_embed"


def convert_mobileclip_b_image_state_dict(state_dict: Mapping[str, Any],
                                          prefix: str = MOBILECLIP_PREFIX) -> Dict[str, Any]:
    """Apple's B image encoder -> timm's ``vit_base_mci_224`` names under
    ``visual.trunk.`` (the module docstring)."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.startswith(APPLE_MCI_POS):
            k, v = "pos_embed", v.reshape(-1, v.shape[-1])
        for old, new in APPLE_MCI_RENAMES:
            k = k.replace(old, new)
        if k.startswith("transformer."):
            k = k.replace("transformer.", "blocks.")
        if k.startswith(("classifier.proj", "head.proj")):
            out["visual.trunk.head.weight"] = v.t() if v.ndim == 2 else v
            out["visual.trunk.head.bias"] = torch.zeros(v.shape[-1] if v.ndim == 1
                                                        else v.shape[1], dtype=v.dtype)
            continue
        out["visual.trunk." + k] = v
    return out


def is_mobileclip(keys) -> bool:
    return any(k.startswith(MOBILECLIP_PREFIX) for k in keys)


def convert_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An Apple MobileCLIP file -> the port's state dict: the text tower
    under ``text.``, the trunk in the port's names, ``logit_scale``
    (``tpu/models/convert_external.py:load_mobileclip_variables``)."""
    text = convert_mobileclip_text_state_dict(state_dict)
    if not text:
        raise ValueError("MobileCLIP checkpoint detected but no text_encoder keys found")
    if "logit_scale" in state_dict:
        text["logit_scale"] = state_dict["logit_scale"]
    if MOBILECLIP_S_KEY in state_dict:
        text.update(convert_timm_fastvit_state_dict(
            convert_mobileclip_s_image_state_dict(state_dict)))
    else:
        text.update(convert_timm_mci_vit_state_dict(
            convert_mobileclip_b_image_state_dict(state_dict)))
    return text
