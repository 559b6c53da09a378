"""Weights carried across from the JAX package's parameter tree.

``jax_params_to_state_dict`` is the port's own copy of the ViT, SigLIP, text
and CoCa arms of the JAX package's ``models/convert.py:
flax_params_to_torch_state_dict``: the param tree (nested dicts of numpy
arrays, as ``jax.device_get`` returns it) becomes an open_clip-layout state
dict that loads into ``models.clip.CLIP`` (or ``models.coca.CoCa``) with
``strict=True``; an EVA01 tree (no ``ln_pre``, a biased patch
embedding, a Dense ``proj``) gives the port's EVA01 keys (``models/eva.py``
converts them to open_clip's CustomTextCLIP layout and back). The ViT's
variants carry over as their leaves say: a tower without a class token
(timm's GAP ViT) has no ``visual.class_embedding``, a fixed sine-cosine
table no ``visual.positional_embedding``, a block without a QKV bias no
``attn.in_proj_bias``. The JAX exporter refuses the GAP and relative-position
trees (no published checkpoint exists), so their layout is this module's:
the standard ViT keys, and for the relative-position tower
(``models/relpos_vit.py``; its blocks at the top of the JAX tree) the
blocks under ``visual.transformer.resblocks.{i}`` with their
``relative_position_bias_table`` [entries, heads], no positional
embedding, and its bias-free Dense ``proj`` as the ``visual.proj`` matrix
[width, out]. Dense kernels
are transposed to [out, in], the fused
``in_proj_kernel`` [D, 3D] to ``in_proj_weight`` [3D, D], the HWIO patch
convolution to OIHW. Every operation is a transpose, so the same function
carries a JAX gradient tree across to the port's parameter gradients.
An EVA02 tree (``resblocks_*`` at its top with a SwiGLU or plain MLP, the
JAX exporter's sniff) gives the port's EVA02 keys (``models/eva02.py``,
which maps them to timm's and back).
A ModifiedResNet tree (``attnpool`` in it) gives open_clip's torch layout
as the JAX exporter's ``emit_resnet`` does (``tpu/models/convert.py:
445-480``): OIHW convolutions, each BatchNorm's ``weight`` and ``bias``
with its ``running_mean`` and ``running_var`` from the JAX ``batch_stats``
(required), ``downsample.0`` (convolution) and ``downsample.1`` (norm). A
ConvNeXt tree (``stem_conv``) gives timm's names under ``visual.trunk.`` as
``convnext_params_to_timm_state_dict`` emits them, and its projection as
open_clip's ``visual.head.proj``, or for the ``"mlp"`` head
``visual.head.mlp.fc1`` and ``visual.head.mlp.fc2`` (both layers: the JAX
exporter drops ``head_mlp_fc1`` and writes ``head_proj`` as ``head.proj``,
ROADMAP "Found in the JAX package"); the text tower at top level, as
open_clip's ``CLIP`` holds it for both.
A ViTamin tree (``stem_conv1``) and a Swin tree (``patch_norm``) give
timm's names under ``visual.trunk.`` as ``tpu/models/vitamin.py:
vitamin_params_to_timm_state_dict`` and ``tpu/models/swin.py:
swin_params_to_timm_state_dict`` emit them (``models/vitamin.py``,
``models/swin.py``), the projection as ``visual.trunk.head``, the text
tower at top level.
A FastViT tree (``final_conv`` and ``stem_0``) and an MCi tree
(``stem_0_conv``), each with its ``batch_stats``, give timm's names under
``visual.trunk.`` as ``tpu/models/fastvit.py:
fastvit_params_to_timm_state_dict`` and ``mci_vit_params_to_timm_state_dict``
emit them (``models/fastvit.py``), the layer scales [C, 1, 1], and the text
tower under ``text.`` (open_clip's CustomTextCLIP layout, MobileCLIP's).
``jax_head_params_to_state_dict`` does the same for the DINO projection
head (``losses/dino.py:DinoProjectionHead``), and
``jax_dinov2_params_to_state_dict`` for the JAX ``Dinov2`` teacher: the
inverse of the JAX ``convert_dinov2_state_dict``, giving HF
``Dinov2Model`` keys that load into ``models/dinov2.py:Dinov2``.
``normalize_state_dict_keys`` cleans the keys of a checkpoint file.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


# a timm trunk's ``pos_embed`` behind a convolution stem (ViTamin's, MCi's) is
# the JAX leaf ``positional_embedding``; SigLIP's, behind ``patch_embed.proj``,
# is ``position_embedding``
_CONV_STEM = "visual.trunk.patch_embed.backbone."


def jax_positional_names(names) -> set:
    """The names among a model's ``names`` whose JAX leaf is a
    ``positional_embedding`` under another name (the int8 skip and the
    optimizer groups read the JAX leaf's name)."""
    names = list(names)
    return ({"visual.trunk.pos_embed"} & set(names)
            if any(n.startswith(_CONV_STEM) for n in names) else set())


def _t(x, transpose: bool = False) -> torch.Tensor:
    arr = np.asarray(x, dtype=np.float32)
    if transpose and arr.ndim == 2:
        arr = arr.T
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _oihw(kernel) -> torch.Tensor:
    """An HWIO flax convolution kernel as torch's OIHW."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _emit_block(sd: Dict[str, torch.Tensor], tree: Mapping[str, Any], prefix: str) -> None:
    for ln in ("ln_1", "ln_2", "ln_1_kv"):
        if ln in tree:
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


def _blocks(tree: Mapping[str, Any], kind: str = "resblocks"):
    """``{kind}_{i}`` subtrees in layer order."""
    return sorted(((k, v) for k, v in tree.items() if k.startswith(kind + "_")),
                  key=lambda kv: int(kv[0].rsplit("_", 1)[-1]))


def _emit_pooler(sd: Dict[str, torch.Tensor], tree: Mapping[str, Any], prefix: str) -> None:
    """A JAX ``AttentionalPooler`` (q, k, v Dense layers) in the names of
    torch's ``nn.MultiheadAttention(kdim=vdim=context)``: one
    ``in_proj_weight`` where the context is as wide as the queries, else
    ``q_proj_weight``, ``k_proj_weight`` and ``v_proj_weight``."""
    sd[f"{prefix}.query"] = _t(tree["query"])
    for ln in ("ln_q", "ln_k"):
        sd[f"{prefix}.{ln}.weight"] = _t(tree[ln]["scale"])
        sd[f"{prefix}.{ln}.bias"] = _t(tree[ln]["bias"])
    weights = [np.asarray(tree[f"{p}_proj"]["kernel"], np.float32).T for p in "qkv"]
    if weights[0].shape == weights[1].shape:
        sd[f"{prefix}.attn.in_proj_weight"] = _t(np.concatenate(weights, axis=0))
    else:
        for p, w in zip("qkv", weights):
            sd[f"{prefix}.attn.{p}_proj_weight"] = _t(w)
    sd[f"{prefix}.attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(tree[f"{p}_proj"]["bias"], np.float32) for p in "qkv"]))
    sd[f"{prefix}.attn.out_proj.weight"] = _t(tree["out_proj"]["kernel"], transpose=True)
    sd[f"{prefix}.attn.out_proj.bias"] = _t(tree["out_proj"]["bias"])


def _emit_siglip_trunk(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``SiglipVisionTower`` tree in timm's names under
    ``visual.trunk.``, as ``tpu/models/siglip.py:
    siglip_vision_params_to_timm_state_dict`` emits it: the fused
    ``head_attn`` kernel split into the head's ``q`` and fused ``kv``."""
    pre = "visual.trunk."
    patch = visual["patch_embedding"]
    sd[pre + "patch_embed.proj.weight"] = _oihw(patch["kernel"])
    sd[pre + "patch_embed.proj.bias"] = _t(patch["bias"])
    pos = np.asarray(visual["position_embedding"])
    sd[pre + "pos_embed"] = _t(pos.reshape(1, *pos.shape))

    def dense(name: str, tree: Mapping[str, Any]) -> None:
        sd[f"{pre}{name}.weight"] = _t(tree["kernel"], transpose=True)
        sd[f"{pre}{name}.bias"] = _t(tree["bias"])

    def norm(name: str, tree: Mapping[str, Any]) -> None:
        sd[f"{pre}{name}.weight"] = _t(tree["scale"])
        sd[f"{pre}{name}.bias"] = _t(tree["bias"])

    for name, blk in _blocks(visual, "layers"):
        b = f"blocks.{name.rsplit('_', 1)[-1]}"
        norm(f"{b}.norm1", blk["layer_norm1"])
        norm(f"{b}.norm2", blk["layer_norm2"])
        dense(f"{b}.attn.qkv", {"kernel": blk["attn"]["in_proj_kernel"],
                                "bias": blk["attn"]["in_proj_bias"]})
        dense(f"{b}.attn.proj", blk["attn"]["out_proj"])
        dense(f"{b}.mlp.fc1", blk["fc1"])
        dense(f"{b}.mlp.fc2", blk["fc2"])
    norm("norm", visual["post_layernorm"])
    probe = np.asarray(visual["probe"])
    sd[pre + "attn_pool.latent"] = _t(probe.reshape(1, 1, -1))
    head = visual["head_attn"]
    kernel, bias = np.asarray(head["in_proj_kernel"]), np.asarray(head["in_proj_bias"])
    d = kernel.shape[0]
    dense("attn_pool.q", {"kernel": kernel[:, :d], "bias": bias[:d]})
    dense("attn_pool.kv", {"kernel": kernel[:, d:], "bias": bias[d:]})
    dense("attn_pool.proj", head["out_proj"])
    norm("attn_pool.norm", visual["head_layernorm"])
    dense("attn_pool.mlp.fc1", visual["head_fc1"])
    dense("attn_pool.mlp.fc2", visual["head_fc2"])


def _emit_relpos(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``RelPosVisionTower`` tree in the port's layout (the module
    docstring)."""
    sd["visual.conv1.weight"] = _oihw(visual["conv1"]["kernel"])
    sd["visual.conv1.bias"] = _t(visual["conv1"]["bias"])
    sd["visual.class_embedding"] = _t(visual["class_embedding"])
    for name, block in _blocks(visual):
        prefix = f"visual.transformer.resblocks.{name.rsplit('_', 1)[-1]}"
        _emit_block(sd, block, prefix)
        sd[f"{prefix}.relative_position_bias_table"] = _t(block["relative_position_bias_table"])
    sd["visual.ln_post.weight"] = _t(visual["ln_post"]["scale"])
    sd["visual.ln_post.bias"] = _t(visual["ln_post"]["bias"])
    sd["visual.proj"] = _t(visual["proj"]["kernel"])


def _is_eva02(visual: Mapping[str, Any]) -> bool:
    """The JAX exporter's sniff (``tpu/models/convert.py:_is_eva02``): blocks
    at the top of the tree with a SwiGLU (``fc1_g``) or plain (``fc1``) MLP."""
    mlp = visual.get("resblocks_0", {}).get("mlp")
    return isinstance(mlp, Mapping) and ("fc1_g" in mlp or "fc1" in mlp)


def _emit_eva02(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``Eva02VisionTower`` tree in the port's layout
    (``models/eva02.py``): the fused ``in_proj`` kept whole, every Dense a
    Linear, the sub-LN and SwiGLU norms as they are."""
    sd["visual.conv1.weight"] = _oihw(visual["conv1"]["kernel"])
    sd["visual.conv1.bias"] = _t(visual["conv1"]["bias"])
    sd["visual.class_embedding"] = _t(visual["class_embedding"])
    sd["visual.positional_embedding"] = _t(visual["positional_embedding"])

    def dense(name: str, tree: Mapping[str, Any]) -> None:
        sd[f"{name}.weight"] = _t(tree["kernel"], transpose=True)
        sd[f"{name}.bias"] = _t(tree["bias"])

    def norm(name: str, tree: Mapping[str, Any]) -> None:
        sd[f"{name}.weight"] = _t(tree["scale"])
        sd[f"{name}.bias"] = _t(tree["bias"])

    for name, blk in _blocks(visual):
        pre = f"visual.transformer.resblocks.{name.rsplit('_', 1)[-1]}"
        norm(f"{pre}.ln_1", blk["ln_1"])
        norm(f"{pre}.ln_2", blk["ln_2"])
        attn = blk["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = _t(attn["in_proj_kernel"], transpose=True)
        sd[f"{pre}.attn.in_proj_bias"] = _t(attn["in_proj_bias"])
        if "norm" in attn:
            norm(f"{pre}.attn.norm", attn["norm"])
        dense(f"{pre}.attn.out_proj", attn["out_proj"])
        for lin, tree in blk["mlp"].items():
            (norm if lin == "norm" else dense)(f"{pre}.mlp.{lin}", tree)
    norm("visual.ln_post", visual["ln_post"])
    dense("visual.proj", visual["proj"])


def _emit_bn(sd: Dict[str, torch.Tensor], name: str, tree: Mapping[str, Any],
             stats: Mapping[str, Any]) -> None:
    """A flax BatchNorm and its ``batch_stats`` as ``name.{weight, bias,
    running_mean, running_var}``."""
    sd[name + ".weight"] = _t(tree["scale"])
    sd[name + ".bias"] = _t(tree["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])


def _emit_resnet(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any],
                 stats: Mapping[str, Any]) -> None:
    """A JAX ``ModifiedResNet`` tree and its ``batch_stats`` in open_clip's
    torch layout (the module docstring)."""
    for i in "123":
        sd[f"visual.conv{i}.weight"] = _oihw(visual[f"conv{i}"]["kernel"])
        _emit_bn(sd, f"visual.bn{i}", visual[f"bn{i}"], stats[f"bn{i}"])
    for name in sorted((k for k in visual if k.startswith("layer")),
                       key=lambda k: tuple(int(n) for n in k[len("layer"):].split("_"))):
        stage, block = name[len("layer"):].split("_")
        pre, tree, st = f"visual.layer{stage}.{block}", visual[name], stats[name]
        for i in "123":
            sd[f"{pre}.conv{i}.weight"] = _oihw(tree[f"conv{i}"]["kernel"])
            _emit_bn(sd, f"{pre}.bn{i}", tree[f"bn{i}"], st[f"bn{i}"])
        if "downsample_conv" in tree:
            sd[f"{pre}.downsample.0.weight"] = _oihw(tree["downsample_conv"]["kernel"])
            _emit_bn(sd, f"{pre}.downsample.1", tree["downsample_bn"], st["downsample_bn"])
    pool = visual["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{proj}.weight"] = _t(pool[proj]["kernel"], transpose=True)
        sd[f"visual.attnpool.{proj}.bias"] = _t(pool[proj]["bias"])


def _emit_timm_leaf(sd: Dict[str, torch.Tensor], name: str, tree: Mapping[str, Any],
                    conv: bool = False) -> None:
    """A flax Dense, Conv or LayerNorm as ``name.weight`` (and ``.bias``)."""
    if "kernel" in tree:
        sd[f"{name}.weight"] = _oihw(tree["kernel"]) if conv else _t(tree["kernel"], True)
    if "scale" in tree:
        sd[f"{name}.weight"] = _t(tree["scale"])
    if "bias" in tree:
        sd[f"{name}.bias"] = _t(tree["bias"])


def _emit_convnext(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``ConvNextTower`` tree in open_clip's timm layout (the module
    docstring), the ``"mlp"`` head's two layers included."""
    pre, leaf = "visual.trunk.", _emit_timm_leaf
    leaf(sd, pre + "stem.0", visual["stem_conv"], conv=True)
    leaf(sd, pre + "stem.1", visual["stem_norm"])
    for name, tree in visual.items():
        if name.startswith("downsample_norm_"):
            leaf(sd, f"{pre}stages.{name.rsplit('_', 1)[-1]}.downsample.0", tree)
        elif name.startswith("downsample_conv_"):
            leaf(sd, f"{pre}stages.{name.rsplit('_', 1)[-1]}.downsample.1", tree, conv=True)
        elif name.startswith("stage") and "_block" in name:
            s, b = name[len("stage"):].split("_block")
            blk = f"{pre}stages.{s}.blocks.{b}"
            leaf(sd, f"{blk}.conv_dw", tree["conv_dw"], conv=True)
            leaf(sd, f"{blk}.norm", tree["norm"])
            leaf(sd, f"{blk}.mlp.fc1", tree["fc1"])
            leaf(sd, f"{blk}.mlp.fc2", tree["fc2"])
            sd[f"{blk}.gamma"] = _t(tree["gamma"])
    leaf(sd, pre + "head.norm", visual["head_norm"])
    if "head_mlp_fc1" in visual:
        leaf(sd, "visual.head.mlp.fc1", visual["head_mlp_fc1"])
        leaf(sd, "visual.head.mlp.fc2", visual["head_proj"])
    else:
        leaf(sd, "visual.head.proj", visual["head_proj"])


def _emit_vitamin(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``ViTaminVisionTower`` tree in timm's names under
    ``visual.trunk.`` (``tpu/models/vitamin.py:330-404``)."""
    pre, pe = "visual.trunk.", "visual.trunk.patch_embed.backbone."
    for name, tree in visual.items():
        if name in ("stem_conv1", "stem_conv2"):
            _emit_timm_leaf(sd, f"{pe}stem.conv{name[-1]}", tree, conv=True)
        elif name == "stem_norm1":
            _emit_timm_leaf(sd, f"{pe}stem.norm1", tree)
        elif name.startswith("stage") and "_block" in name:
            s, b = name[len("stage"):].split("_block")
            for part, sub in tree.items():
                _emit_timm_leaf(sd, f"{pe}stages.{s}.blocks.{b}.{part}", sub,
                                conv=part != "pre_norm")
        elif name == "embed_norm":
            _emit_timm_leaf(sd, pre + "patch_embed.pool.norm", tree)
        elif name == "embed_conv":
            _emit_timm_leaf(sd, pre + "patch_embed.pool.proj", tree, conv=True)
        elif name == "positional_embedding":
            pos = np.asarray(tree)
            sd[pre + "pos_embed"] = _t(pos.reshape(1, *pos.shape))
        elif name.startswith("resblocks_"):
            b = f"{pre}blocks.{name.rsplit('_', 1)[-1]}"
            _emit_timm_leaf(sd, f"{b}.norm1", tree["ln_1"])
            _emit_timm_leaf(sd, f"{b}.norm2", tree["ln_2"])
            attn = tree["attn"]
            qkv = {"kernel": attn["in_proj_kernel"]}
            if "in_proj_bias" in attn:
                qkv["bias"] = attn["in_proj_bias"]
            _emit_timm_leaf(sd, f"{b}.attn.qkv", qkv)
            _emit_timm_leaf(sd, f"{b}.attn.proj", attn["out_proj"])
            for part, sub in tree["mlp"].items():
                _emit_timm_leaf(sd, f"{b}.mlp.{part}", sub)
        elif name == "fc_norm":
            _emit_timm_leaf(sd, pre + "fc_norm", tree)
        elif name == "proj":
            _emit_timm_leaf(sd, pre + "head", tree)
        else:
            raise KeyError(f"unexported vitamin tower entry {name}")


def _emit_swin(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any]) -> None:
    """A JAX ``SwinVisionTower`` tree in timm's names under ``visual.trunk.``
    (``tpu/models/swin.py:466``; no ``relative_position_index``)."""
    pre = "visual.trunk."
    for name, tree in visual.items():
        if name == "patch_embed":
            _emit_timm_leaf(sd, pre + "patch_embed.proj", tree, conv=True)
        elif name == "patch_norm":
            _emit_timm_leaf(sd, pre + "patch_embed.norm", tree)
        elif "_block_" in name:
            si, bi = name[len("stage_"):].split("_block_")
            b = f"{pre}layers.{si}.blocks.{bi}"
            _emit_timm_leaf(sd, f"{b}.norm1", tree["ln_1"])
            _emit_timm_leaf(sd, f"{b}.norm2", tree["ln_2"])
            attn = tree["attn"]
            _emit_timm_leaf(sd, f"{b}.attn.qkv", {"kernel": attn["in_proj_kernel"],
                                                  "bias": attn["in_proj_bias"]})
            _emit_timm_leaf(sd, f"{b}.attn.proj", attn["out_proj"])
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                attn["relative_position_bias_table"])
            for fc in ("fc1", "fc2"):
                _emit_timm_leaf(sd, f"{b}.mlp.{fc}", tree[fc])
        elif name.endswith("_downsample"):
            ds = f"{pre}layers.{name[len('stage_'):-len('_downsample')]}.downsample"
            _emit_timm_leaf(sd, f"{ds}.reduction", tree["reduction"])
            _emit_timm_leaf(sd, f"{ds}.norm", tree["norm"])
        elif name == "norm":
            _emit_timm_leaf(sd, pre + "norm", tree)
        elif name == "proj":
            _emit_timm_leaf(sd, pre + "head", tree)
        else:
            raise KeyError(f"unexported swin tower entry {name}")


def _emit_mobileone(sd: Dict[str, torch.Tensor], pre: str, tree: Mapping[str, Any],
                    stats: Mapping[str, Any]) -> None:
    """A JAX ``MobileOneBlock`` subtree in timm's names (``tpu/models/
    fastvit.py:_emit_mobileone_inv``)."""
    for name, sub in tree.items():
        if name == "identity":
            _emit_bn(sd, f"{pre}.identity", sub, stats[name])
        elif name.endswith("_conv"):
            branch = name[:-len("_conv")]
            if branch.startswith("conv_kxk_"):
                branch = "conv_kxk." + branch[len("conv_kxk_"):]
            sd[f"{pre}.{branch}.conv.weight"] = _oihw(sub["kernel"])
        elif name.endswith("_bn"):
            branch = name[:-len("_bn")]
            if branch.startswith("conv_kxk_"):
                branch = "conv_kxk." + branch[len("conv_kxk_"):]
            _emit_bn(sd, f"{pre}.{branch}.bn", sub, stats[name])
        elif name == "se":
            for fc, leaf in sub.items():
                _emit_timm_leaf(sd, f"{pre}.se.{fc}", leaf, conv=True)
        else:
            raise KeyError(f"unexported MobileOne leaf {pre}/{name}")


def _emit_fastvit(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any],
                  stats: Mapping[str, Any]) -> None:
    """A JAX ``FastVitTower`` tree and its ``batch_stats`` in timm's names
    under ``visual.trunk.`` (``tpu/models/fastvit.py:
    fastvit_params_to_timm_state_dict``), the layer scales [C, 1, 1]."""
    pre = "visual.trunk."

    def gamma(name: str, v) -> None:
        sd[name + ".gamma"] = _t(np.asarray(v).reshape(-1, 1, 1))

    for name, p in visual.items():
        s = stats.get(name, {})
        if name.startswith("stem_"):
            _emit_mobileone(sd, f"{pre}stem.{name.split('_')[1]}", p, s)
        elif name == "final_conv":
            _emit_mobileone(sd, pre + "final_conv", p, s)
        elif name == "head_fc":
            _emit_timm_leaf(sd, pre + "head.fc", p)
        elif name.endswith("_downsample"):
            d = f"{pre}stages.{name[len('stage'):-len('_downsample')]}.downsample.proj"
            p0, s0 = p["proj_0"], s.get("proj_0", {})
            for sub, leaf in p0.items():
                if sub.endswith("_conv"):
                    sd[f"{d}.0.{sub[:-len('_conv')]}.conv.weight"] = _oihw(leaf["kernel"])
                elif sub.endswith("_bn"):
                    _emit_bn(sd, f"{d}.0.{sub[:-len('_bn')]}.bn", leaf, s0[sub])
                else:  # se
                    for fc, fl in leaf.items():
                        _emit_timm_leaf(sd, f"{d}.0.se.{fc}", fl, conv=True)
            _emit_mobileone(sd, f"{d}.1", p["proj_1"], s.get("proj_1", {}))
        elif name.endswith("_pos_emb"):
            _emit_timm_leaf(sd, f"{pre}stages.{name[len('stage'):-len('_pos_emb')]}.pos_emb."
                            "pos_enc", p["pos_enc"], conv=True)
        elif name.startswith("stage") and "_block" in name:
            st, b = name[len("stage"):].split("_block")
            bp = f"{pre}stages.{st}.blocks.{b}"
            for sub, leaf in p.items():
                if sub == "token_mixer":
                    for m, ml in leaf.items():
                        if m in ("norm", "mixer"):
                            _emit_mobileone(sd, f"{bp}.token_mixer.{m}", ml,
                                            s["token_mixer"][m])
                        elif m == "layer_scale":
                            gamma(f"{bp}.token_mixer.layer_scale", ml)
                        else:  # qkv, proj
                            _emit_timm_leaf(sd, f"{bp}.token_mixer.{m}", ml)
                elif sub == "norm":
                    _emit_bn(sd, f"{bp}.norm", leaf, s["norm"])
                elif sub == "mlp":
                    sd[f"{bp}.mlp.conv.conv.weight"] = _oihw(leaf["conv"]["kernel"])
                    _emit_bn(sd, f"{bp}.mlp.conv.bn", leaf["conv_bn"], s["mlp"]["conv_bn"])
                    for fc in ("fc1", "fc2"):
                        _emit_timm_leaf(sd, f"{bp}.mlp.{fc}", leaf[fc], conv=True)
                else:  # layer_scale, layer_scale_1, layer_scale_2
                    gamma(f"{bp}.{sub}", leaf)
        else:
            raise KeyError(f"unexported fastvit tower entry {name}")


def _emit_mci(sd: Dict[str, torch.Tensor], visual: Mapping[str, Any],
              stats: Mapping[str, Any]) -> None:
    """A JAX ``MciVisionTransformer`` tree and its stem's ``batch_stats`` in
    timm's names under ``visual.trunk.`` (``tpu/models/fastvit.py:
    mci_vit_params_to_timm_state_dict``)."""
    pre = "visual.trunk."
    for name, p in visual.items():
        if name.startswith("stem_") and name.endswith("_conv"):
            sd[f"{pre}patch_embed.backbone.{name[5:-5]}.conv.weight"] = _oihw(p["kernel"])
        elif name.startswith("stem_") and name.endswith("_bn"):
            _emit_bn(sd, f"{pre}patch_embed.backbone.{name[5:-3]}.bn", p, stats[name])
        elif name == "class_embedding":
            sd[pre + "cls_token"] = _t(np.asarray(p).reshape(1, 1, -1))
        elif name == "positional_embedding":
            sd[pre + "pos_embed"] = _t(np.asarray(p).reshape(1, *np.shape(p)))
        elif name == "norm":
            _emit_timm_leaf(sd, pre + "norm", p)
        elif name == "head_fc":
            _emit_timm_leaf(sd, pre + "head", p)
        elif name.startswith("resblocks_"):
            b = f"{pre}blocks.{name.rsplit('_', 1)[-1]}"
            _emit_timm_leaf(sd, f"{b}.norm1", p["ln_1"])
            _emit_timm_leaf(sd, f"{b}.norm2", p["ln_2"])
            attn = p["attn"]
            qkv = {"kernel": attn["in_proj_kernel"]}
            if "in_proj_bias" in attn:
                qkv["bias"] = attn["in_proj_bias"]
            _emit_timm_leaf(sd, f"{b}.attn.qkv", qkv)
            _emit_timm_leaf(sd, f"{b}.attn.proj", attn["out_proj"])
            _emit_timm_leaf(sd, f"{b}.mlp.fc1", p["mlp"]["c_fc"])
            _emit_timm_leaf(sd, f"{b}.mlp.fc2", p["mlp"]["c_proj"])
        else:
            raise KeyError(f"unexported mci-vit tower entry {name}")


def _emit_text(sd: Dict[str, torch.Tensor], text: Mapping[str, Any], tp: str) -> None:
    """A JAX ``TextTransformer`` tree under the prefix ``tp``; its
    projection a matrix, a Dense (``proj_bias``: ``text_projection.weight``
    and ``.bias``) or none (``proj_type: "none"``)."""
    sd[f"{tp}token_embedding.weight"] = _t(text["token_embedding"]["embedding"])
    sd[f"{tp}positional_embedding"] = _t(text["positional_embedding"])
    if "cls_emb" in text:
        sd[f"{tp}cls_emb"] = _t(text["cls_emb"])
    for name, block in _blocks(text["transformer"]):
        _emit_block(sd, block, f"{tp}transformer.resblocks.{name.rsplit('_', 1)[-1]}")
    sd[f"{tp}ln_final.weight"] = _t(text["ln_final"]["scale"])
    sd[f"{tp}ln_final.bias"] = _t(text["ln_final"]["bias"])
    proj = text.get("text_projection")
    if isinstance(proj, Mapping):
        sd[f"{tp}text_projection.weight"] = _t(proj["kernel"], transpose=True)
        sd[f"{tp}text_projection.bias"] = _t(proj["bias"])
    elif proj is not None:
        sd[f"{tp}text_projection"] = _t(proj)


def jax_params_to_state_dict(params: Mapping[str, Any],
                             batch_stats: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, torch.Tensor]:
    """JAX CLIP, SigLIP or CoCa params (``variables["params"]``, or the
    variables themselves) -> open_clip state dict; a ModifiedResNet's
    running statistics come from ``batch_stats`` (else the variables'
    ``"batch_stats"``). CLIP's text tower at top level; SigLIP's in open_clip's
    CustomTextCLIP layout (the trunk in timm's names under ``visual.trunk.``,
    the text tower under ``text.``, ``logit_bias``), as the JAX exporter
    emits it; CoCa's text under ``text.``, with its attentional poolers
    (``visual.attn_pool``, ``visual.attn_pool_contrastive``) and its decoder
    (``text_decoder.resblocks``, ``text_decoder.cross_attn``)."""
    if batch_stats is None:
        batch_stats = params.get("batch_stats")
    params = params.get("params", params)
    visual, text = params["visual"], params["text"]
    coca = "text_decoder" in params
    if "token_embedding" not in text or ("cls_emb" in text and not coca):
        raise NotImplementedError(
            "jax_params_to_state_dict covers the causal text transformer; "
            f"this tree has {sorted(text)}"
        )
    sd: Dict[str, torch.Tensor] = {}
    if "resblocks_0" in visual and "relative_position_bias_table" in visual["resblocks_0"]:
        _emit_relpos(sd, visual)
        _emit_text(sd, text, "")
        sd["logit_scale"] = _t(params["logit_scale"])
        return sd
    if ("final_conv" in visual and "stem_0" in visual) or "stem_0_conv" in visual:
        # MobileCLIP's FastViT or MCi trunk: open_clip's CustomTextCLIP layout
        if batch_stats is None or "visual" not in batch_stats:
            raise ValueError("a FastViT or MCi tree needs its batch_stats (BatchNorm's "
                             "running statistics)")
        (_emit_fastvit if "final_conv" in visual else _emit_mci)(sd, visual,
                                                                 batch_stats["visual"])
        _emit_text(sd, text, "text.")
        sd["logit_scale"] = _t(params["logit_scale"])
        return sd
    if "stem_conv1" in visual or "patch_norm" in visual:  # ViTamin, Swin
        (_emit_vitamin if "stem_conv1" in visual else _emit_swin)(sd, visual)
        _emit_text(sd, text, "")
        sd["logit_scale"] = _t(params["logit_scale"])
        return sd
    if "attnpool" in visual or "stem_conv" in visual:
        if "attnpool" in visual:
            if batch_stats is None or "visual" not in batch_stats:
                raise ValueError("a ModifiedResNet tree needs its batch_stats (BatchNorm's "
                                 "running statistics)")
            _emit_resnet(sd, visual, batch_stats["visual"])
        else:
            _emit_convnext(sd, visual)
        _emit_text(sd, text, "")
        sd["logit_scale"] = _t(params["logit_scale"])
        return sd
    if _is_eva02(visual):
        _emit_eva02(sd, visual)
        _emit_text(sd, text, "")
        sd["logit_scale"] = _t(params["logit_scale"])
        return sd
    if "patch_embedding" in visual and "probe" in visual:  # the SigLIP tower
        _emit_siglip_trunk(sd, visual)
        _emit_text(sd, text, "text.")
        sd["logit_scale"] = _t(params["logit_scale"])
        if "logit_bias" in params:
            sd["logit_bias"] = _t(params["logit_bias"])
        return sd
    if "transformer" not in visual or "conv1" not in visual:
        raise NotImplementedError(
            "jax_params_to_state_dict covers the standard ViT vision tower; "
            f"this tree has {sorted(visual)}"
        )
    sd["visual.conv1.weight"] = _oihw(visual["conv1"]["kernel"])
    if "bias" in visual["conv1"]:  # EVA01's biased patch embedding
        sd["visual.conv1.bias"] = _t(visual["conv1"]["bias"])
    for name in ("class_embedding", "positional_embedding"):  # a GAP or sin-cos tower lacks one
        if name in visual:
            sd[f"visual.{name}"] = _t(visual[name])
    if "ln_pre" in visual:
        sd["visual.ln_pre.weight"] = _t(visual["ln_pre"]["scale"])
        sd["visual.ln_pre.bias"] = _t(visual["ln_pre"]["bias"])
    for name, block in _blocks(visual["transformer"]):
        _emit_block(sd, block, f"visual.transformer.resblocks.{name.rsplit('_', 1)[-1]}")
    sd["visual.ln_post.weight"] = _t(visual["ln_post"]["scale"])
    sd["visual.ln_post.bias"] = _t(visual["ln_post"]["bias"])
    for pool in ("attn_pool", "attn_pool_contrastive"):
        if pool in visual:
            _emit_pooler(sd, visual[pool], f"visual.{pool}")
    if isinstance(visual["proj"], Mapping):  # EVA01's biased head (a Dense)
        sd["visual.proj.weight"] = _t(visual["proj"]["kernel"], transpose=True)
        sd["visual.proj.bias"] = _t(visual["proj"]["bias"])
    else:
        sd["visual.proj"] = _t(visual["proj"])

    _emit_text(sd, text, "text." if coca else "")

    if coca:
        dec = params["text_decoder"]
        for kind in ("resblocks", "cross_attn"):
            for name, block in _blocks(dec, kind):
                _emit_block(sd, block, f"text_decoder.{kind}.{name.rsplit('_', 1)[-1]}")
        sd["text_decoder.ln_final.weight"] = _t(dec["ln_final"]["scale"])
        sd["text_decoder.ln_final.bias"] = _t(dec["ln_final"]["bias"])
        sd["text_decoder.text_projection"] = _t(dec["text_projection"])

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
        "embeddings.patch_embeddings.projection.weight": _oihw(patch["kernel"]),
        "embeddings.patch_embeddings.projection.bias": _t(patch["bias"]),
    }
    for name, blk in _blocks(params, "blocks"):
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
