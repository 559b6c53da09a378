"""The port's CLIP against the JAX package's on the same weights (CPU, fp32).

The JAX side builds with ``attn_impl="fused"``, so its attention is the
Pallas kernel interpreted off-TPU; the port's attention on CPU tensors is its
fused kernel's plain version. Features are compared at 1e-4 absolute: fp32
matmul summation order differs between XLA and PyTorch, and the error grows
through the layers but stays well inside that.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model, get_model_config, jax_params_to_state_dict, parse_model_cfg,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

TOL = 1e-4


def _features_match(cfg, batch, seed):
    import jax.numpy as jnp

    jmodel, variables = jax_clip(cfg, seed=seed)
    model = port_clip(cfg, variables["params"])
    size = cfg["vision_cfg"]["image_size"]
    ctx = cfg["text_cfg"]["context_length"]
    img, txt = images(batch, size, seed), token_ids(batch, ctx, seed)
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(txt))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(txt))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(float(got["logit_scale"]), float(want["logit_scale"]),
                               rtol=1e-6)
    # unnormalised features too (the engine normalises them itself)
    want_raw = jmodel.apply(variables, jnp.asarray(img), method="encode_image")
    with torch.no_grad():
        got_raw = model.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw), atol=TOL, rtol=1e-4)


def test_converter_matches_jax_exporter_and_loads_strict():
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    _, variables = jax_clip(TINY_CFG, seed=3)
    want = flax_params_to_torch_state_dict(variables["params"])
    got = jax_params_to_state_dict(variables["params"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        torch.testing.assert_close(got[key], want[key].float(), atol=0, rtol=0, msg=key)
    model = build_model(parse_model_cfg(TINY_CFG))
    model.load_state_dict(got, strict=True)
    assert sorted(model.state_dict()) == sorted(want)


def test_tiny_clip_matches_jax():
    _features_match(TINY_CFG, batch=3, seed=0)


def test_tiny_clip_bf16_compute_matches_jax():
    """``dtype=bfloat16`` compute over fp32 params (tanh GELU, fp32 LayerNorm
    statistics) in both packages. Features are compared at 2e-2 absolute:
    about ten bf16 ulps at |x| ~ 0.5, since the two frameworks round to bf16
    after different ops (seen: up to 3 ulps on seeds 0-3)."""
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build_model, parse_model_cfg as jax_parse_model_cfg,
    )

    _, variables = jax_clip(TINY_CFG, seed=4)
    jmodel = jax_build_model(jax_parse_model_cfg(TINY_CFG), dtype=jnp.bfloat16,
                             attn_impl="fused")
    model = build_model(parse_model_cfg(TINY_CFG), dtype=torch.bfloat16)
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    img, txt = images(3, 16, seed=4), token_ids(3, 12, seed=4)
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(txt))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(txt))
    for key in ("image_features", "text_features"):
        assert got[key].dtype == torch.bfloat16, key
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key]).astype(np.float32),
                                   atol=2e-2, rtol=0, err_msg=key)


def test_vit_b16_widths_depth1_matches_jax():
    """ViT-B-16's real widths (768/12 heads, 512/8 heads, 197 and 77 tokens,
    head dim 64) at depth 1 in each tower, batch 2."""
    cfg = get_model_config("ViT-B-16")
    cfg["vision_cfg"]["layers"] = 1
    cfg["text_cfg"]["layers"] = 1
    _features_match(cfg, batch=2, seed=1)


@pytest.mark.parametrize("overrides", [
    {"vision_cfg": {"timm_model_name": "vit_base_patch16_224"}},
    # the ModifiedResNet, ConvNeXt, Swin, ViTamin and MobileCLIP towers are
    # ported (tests/test_torch_resnet.py, test_torch_convnext.py,
    # test_torch_swin.py, test_torch_vitamin.py, test_torch_fastvit.py); a timm
    # FastViT outside the registry's mci trunks raises in both packages
    {"vision_cfg": {"timm_model_name": "fastvit_t8"}},
    {"text_cfg": {"hf_model_name": "bert-base-uncased"}},
    {"text_cfg": {"embed_cls": True}},
    # CoCa is ported (tests/test_torch_coca.py); its HF-text-tower variant
    # (coca_roberta-ViT-B-32) is not
    {"multimodal_cfg": {"width": 32}, "text_cfg": {"hf_model_name": "roberta-base"}},
    # the CLIPA towers and MobileCLIP-B's MCi ViT are ported
    # (tests/test_torch_vit_variants.py, test_torch_fastvit.py); the HF text
    # towers are not yet ported (the JAX package builds them)
    {"text_cfg": {"hf_model_name": "xlm-roberta-base"}},
    # SigLIP's text options are ported (tests/test_torch_siglip.py); its
    # global-average-pooled `_gap` trunks are not
    {"vision_cfg": {"timm_model_name": "vit_base_patch16_siglip_gap_224"}},
])
def test_unported_towers_raise(overrides):
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in TINY_CFG.items()}
    for key, extra in overrides.items():
        cfg[key] = {**cfg.get(key, {}), **extra}
    with pytest.raises(NotImplementedError):
        build_model(parse_model_cfg(cfg))


def test_registry_holds_vit_b16_and_b32():
    from refining_clip_via_dinov2_representations_tpu.models import (
        get_model_config as jax_get_model_config,
    )
    from refining_clip_via_dinov2_representations_torch.models._registry_data import (
        MODEL_CONFIGS,
    )

    assert "ViT-B-16" in MODEL_CONFIGS and "ViT-B-32" in MODEL_CONFIGS
    for name in MODEL_CONFIGS:  # the port's entries are the JAX registry's, number for number
        assert get_model_config(name) == jax_get_model_config(name), name
    cfg = parse_model_cfg(get_model_config("ViT-B-16"))
    assert (cfg.vision_cfg.heads, cfg.vision_cfg.seq_len, cfg.text_cfg.heads) == (12, 197, 8)


def _family_cfg(family, monkeypatch):
    """A small config of each tower family ``build_model`` builds (the
    fixed-width timm ViTs at their own size)."""
    from refining_clip_via_dinov2_representations_torch.models import convnext, eva02, siglip

    from .torch_coca_utils import TINY_COCA

    text = {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4, "layers": 1}
    timm = {"timm_model_pretrained": False, "timm_pool": "", "timm_proj": "linear"}
    if family == "vit":
        return TINY_CFG
    if family == "coca":
        return TINY_COCA
    if family == "resnet":
        return {"embed_dim": 32, "text_cfg": text,
                "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8,
                               "patch_size": None}}
    if family == "convnext":
        monkeypatch.setitem(convnext.CONVNEXT_DIMS, "convnext_tiny_test",
                            ((1, 1, 1, 1), (8, 16, 32, 64)))
        return {"embed_dim": 32, "text_cfg": text,
                "vision_cfg": {"image_size": 64, "timm_model_name": "convnext_tiny_test",
                               **timm, "timm_proj": "mlp"}}
    if family == "siglip":
        monkeypatch.setitem(siglip._SIGLIP_FAMILY_DIMS, "base", (32, 2, 4, 64))
        return {"embed_dim": 32, "custom_text": True, "init_logit_bias": -10,
                "text_cfg": {**text, "no_causal_mask": True, "pool_type": "last",
                             "proj_bias": True},
                "vision_cfg": {"image_size": 32, "timm_model_name": "vit_base_patch8_siglip_32",
                               **timm, "timm_pool": "map", "timm_proj": "none"}}
    if family == "fastvit":
        from refining_clip_via_dinov2_representations_torch.models import fastvit

        monkeypatch.setitem(fastvit.FASTVIT_DIMS, "fastvit_tiny_test", fastvit.FastVitCfg(
            layers=(1, 1, 1, 1), embed_dims=(8, 16, 32, 64), image_size=64))
        return {"embed_dim": 24, "custom_text": True, "text_cfg": text,
                "vision_cfg": {"image_size": 64, "timm_model_name": "fastvit_tiny_test",
                               **timm, "timm_pool": "avg", "timm_proj": None}}
    if family == "mci":
        from refining_clip_via_dinov2_representations_torch.models import fastvit

        monkeypatch.setitem(fastvit.MCI_DIMS, "vit_base_mci_224",
                            fastvit.MciCfg(width=32, layers=2, heads=2, image_size=32))
        return {"embed_dim": 24, "custom_text": True, "text_cfg": text,
                "vision_cfg": {"image_size": 32, "timm_model_name": "vit_base_mci_224",
                               **timm, "timm_pool": "token", "timm_proj": None}}
    if family == "eva02":
        monkeypatch.setitem(eva02.EVA02_DIMS, "eva02_tiny_test", eva02.Eva02Cfg(
            width=32, layers=2, heads=4, mlp_hidden=40, patch_size=8, image_size=24,
            ref_feat_shape=(2, 2)))
        return {"embed_dim": 24, "custom_text": True, "text_cfg": text,
                "vision_cfg": {"image_size": 24, "timm_model_name": "eva02_tiny_test",
                               **timm, "timm_pool": "token", "timm_proj": None}}
    name = {"relpos": "vit_relpos_medium_patch16_cls_224",
            "gap": "vit_medium_patch16_gap_256"}[family]
    return {"embed_dim": 32, "text_cfg": text,
            "vision_cfg": {"image_size": 256 if family == "gap" else 224,
                           "timm_model_name": name, **timm}}


@pytest.mark.parametrize("family", ["vit", "coca", "resnet", "convnext", "siglip", "eva02",
                                    "relpos", "gap", "fastvit", "mci"])
def test_a_build_skips_only_the_default_init_that_the_seeded_init_overwrites(family,
                                                                             monkeypatch):
    """``build_model`` constructs without torch's default random init: the
    seeded init writes every tensor, so the model equals one built with it."""
    import contextlib

    from refining_clip_via_dinov2_representations_torch.models import clip

    cfg = parse_model_cfg(_family_cfg(family, monkeypatch))
    fast = build_model(cfg, seed=3).state_dict()
    monkeypatch.setattr(clip, "_SkipDefaultInit", contextlib.nullcontext)
    want = build_model(cfg, seed=3).state_dict()
    assert fast.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(fast[k], v), k
