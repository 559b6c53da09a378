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
    {"vision_cfg": {"layers": [3, 4, 6, 3], "width": 64}},
    {"text_cfg": {"hf_model_name": "bert-base-uncased"}},
    {"text_cfg": {"embed_cls": True}},
    {"multimodal_cfg": {"width": 32}},
    {"vision_cfg": {"pool_type": "avg", "no_ln_pre": True}},  # CLIPA towers
    {"text_cfg": {"no_causal_mask": True, "pool_type": "last"}},
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
