"""The port's EVA02 towers (``models/eva02.py``) against the JAX package's
``models/eva02.py`` on the CPU:

* the rope tables, exactly (224 and 336 px, head dims 64 and 112);
* the tower at a tiny width, pre-norm with SwiGLU, sub-LN and rope, and
  E's post-norm GELU form, with and without token outputs, against the JAX
  ``Eva02VisionTower`` at 1e-5 in fp32 through the weight bridge;
* a tiny EVA02 CLIP: features against the JAX model through the bridge,
  its open_clip checkpoint (the JAX exporter's timm layout) round trip, and
  the weights loaded by tag from a seeded hub cache and served by
  ``create_engine`` against the JAX engine;
* the five ``EVA02-*`` names at full width on the ``meta`` device, key for
  key and in parameter count against ``jax.eval_shape`` of the JAX trees;
* the model-axis placement against the JAX ``_param_spec``, and the tower
  split over two gloo ranks (``test_torch_tp_towers.py:split_forward``)
  giving the whole tower's forward, for both kinds of block.
"""

import dataclasses

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import eva02 as teva02
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.ops import fused_attention as fused_ops

from .torch_port_utils import images, jax_clip, offline, port_clip, token_ids  # noqa: F401

TINY_NAME = "eva02_tiny_test"
TINY_FORMS = {
    # EVA02-B/L's block (SwiGLU, sub-LN, rope at ref 2 x 2) and E's
    "swiglu": dict(width=32, layers=2, heads=4, mlp_hidden=40, patch_size=8, image_size=24,
                   ref_feat_shape=(2, 2)),
    "post_norm": dict(width=32, layers=2, heads=4, mlp_hidden=48, patch_size=8, image_size=24,
                      swiglu=False, rope=False, subln=False, post_norm=True, ref_feat_shape=None),
}
CFG = {"embed_dim": 24, "custom_text": True,
       "vision_cfg": {"image_size": 24, "timm_model_name": TINY_NAME,
                      "timm_model_pretrained": False, "timm_pool": "token", "timm_proj": None},
       "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                    "layers": 2}}
MODEL = "tiny-torch-eva02"
register_model_config(MODEL, CFG)
NAMES = ("EVA02-B-16", "EVA02-E-14", "EVA02-E-14-plus", "EVA02-L-14", "EVA02-L-14-336")


@pytest.fixture(params=list(TINY_FORMS))
def tiny(request, monkeypatch):
    """A tiny EVA02 trunk name in both packages' ``EVA02_DIMS``."""
    from refining_clip_via_dinov2_representations_tpu.models import eva02 as jeva02

    dims = TINY_FORMS[request.param]
    monkeypatch.setitem(jeva02.EVA02_DIMS, TINY_NAME, jeva02.Eva02Cfg(**dims))
    monkeypatch.setitem(teva02.EVA02_DIMS, TINY_NAME, teva02.Eva02Cfg(**dims))
    return request.param


@pytest.mark.parametrize("grid,head_dim,ref", [((16, 16), 64, (16, 16)),
                                               ((24, 24), 64, (16, 16)),
                                               ((14, 14), 64, (16, 16)),
                                               ((16, 16), 112, (16, 16)), ((3, 5), 8, None)])
def test_rope_tables_equal_jax(grid, head_dim, ref):
    from refining_clip_via_dinov2_representations_tpu.models.eva02 import build_rope_embed

    for got, want in zip(teva02.build_rope_embed(grid, head_dim, ref),
                         build_rope_embed(grid, head_dim, ref)):
        assert got.dtype == np.float32 and got.shape == (grid[0] * grid[1], head_dim)
        np.testing.assert_array_equal(got, want)


def test_rope_rotates_patches_in_fp32_and_leaves_the_class_token():
    from refining_clip_via_dinov2_representations_tpu.models.eva02 import apply_rope

    sin, cos = teva02.build_rope_embed((2, 3), 8, (2, 2))
    x = np.random.default_rng(0).normal(size=(2, 3, 7, 8)).astype(np.float32)
    got = teva02.apply_rope(torch.from_numpy(x), torch.from_numpy(sin), torch.from_numpy(cos))
    assert got.is_contiguous() and torch.equal(got[:, :, 0], torch.from_numpy(x[:, :, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(apply_rope(x, sin, cos)), atol=1e-6)
    bf = teva02.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(sin),
                           torch.from_numpy(cos))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("output_tokens", [False, True])
def test_tower_equals_the_jax_tower(tiny, output_tokens):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.eva02 import (
        EVA02_DIMS as JAX_DIMS, Eva02VisionTower as JaxTower,
    )

    jtower = JaxTower(cfg=JAX_DIMS[TINY_NAME], output_dim=24, output_tokens=output_tokens)
    x = images(3, 24, seed=4)
    variables = jtower.init(jax.random.PRNGKey(1), jnp.zeros((1, 24, 24, 3)))
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(0, 0.05, np.shape(p)).astype(
        np.float32), jax.device_get(variables["params"]))
    want = jtower.apply({"params": params}, jnp.asarray(x))
    # the bridge takes a CLIP tree: the tower under "visual" beside a text tower
    _, clip_vars = jax_clip(CFG, attn_impl="xla")
    sd = jax_params_to_state_dict({**clip_vars["params"], "visual": params})
    tower = teva02.Eva02VisionTower(teva02.EVA02_DIMS[TINY_NAME], 24,
                                    output_tokens=output_tokens, attn_impl="fused")
    tower.load_state_dict({k[len("visual."):]: v for k, v in sd.items()
                           if k.startswith("visual.")}, strict=True)
    with torch.no_grad():
        got = tower.eval()(torch.from_numpy(x))
    for g, w in zip(got if output_tokens else (got,), want if output_tokens else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    # NCHW at the boundary gives the same
    with torch.no_grad():
        again = tower(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_clip_equals_jax_and_every_fused_call_is_contiguous(tiny, monkeypatch):
    calls = []
    plain = fused_ops.fused_attention_reference

    def counted(q, k, v, *args, **kwargs):
        calls.append(all(t.is_contiguous() for t in (q, k, v)))
        return plain(q, k, v, *args, **kwargs)

    monkeypatch.setattr(fused_ops, "fused_attention_reference", counted)
    jmodel, variables = jax_clip(CFG, attn_impl="xla")
    x, ids = images(3, 24, seed=5), token_ids(3, 12, seed=6)
    want = jmodel.apply(variables, x, ids)
    model = port_clip(CFG, variables["params"], attn_impl="fused")
    assert model.custom_text
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert len(calls) == 4 and all(calls)  # 2 vision + 2 text blocks, through the kernel path
    assert not any("rope" in k for k in model.state_dict())


def test_open_clip_checkpoint_round_trip_and_tag_serve_equal_the_jax_engine(
        tiny, tmp_path, monkeypatch, offline):
    """The JAX exporter's open_clip state dict (timm trunk under
    ``visual.trunk.``, text under ``text.``) written as the hub snapshot of
    ``EVA02-L-14``'s tag loads by that tag; ``create_engine`` serves it in
    fp32 equal to the JAX engine on the JAX weights."""
    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import create_model, pretrained
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    from .torch_port_utils import seed_hub_snapshot

    jmodel, variables = jax_clip(CFG, attn_impl="xla", seed=3)
    for name, blk in variables["params"]["visual"].items():
        if name.startswith("resblocks_"):  # timm's layout has no key bias
            bias = np.array(blk["attn"]["in_proj_bias"])
            bias[32:64] = 0.0
            blk["attn"]["in_proj_bias"] = bias
    exported = {k: torch.as_tensor(np.asarray(v)) for k, v in
                flax_params_to_torch_state_dict(variables["params"]).items()}
    assert any(k.startswith("visual.trunk.blocks.0.attn.q_proj") for k in exported)
    assert not any(k.startswith("visual.trunk.blocks.0.attn.k_proj.bias") for k in exported)
    # the port's converters: timm -> port -> timm is the identity
    port_sd = teva02.convert_eva02_clip_state_dict(exported)
    back = teva02.eva02_params_to_timm_state_dict(port_sd)
    trunk = {k: v for k, v in exported.items() if k.startswith(teva02.TRUNK)}
    assert back.keys() == trunk.keys()
    assert all(torch.equal(back[k], v) for k, v in trunk.items())

    tag = "merged2b_s4b_b131k"
    cfg = pretrained.get_pretrained_cfg("EVA02-L-14", tag)
    monkeypatch.setitem(pretrained._PRETRAINED, MODEL, {tag: cfg})
    seed_hub_snapshot(str(tmp_path), repo=cfg["hf_hub"].rstrip("/"), state_dict=exported)
    model, _ = create_model(MODEL, pretrained=tag, cache_dir=str(tmp_path), device="cpu")
    own = model.state_dict()
    for k, v in port_sd.items():  # the exporter's logit_scale is [1], the port's []
        torch.testing.assert_close(own[k], v.reshape(own[k].shape), rtol=0, atol=0)
    engine, _, _ = create_engine(MODEL, pretrained=tag, cache_dir=str(tmp_path), device="cpu",
                                 dtype=torch.float32, buckets=(2, 4), warm=False)
    jengine = JaxEngine(jmodel, variables, (24, 24), 12, buckets=(2, 4),
                        dtype=__import__("jax.numpy").numpy.float32)
    x, ids = images(3, 24, seed=7), token_ids(3, 12, seed=8)
    np.testing.assert_allclose(engine.encode_image(x), jengine.encode_image(x), atol=1e-5)
    np.testing.assert_allclose(engine.encode_text(ids), jengine.encode_text(ids), atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_the_five_names_build_at_full_width_as_the_jax_tree(name, monkeypatch):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models import (
        convert, get_model_config, list_models,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    cfg = jax_parse(JAX_CONFIGS[name])
    size = cfg.vision_cfg.image_size
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))["params"]
    leaves = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(convert, "_t", lambda x, transpose=False: torch.empty(
        np.shape(x)[::-1] if transpose and np.ndim(x) == 2 else np.shape(x), device="meta"))
    want = {k: tuple(v.shape) for k, v in convert.jax_params_to_state_dict(leaves).items()}
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)))
    assert isinstance(model.visual, teva02.Eva02VisionTower)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n
    vcfg = model.visual.cfg
    assert model.visual.image_size == (size, size) and vcfg.image_size == size
    assert (vcfg.width // vcfg.heads) == (112 if "-E-" in name else 64)


def test_splits_agree_with_jax_param_spec_and_a_model_group_is_refused(tiny):
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import shard_module

    from .test_torch_tp_spec import _check, _markers

    _, variables = jax_clip(CFG, attn_impl="xla")
    split = _check(jax_params_to_state_dict(_markers(variables["params"])))
    blk = "visual.transformer.resblocks.0."
    want = {blk + "attn.in_proj_weight", blk + "attn.out_proj.weight", blk + "mlp.fc2.weight"}
    want |= ({blk + "mlp.fc1_g.weight", blk + "mlp.fc1_x.weight"} if tiny == "swiglu"
             else {blk + "mlp.fc1.weight"})
    assert want <= split
    assert not {blk + "attn.norm.weight", blk + "mlp.norm.weight", "visual.proj.weight",
                "visual.conv1.weight"} & split
    model = build_model(parse_model_cfg(CFG))
    shard_module(model, None)  # no group: whole
    assert model.tp_splits == {}
    # two ranks split the tower and give the whole tower's forward
    if not _SPLIT:
        from .test_torch_tp_towers import split_forward

        _SPLIT.update(split_forward(("eva02-swiglu", "eva02-post-norm")))
    n_split, err = _SPLIT["eva02-swiglu" if tiny == "swiglu" else "eva02-post-norm"]
    assert n_split == 2 * (8 if tiny == "swiglu" else 6) and err <= 1e-6, (n_split, err)


_SPLIT = {}  # both forms' split forwards, from one pair of ranks


def test_image_size_in_the_config_overrides_the_trunks(monkeypatch):
    """``tpu/models/clip.py:114-131``: the config's image size wins (the
    rope grid and position table follow it)."""
    cfg = dict(CFG, vision_cfg=dict(CFG["vision_cfg"], image_size=32,
                                    timm_model_name="eva02_base_patch16_clip_224"))
    monkeypatch.setitem(teva02.EVA02_DIMS, "eva02_base_patch16_clip_224",
                        dataclasses.replace(teva02.EVA02_DIMS["eva02_base_patch16_clip_224"],
                                            width=32, layers=1, heads=4, mlp_hidden=40))
    model = build_model(parse_model_cfg(cfg))
    assert model.visual.image_size == (32, 32) and model.visual.rope_sin.shape == (4, 8)
    assert model.visual.positional_embedding.shape == (5, 32)


def test_a_key_bias_under_rope_is_not_dropped_on_export(monkeypatch):
    """The JAX exporter drops the key bias (``tpu/models/eva02.py:415``),
    which softmax cancels only without rope: under rope its export serves
    other features than the JAX model, without rope the same (ROADMAP
    Queue 3, JAX list). The port's exporter raises on a nonzero key bias."""
    from refining_clip_via_dinov2_representations_tpu.models import eva02 as jeva02
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    for form in TINY_FORMS:
        dims = TINY_FORMS[form]
        monkeypatch.setitem(jeva02.EVA02_DIMS, TINY_NAME, jeva02.Eva02Cfg(**dims))
        monkeypatch.setitem(teva02.EVA02_DIMS, TINY_NAME, teva02.Eva02Cfg(**dims))
        jmodel, variables = jax_clip(CFG, attn_impl="xla", seed=3)  # a nonzero key bias
        x = images(2, 24, seed=9)
        want = np.asarray(jmodel.apply(variables, x, token_ids(2, 12))["image_features"])
        model = build_model(parse_model_cfg(CFG)).eval()
        from refining_clip_via_dinov2_representations_torch.models.factory import load_weights

        load_weights(model, {k: torch.as_tensor(np.asarray(v)) for k, v in
                             flax_params_to_torch_state_dict(variables["params"]).items()})
        with torch.no_grad():
            got = model.encode_image(torch.from_numpy(x), normalize=True).numpy()
        if form == "swiglu":
            assert np.abs(got - want).max() > 1e-3
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        with pytest.raises(ValueError, match="nonzero key bias"):
            teva02.eva02_params_to_timm_state_dict(port_clip(CFG, variables["params"]
                                                             ).state_dict())
