"""The port's ViTamin towers (``models/vitamin.py``) against the JAX package's
``models/vitamin.py`` on the CPU, at a tiny size (stem 8, conv dims (8, 16),
one MBConv block a stage, a 32-wide ViT stage of 2 blocks and 2 heads, 64
px; a tiny ``VITAMIN_DIMS`` entry in both packages), on one set of
numpy-drawn weights (``torch_port_utils.jax_drawn_clip``, drawn once):

* the CLIP at 1e-5 on the L2-normalised features (NHWC and NCHW), and the
  tower with its tokens;
* the fp32 CLIP loss at 1e-5 relative and every gradient at cosine >=
  0.9999 against ``jax.value_and_grad`` of the JAX loss, with and without
  per-block checkpointing;
* both converters: the JAX exporter's open_clip file (timm's names under
  ``visual.trunk.``, the text under ``text.``) loads ``strict=True``, and
  the port's importer gives the JAX importer's tree, a nested
  ``shortcut.expand.weight``, ``fc1_g``/``fc1_x``/``fc2`` and a trunk
  ``norm`` key (warned and dropped) included, an unknown key a
  ``KeyError`` in both;
* int8: the leaves the port quantizes are the JAX ``quantize_variables_int8``
  leaves, bit for bit, and the int8 engine stores those;
* the JAX file as the hub cache of a ``datacomp1b`` tag, served by
  ``create_engine`` equal to the JAX engine;
* the fifteen ``ViTamin-*`` names build (config only, on the ``meta``
  device; ``ViTamin-L`` key for key and in parameter count against
  ``jax.eval_shape``; ``ViTamin-XL-384`` at its config's 256 px), and the
  model-axis placement against the JAX ``_param_spec``.

Value-level agreement with timm is verified in neither package (the
module docstring).
"""

import logging

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import vitamin as tvitamin
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

from .torch_port_utils import (  # noqa: F401
    images, jax_drawn_clip, offline, one_thread, token_ids,
)

TINY_NAME = "vitamin_tiny_test"
TINY = dict(stem_width=8, conv_dims=(8, 16), conv_depths=(1, 1), embed_dim=32, depth=2,
            heads=2, image_size=64)
SIZE, CTX = 64, 12
CFG = {"embed_dim": 24, "custom_text": True,
       "vision_cfg": {"image_size": SIZE, "timm_model_name": TINY_NAME,
                      "timm_model_pretrained": False, "timm_pool": "", "timm_proj": "linear",
                      "timm_drop": 0.0, "timm_drop_path": 0.1},
       "text_cfg": {"context_length": CTX, "vocab_size": 49408, "width": 32, "heads": 4,
                    "layers": 2}}
MODEL = "tiny-torch-vitamin"
register_model_config(MODEL, CFG)
NAMES = ("ViTamin-B", "ViTamin-B-LTT", "ViTamin-L", "ViTamin-L-256", "ViTamin-L-336",
         "ViTamin-L-384", "ViTamin-L2", "ViTamin-L2-256", "ViTamin-L2-336", "ViTamin-L2-384",
         "ViTamin-S", "ViTamin-S-LTT", "ViTamin-XL-256", "ViTamin-XL-336", "ViTamin-XL-384")


@pytest.fixture(autouse=True)
def tiny_dims(monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.models import vitamin as jvitamin

    monkeypatch.setitem(jvitamin.VITAMIN_DIMS, TINY_NAME, jvitamin.ViTaminCfg(**TINY))
    monkeypatch.setitem(tvitamin.VITAMIN_DIMS, TINY_NAME, tvitamin.ViTaminCfg(**TINY))


_DRAWN = {}


def _jax():
    """(flax CLIP, variables), drawn once for the module."""
    if not _DRAWN:
        _DRAWN["v"] = jax_drawn_clip(CFG, seed=6)
    return _DRAWN["v"]


def _port(variables, **kw):
    model = build_model(parse_model_cfg(CFG), **kw)
    model.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return model


def _cosine(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def test_tower_and_clip_equal_jax():
    import jax

    from refining_clip_via_dinov2_representations_tpu.models.vitamin import (
        ViTaminCfg, ViTaminVisionTower,
    )

    jmodel, variables = _jax()
    x, ids = images(3, SIZE, seed=7), token_ids(3, CTX, seed=8)
    want = jax.jit(jmodel.apply)(variables, x, ids)
    model = _port(variables).eval()
    assert isinstance(model.visual, tvitamin.ViTaminVisionTower)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
        nchw = model.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2), normalize=True)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    torch.testing.assert_close(nchw, got["image_features"], rtol=0, atol=0)

    jtower = ViTaminVisionTower(cfg=ViTaminCfg(**TINY), output_dim=24, output_tokens=True)
    wp, wt = jax.jit(jtower.apply)({"params": variables["params"]["visual"]}, x)
    tower = tvitamin.ViTaminVisionTower(tvitamin.ViTaminCfg(**TINY), 24, output_tokens=True)
    tower.load_state_dict({k[len("visual."):]: v for k, v in
                           jax_params_to_state_dict(variables).items()
                           if k.startswith("visual.")}, strict=True)
    with torch.no_grad():
        gp, gt = tower(torch.from_numpy(x))
    assert gt.shape == (3, 16, 32)  # 64 / 16 = a 4 x 4 grid, no class token
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grad_checkpointing", [False, True])
def test_loss_and_gradients_equal_jax(grad_checkpointing):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_loss_fn,
    )

    jmodel, variables = _jax()
    batch = {"images": images(4, SIZE, seed=9), "texts": token_ids(4, CTX, seed=10)}
    loss_fn = jax_loss_fn(jmodel, JaxStepCfg(loss_type="clip"))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"model": p}, batch, 0, jax.random.PRNGKey(0)), has_aux=True))(
        variables["params"])
    want = jax_params_to_state_dict(jax.device_get(jgrads))
    model = _port(variables, grad_checkpointing=grad_checkpointing)
    calls = []
    if grad_checkpointing:  # each ViT block runs again in the backward
        for blk in model.visual.trunk.blocks:
            blk.register_forward_pre_hook(lambda *a: calls.append(1))
    loss, _ = make_loss_fn(model.train(), StepCfg(loss_type="clip"))(
        {"images": torch.from_numpy(batch["images"]),
         "texts": torch.from_numpy(batch["texts"]).long()}, 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == want.keys()
    # the text attention's key bias: zero but for rounding in both
    low = min((_cosine(g, want[n].reshape(g.shape)), n) for n, g in grads.items()
              if not n.endswith("attn.in_proj_bias"))
    assert low[0] >= 0.9999, low
    assert len(calls) == (4 if grad_checkpointing else 0)


def _timm_dict(variables):
    """The JAX exporter's open_clip file, as torch tensors."""
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    return {k: torch.as_tensor(np.asarray(v)) for k, v in
            flax_params_to_torch_state_dict(variables["params"]).items()}


def _jax_import(sd, variables):
    """The JAX importer's tree for ``sd``'s trunk, in the port's names."""
    from refining_clip_via_dinov2_representations_tpu.models.vitamin import (
        convert_timm_vitamin_state_dict,
    )

    params = dict(variables["params"])
    params["visual"] = convert_timm_vitamin_state_dict(sd)
    return {k: v for k, v in jax_params_to_state_dict(params).items() if k.startswith("visual.")}


def test_both_converters_round_trip():
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights

    _, variables = _jax()
    exported = _timm_dict(variables)
    assert "visual.trunk.patch_embed.backbone.stages.0.blocks.0.shortcut.weight" in exported
    assert "text.token_embedding.weight" in exported and "visual.trunk.head.weight" in exported
    model = build_model(parse_model_cfg(CFG))
    load_weights(model, exported, strict=True)
    want = jax_params_to_state_dict(variables)
    assert all(torch.equal(v, want[k].reshape(v.shape)) for k, v in model.state_dict().items())
    ours = tvitamin.convert_timm_vitamin_state_dict(exported)
    theirs = _jax_import(exported, variables)
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert torch.equal(v, theirs[k]), k


def test_nested_shortcut_aliases_and_trunk_norm_import_as_jax_imports_them(caplog):
    _, variables = _jax()
    sd = _timm_dict(variables)
    blk = "visual.trunk.patch_embed.backbone.stages.1.blocks.0."
    sd[blk + "shortcut.expand.weight"] = sd.pop(blk + "shortcut.weight")
    sd[blk + "shortcut.expand.bias"] = sd.pop(blk + "shortcut.bias")
    for old, new in (("w0", "fc1_g"), ("w1", "fc1_x"), ("w2", "fc2")):
        for leaf in ("weight", "bias"):
            sd[f"visual.trunk.blocks.1.mlp.{new}.{leaf}"] = sd.pop(
                f"visual.trunk.blocks.1.mlp.{old}.{leaf}")
    sd["visual.trunk.norm.weight"] = torch.ones(32)
    # the stem and pool without ``backbone.`` (the JAX importer takes both)
    for leaf in ("weight", "bias"):
        sd[f"visual.trunk.patch_embed.stem.conv2.{leaf}"] = sd.pop(
            f"visual.trunk.patch_embed.backbone.stem.conv2.{leaf}")
    with caplog.at_level(logging.WARNING):
        ours = tvitamin.convert_timm_vitamin_state_dict(sd)
    assert any("ignoring trunk norm key visual.trunk.norm.weight" in r.getMessage()
               for r in caplog.records)
    theirs = _jax_import(sd, variables)
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(v, theirs[k]) for k, v in ours.items())
    assert torch.equal(ours[blk + "shortcut.weight"], sd[blk + "shortcut.expand.weight"])
    model = build_model(parse_model_cfg(CFG))
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights

    load_weights(model, sd, strict=True)  # the nested file loads through the importer

    from refining_clip_via_dinov2_representations_tpu.models.vitamin import (
        convert_timm_vitamin_state_dict as jax_import,
    )

    for bad in ("visual.trunk.blocks.0.attn.q_proj.weight", "visual.trunk.cls_token",
                "visual.trunk.patch_embed.backbone.stem.bn.weight"):
        with pytest.raises(KeyError):
            tvitamin.convert_timm_vitamin_state_dict({bad: torch.zeros(2)})
        with pytest.raises(KeyError):
            jax_import({bad: np.zeros(2, np.float32)})


def test_int8_quantizes_the_jax_leaves():
    import jax

    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, Int8Weight, dequantize, quantize_state_dict_int8,
    )
    from refining_clip_via_dinov2_representations_tpu.inference import (
        dequantize_variables, quantize_variables_int8,
    )

    _, variables = _jax()
    min_size = 256
    jq = quantize_variables_int8({"params": variables["params"]}, min_size)["params"]
    want = jax_params_to_state_dict(jax.device_get(dequantize_variables(jq, np.float32)))
    is_q = lambda x: isinstance(x, dict) and set(x) == {"_q", "_s"}  # noqa: E731
    marks = jax.tree.map(lambda x: np.ones(x["_q"].shape, np.float32) if is_q(x)
                         else np.zeros(np.shape(x), np.float32), jq, is_leaf=is_q)
    jax_int8 = {k for k, v in jax_params_to_state_dict(marks).items()
                if v.numel() and bool((v == 1).all())}
    ours = quantize_state_dict_int8(jax_params_to_state_dict(variables), min_size)
    assert {k for k, v in ours.items() if isinstance(v, Int8Weight)} == jax_int8
    # the depthwise kernels are quantized per output channel; the position
    # table is the JAX leaf ``positional_embedding``, which JAX skips
    dw = "visual.trunk.patch_embed.backbone.stages.1.blocks.0.conv2_kxk.weight"
    assert dw in jax_int8 and ours[dw].scale.shape == (64, 1, 1, 1)
    assert "visual.trunk.pos_embed" not in jax_int8
    got = dequantize(ours)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    model = _port(variables)
    ClipInferenceEngine(model, (SIZE, SIZE), CTX, buckets=(2,), quantize="int8",
                        quantize_min_size=min_size)
    stored = {n.replace("parametrizations.", "").replace(".original", ""): p
              for n, p in model.named_parameters()}
    assert {n for n, p in stored.items() if p.dtype == torch.int8} == jax_int8


def test_jax_export_loads_by_tag_and_serves_equal_to_the_jax_engine(tmp_path, monkeypatch,
                                                                     offline):
    import os

    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import pretrained
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )

    jmodel, variables = _jax()
    tag = "datacomp1b"
    cfg = pretrained.get_pretrained_cfg("ViTamin-L", tag)
    assert cfg["hf_hub"] == "jienengchen/ViTamin-L-224px/pytorch_model.bin"
    monkeypatch.setitem(pretrained._PRETRAINED, MODEL, {tag: cfg})
    repo = tmp_path / "models--jienengchen--ViTamin-L-224px"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("seeded")
    os.makedirs(repo / "snapshots" / "seeded")
    exported = _timm_dict(variables)
    torch.save(exported, repo / "snapshots" / "seeded" / "pytorch_model.bin")
    engine, _, _ = create_engine(MODEL, pretrained=tag, cache_dir=str(tmp_path), device="cpu",
                                 dtype=torch.float32, buckets=(4,), warm=False)
    own = engine.model.state_dict()
    assert all(torch.equal(own[k], v.reshape(own[k].shape))
               for k, v in jax_params_to_state_dict(variables).items())
    jengine = JaxEngine(jmodel, variables, (SIZE, SIZE), CTX, buckets=(4,), dtype=jnp.float32)
    x, ids = images(3, SIZE, seed=11), token_ids(3, CTX, seed=12)
    np.testing.assert_allclose(engine.encode_image(x), jengine.encode_image(x), atol=1e-5)
    np.testing.assert_allclose(engine.encode_text(ids), jengine.encode_text(ids), atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_the_fifteen_names_build(name, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import (
        convert, get_model_config, list_models,
    )
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)), init=False)
    visual, vcfg = model.visual, JAX_CONFIGS[name]["vision_cfg"]
    assert isinstance(visual, tvitamin.ViTaminVisionTower) and model.custom_text
    trunk = tvitamin.VITAMIN_DIMS[vcfg["timm_model_name"]]
    assert visual.image_size == (vcfg["image_size"],) * 2  # the config's size wins
    assert visual.cfg == tvitamin.ViTaminCfg(**{**trunk.__dict__,
                                                "image_size": vcfg["image_size"]})
    assert visual.trunk.pos_embed.shape == (1, (vcfg["image_size"] // 16) ** 2, trunk.embed_dim)
    assert visual.trunk.head.bias is None  # no timm_proj_bias
    if name == "ViTamin-XL-384":
        assert visual.image_size == (256, 256) and trunk.image_size == 384
    if name == "ViTamin-L":  # key for key against JAX's shapes
        import jax
        import jax.numpy as jnp

        from refining_clip_via_dinov2_representations_tpu.models import (
            build_model as jax_build, parse_model_cfg as jax_parse,
        )

        cfg = jax_parse(JAX_CONFIGS[name])
        shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 224, 224, 3)),
                                jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))["params"]
        leaves = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
        monkeypatch.setattr(convert, "_t", lambda x, transpose=False: torch.empty(
            np.shape(x)[::-1] if transpose and np.ndim(x) == 2 else np.shape(x), device="meta"))
        want = {k: tuple(v.shape) for k, v in convert.jax_params_to_state_dict(leaves).items()}
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want
        n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert sum(p.numel() for p in model.parameters()) == n


def test_splits_agree_with_jax_param_spec():
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import param_split

    from .test_torch_tp_spec import _check, _markers

    _, variables = _jax()
    split = _check(jax_params_to_state_dict(_markers(variables["params"])))
    blk = "visual.trunk.blocks.1."
    assert {blk + "attn.qkv.weight", blk + "attn.proj.weight", blk + "mlp.w0.weight",
            blk + "mlp.w1.weight", blk + "mlp.w2.weight"} <= split
    assert not {n for n in split if n.startswith("visual.trunk.patch_embed.")}
    assert param_split(blk + "mlp.norm.weight") is None
    assert param_split(blk + "attn.qkv.weight").packs == 3
