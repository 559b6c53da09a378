"""The port's ConvNeXt tower (``models/convnext.py``) against the JAX package's
``models/convnext.py`` on the CPU, at a tiny size (one block a stage, dims
8-64, 64 px; a tiny ``CONVNEXT_DIMS`` entry in both packages), on one set of
numpy-drawn weights (``torch_port_utils.jax_drawn_clip``):

* the tower and the CLIP at 1e-5 on the L2-normalised features, for the
  ``"linear"`` and the ``"mlp"`` head, NHWC and NCHW alike, the token
  outputs too;
* the fp32 CLIP loss at 1e-5 relative and every gradient at cosine >=
  0.9999 against ``jax.value_and_grad`` of the JAX loss, with and without
  per-block checkpointing (``grad_checkpointing``);
* the ``"mlp"`` head through open_clip's ``visual.head.mlp.fc1``/``fc2``
  keys: the port's converter writes both layers and a checkpoint without
  them fails the strict load, where the JAX exporter drops ``head_mlp_fc1``
  (ROADMAP "Found in the JAX package");
* the JAX exporter's open_clip file (``"linear"``, the text under
  ``text.``) as the hub snapshot of ``convnext_base_w``'s tag, loaded by tag
  and served by ``create_engine`` equal to the JAX engine;
* the eleven ``convnext_*`` names build at full width on the meta device
  (``convnext_base_w`` and ``convnext_large_d`` key for key against the
  JAX tree's shapes); the tower stays whole under a model axis.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import convnext as tconvnext
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

from .torch_port_utils import (  # noqa: F401
    images, jax_drawn_clip, offline, one_thread, token_ids,
)

TINY_NAME = "convnext_tiny_test"
TINY_DIMS = ((1, 1, 1, 1), (8, 16, 32, 64))
SIZE, CTX = 64, 12


def _cfg(proj: str) -> dict:
    return {"embed_dim": 24,
            "vision_cfg": {"image_size": SIZE, "timm_model_name": TINY_NAME,
                           "timm_model_pretrained": False, "timm_pool": "", "timm_proj": proj,
                           "timm_drop": 0.0, "timm_drop_path": 0.1},
            "text_cfg": {"context_length": CTX, "vocab_size": 49408, "width": 32, "heads": 4,
                         "layers": 2}}


MODEL = "tiny-torch-convnext"
register_model_config(MODEL, _cfg("linear"))
CN_NAMES = ("convnext_base", "convnext_base_w", "convnext_base_w_320", "convnext_large",
            "convnext_large_d", "convnext_large_d_320", "convnext_small", "convnext_tiny",
            "convnext_xlarge", "convnext_xxlarge", "convnext_xxlarge_320")


@pytest.fixture(autouse=True)
def tiny_dims(monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.models import convnext as jconvnext

    monkeypatch.setitem(jconvnext.CONVNEXT_DIMS, TINY_NAME, TINY_DIMS)
    monkeypatch.setitem(tconvnext.CONVNEXT_DIMS, TINY_NAME, TINY_DIMS)


_DRAWN = {}


def _jax(proj: str):
    """(flax CLIP, variables) of ``_cfg(proj)``, drawn once a head type."""
    if proj not in _DRAWN:
        _DRAWN[proj] = jax_drawn_clip(_cfg(proj), seed=4 if proj == "mlp" else 5)
    return _DRAWN[proj]


def _port(proj: str, variables, **kw):
    model = build_model(parse_model_cfg(_cfg(proj)), **kw)
    model.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return model


def _cosine(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_tower_and_clip_equal_jax(proj):
    import jax

    from refining_clip_via_dinov2_representations_tpu.models.convnext import (
        ConvNextCfg, ConvNextTower,
    )

    jmodel, variables = _jax(proj)
    x, ids = images(3, SIZE, seed=6), token_ids(3, CTX, seed=7)
    want = jax.jit(jmodel.apply)(variables, x, ids)
    model = _port(proj, variables)
    assert isinstance(model.visual, tconvnext.ConvNextTower)
    assert ("visual.head.mlp.fc1.weight" in model.state_dict()) == (proj == "mlp")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
        nchw = model.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2), normalize=True)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    torch.testing.assert_close(nchw, got["image_features"], rtol=0, atol=0)

    # the tower alone, with its token outputs
    jtower = ConvNextTower(cfg=ConvNextCfg(*TINY_DIMS), output_dim=24, proj_type=proj,
                           output_tokens=True)
    wp, wt = jax.jit(jtower.apply)({"params": variables["params"]["visual"]}, x)
    tower = tconvnext.ConvNextTower(tconvnext.ConvNextCfg(*TINY_DIMS), 24, proj_type=proj,
                                    output_tokens=True)
    tower.load_state_dict({k[len("visual."):]: v for k, v in
                           jax_params_to_state_dict(variables).items()
                           if k.startswith("visual.")}, strict=True)
    with torch.no_grad():
        gp, gt = tower(torch.from_numpy(x))
    assert gt.shape == (3, 4, 64)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grad_checkpointing", [False, True])
def test_loss_and_gradients_equal_jax(grad_checkpointing):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_loss_fn,
    )

    jmodel, variables = _jax("mlp")
    batch = {"images": images(4, SIZE, seed=8), "texts": token_ids(4, CTX, seed=9)}
    loss_fn = jax_loss_fn(jmodel, JaxStepCfg(loss_type="clip"))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"model": p}, batch, 0, jax.random.PRNGKey(0)), has_aux=True))(
        variables["params"])
    want = jax_params_to_state_dict(jax.device_get(jgrads))
    model = _port("mlp", variables, grad_checkpointing=grad_checkpointing)
    assert model.visual.grad_checkpointing == grad_checkpointing
    calls = []
    if grad_checkpointing:  # each block runs again in the backward
        for blk in model.visual.modules():
            if isinstance(blk, tconvnext.ConvNextBlock):
                blk.register_forward_pre_hook(lambda *a: calls.append(1))
    loss, _ = make_loss_fn(model.train(), StepCfg(loss_type="clip"))(
        {"images": torch.from_numpy(batch["images"]),
         "texts": torch.from_numpy(batch["texts"]).long()}, 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == want.keys()
    # the text attention's key bias: zero but for rounding (a constant per
    # softmax row), in both
    low = min((_cosine(g, want[n].reshape(g.shape)), n) for n, g in grads.items()
              if not n.endswith("attn.in_proj_bias"))
    assert low[0] >= 0.9999, low
    assert len(calls) == (8 if grad_checkpointing else 0)


def test_mlp_head_round_trips_through_open_clip_keys_where_the_jax_exporter_drops_it():
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        convert_clip_state_dict, flax_params_to_torch_state_dict,
    )

    _, variables = _jax("mlp")
    visual = variables["params"]["visual"]
    assert {"head_mlp_fc1", "head_norm", "head_proj"} <= set(visual)
    # the JAX exporter: no fc1, the second layer as head.proj
    jax_sd = flax_params_to_torch_state_dict(variables["params"])
    assert not any(k.startswith("visual.head.mlp") for k in jax_sd)
    assert "visual.head.proj.weight" in jax_sd
    # the port's converter: open_clip's two layers
    sd = jax_params_to_state_dict(variables)
    np.testing.assert_array_equal(sd["visual.head.mlp.fc1.weight"].numpy(),
                                  np.asarray(visual["head_mlp_fc1"]["kernel"]).T)
    np.testing.assert_array_equal(sd["visual.head.mlp.fc1.bias"].numpy(),
                                  np.asarray(visual["head_mlp_fc1"]["bias"]))
    np.testing.assert_array_equal(sd["visual.head.mlp.fc2.weight"].numpy(),
                                  np.asarray(visual["head_proj"]["kernel"]).T)
    assert "visual.head.mlp.fc2.bias" not in sd  # timm_proj_bias false
    model = build_model(parse_model_cfg(_cfg("mlp")))
    model.load_state_dict(sd, strict=True)
    # the JAX importer reads open_clip's mlp keys into head_norm alone
    back = convert_clip_state_dict({k: v.numpy() for k, v in sd.items()})["visual"]
    assert "head_mlp_fc1" not in back and "head_proj" not in back and "head_norm" in back
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights

    with pytest.raises(ValueError, match="missing"):
        load_weights(build_model(parse_model_cfg(_cfg("mlp"))),
                     {k: v for k, v in sd.items() if not k.startswith("visual.head.mlp")})


def test_jax_export_loads_by_tag_and_serves_equal_to_the_jax_engine(tmp_path, monkeypatch,
                                                                     offline):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import pretrained
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    from .torch_port_utils import seed_hub_snapshot

    jmodel, variables = _jax("linear")
    exported = {k: torch.as_tensor(np.asarray(v)) for k, v in
                flax_params_to_torch_state_dict(variables["params"]).items()}
    assert "text.token_embedding.weight" in exported  # the JAX trunk exporters' layout
    tag = "laion2b_s13b_b82k"
    cfg = pretrained.get_pretrained_cfg("convnext_base_w", tag)
    monkeypatch.setitem(pretrained._PRETRAINED, MODEL, {tag: cfg})
    seed_hub_snapshot(str(tmp_path), repo=cfg["hf_hub"].rstrip("/"), state_dict=exported)
    engine, _, _ = create_engine(MODEL, pretrained=tag, cache_dir=str(tmp_path), device="cpu",
                                 dtype=torch.float32, buckets=(4,), warm=False)
    own = engine.model.state_dict()
    assert torch.equal(own["token_embedding.weight"], exported["text.token_embedding.weight"])
    jengine = JaxEngine(jmodel, variables, (SIZE, SIZE), CTX, buckets=(4,), dtype=jnp.float32)
    x, ids = images(3, SIZE, seed=10), token_ids(3, CTX, seed=11)
    np.testing.assert_allclose(engine.encode_image(x), jengine.encode_image(x), atol=1e-5)
    np.testing.assert_allclose(engine.encode_text(ids), jengine.encode_text(ids), atol=1e-5)


@pytest.mark.parametrize("name", CN_NAMES)
def test_the_eleven_names_build_at_full_width(name, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import (
        convert, get_model_config, list_models,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import param_split
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)))
    visual = model.visual
    vcfg = JAX_CONFIGS[name]["vision_cfg"]
    assert isinstance(visual, tconvnext.ConvNextTower)
    assert visual.cfg.dims == tconvnext.CONVNEXT_DIMS[vcfg["timm_model_name"]][1]
    assert hasattr(visual.head, "mlp") == (vcfg["timm_proj"] == "mlp")
    assert visual.image_size == (vcfg["image_size"],) * 2
    # the conv tower stays whole under a model axis; the text tower splits
    assert not any(param_split(n) for n, _ in visual.named_parameters(prefix="visual"))
    assert param_split("transformer.resblocks.0.mlp.c_fc.weight") is not None
    if name in ("convnext_base_w", "convnext_large_d"):  # key for key against JAX's shapes
        import jax
        import jax.numpy as jnp

        from refining_clip_via_dinov2_representations_tpu.models import (
            build_model as jax_build, parse_model_cfg as jax_parse,
        )

        cfg = jax_parse(JAX_CONFIGS[name])
        shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))["params"]
        leaves = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
        monkeypatch.setattr(convert, "_t", lambda x, transpose=False: torch.empty(
            np.shape(x)[::-1] if transpose and np.ndim(x) == 2 else np.shape(x), device="meta"))
        want = {k: tuple(v.shape) for k, v in convert.jax_params_to_state_dict(leaves).items()}
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want
