"""The port's Swin tower (``models/swin.py``) against the JAX package's
``models/swin.py`` on the CPU, at a tiny size (embed 16, depths (2, 2),
heads (2, 4), patch 4, window 4, 32 px: the first stage's second block
shifts, the second stage's 4 x 4 grid runs one window unshifted; a tiny
``SWIN_DIMS`` entry in both packages), on one set of numpy-drawn weights
(``torch_port_utils.jax_drawn_clip``, drawn once):

* the CLIP at 1e-5 on the L2-normalised features (NHWC and NCHW), and the
  tower with its tokens;
* the fp32 CLIP loss at 1e-5 relative and every gradient at cosine >=
  0.9999 against ``jax.value_and_grad`` of the JAX loss, every
  ``relative_position_bias_table`` among them, with and without per-block
  checkpointing;
* HF ``SwinModel`` (the JAX package's oracle, ``tests/test_swin.py``) on
  its own layout through the port's HF converter, equal to the JAX HF
  converter's tree; the JAX exporter's timm file loading ``strict=True``
  and the port's timm importer equal to the JAX importer;
* the grid check raising with the JAX tower's message;
* ``swin_base_patch4_window7_224`` built on the ``meta`` device key for key
  and in parameter count against ``jax.eval_shape``, and the model-axis
  placement against the JAX ``_param_spec``.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import swin as tswin
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

from .torch_port_utils import images, jax_drawn_clip, token_ids

TINY_NAME = "swin_tiny_test"
TINY = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4)
SIZE, CTX = 32, 12
CFG = {"embed_dim": 24,
       "vision_cfg": {"image_size": SIZE, "timm_model_name": TINY_NAME,
                      "timm_model_pretrained": False, "timm_pool": "", "timm_proj": "linear"},
       "text_cfg": {"context_length": CTX, "vocab_size": 49408, "width": 32, "heads": 4,
                    "layers": 2}}
MODEL = "tiny-torch-swin"
register_model_config(MODEL, CFG)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny towers' many small ops would otherwise
    spin OpenMP threads against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tiny_dims(monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.models import swin as jswin

    monkeypatch.setitem(jswin.SWIN_DIMS, TINY_NAME, jswin.SwinCfg(**TINY))
    monkeypatch.setitem(tswin.SWIN_DIMS, TINY_NAME, tswin.SwinCfg(**TINY))


_DRAWN = {}


def _jax():
    if not _DRAWN:
        _DRAWN["v"] = jax_drawn_clip(CFG, seed=8)
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

    from refining_clip_via_dinov2_representations_tpu.models.swin import (
        SwinCfg, SwinVisionTower,
    )

    jmodel, variables = _jax()
    x, ids = images(3, SIZE, seed=9), token_ids(3, CTX, seed=10)
    want = jax.jit(jmodel.apply)(variables, x, ids)
    model = _port(variables).eval()
    blocks = [b for stage in model.visual.trunk.layers for b in stage.blocks]
    assert [(b.window, b.shift) for b in blocks] == [(4, 0), (4, 2), (4, 0), (4, 0)]
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
        nchw = model.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2), normalize=True)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    torch.testing.assert_close(nchw, got["image_features"], rtol=0, atol=0)

    jtower = SwinVisionTower(cfg=SwinCfg(**TINY), output_dim=24, output_tokens=True)
    wp, wt = jax.jit(jtower.apply)({"params": variables["params"]["visual"]}, x)
    tower = tswin.SwinVisionTower(tswin.SwinCfg(**TINY), 24, output_tokens=True)
    tower.load_state_dict({k[len("visual."):]: v for k, v in
                           jax_params_to_state_dict(variables).items()
                           if k.startswith("visual.")}, strict=True)
    with torch.no_grad():
        gp, gt = tower(torch.from_numpy(x))
    assert gt.shape == (3, 16, 32)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grad_checkpointing", [False, True])
def test_loss_and_gradients_equal_jax(grad_checkpointing):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_loss_fn,
    )

    jmodel, variables = _jax()
    batch = {"images": images(4, SIZE, seed=11), "texts": token_ids(4, CTX, seed=12)}
    loss_fn = jax_loss_fn(jmodel, JaxStepCfg(loss_type="clip"))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"model": p}, batch, 0, jax.random.PRNGKey(0)), has_aux=True))(
        variables["params"])
    want = jax_params_to_state_dict(jax.device_get(jgrads))
    model = _port(variables, grad_checkpointing=grad_checkpointing)
    calls = []
    if grad_checkpointing:  # each block runs again in the backward
        for blk in model.visual.modules():
            if isinstance(blk, tswin.SwinBlock):
                blk.register_forward_pre_hook(lambda *a: calls.append(1))
    loss, _ = make_loss_fn(model.train(), StepCfg(loss_type="clip"))(
        {"images": torch.from_numpy(batch["images"]),
         "texts": torch.from_numpy(batch["texts"]).long()}, 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == want.keys()
    tables = [n for n in grads if n.endswith("relative_position_bias_table")]
    assert len(tables) == 4
    # the text attention's key bias: zero but for rounding in both
    low = min((_cosine(g, want[n].reshape(g.shape)), n) for n, g in grads.items()
              if not n.endswith("attn.in_proj_bias"))
    assert low[0] >= 0.9999, low
    assert len(calls) == (8 if grad_checkpointing else 0)


def _hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = tswin.SwinCfg(**TINY)
    hf = transformers.SwinModel(transformers.SwinConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
        depths=list(cfg.depths), num_heads=list(cfg.num_heads), window_size=cfg.window_size,
        drop_path_rate=0.0, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    with torch.no_grad():  # the biases and tables away from their init
        for p in hf.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    return hf.eval()


def test_hf_swin_model_through_the_hf_converter():
    from refining_clip_via_dinov2_representations_tpu.models.swin import (
        convert_hf_swin_state_dict as jax_hf,
    )

    hf = _hf_model()
    sd = hf.state_dict()
    ours = tswin.convert_hf_swin_state_dict(sd)
    # the JAX HF converter's tree, in the port's names
    _, variables = _jax()
    params = dict(variables["params"])
    params["visual"] = {**params["visual"], **jax_hf(sd, None)}
    theirs = {k: v for k, v in jax_params_to_state_dict(params).items()
              if k.startswith("visual.trunk.") and not k.startswith("visual.trunk.head")}
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(v.float(), theirs[k]) for k, v in ours.items())
    tower = tswin.SwinVisionTower(tswin.SwinCfg(**TINY), 8, output_tokens=True).eval()
    missing, unexpected = tower.load_state_dict(
        {k[len("visual."):]: v for k, v in ours.items()}, strict=False)
    assert missing == ["trunk.head.weight"] and not unexpected
    x = torch.from_numpy(images(2, SIZE, seed=13))
    with torch.no_grad():
        _, tokens = tower(x)
        want = hf(x.permute(0, 3, 1, 2)).last_hidden_state
    np.testing.assert_allclose(tokens.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_timm_converters_round_trip_as_in_jax():
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.models.swin import (
        convert_timm_swin_state_dict as jax_timm,
    )

    _, variables = _jax()
    exported = {k: torch.as_tensor(np.asarray(v)) for k, v in
                flax_params_to_torch_state_dict(variables["params"]).items()}
    assert "text.token_embedding.weight" in exported
    assert "visual.trunk.layers.0.blocks.1.attn.relative_position_bias_table" in exported
    model = build_model(parse_model_cfg(CFG))
    load_weights(model, exported, strict=True)
    want = jax_params_to_state_dict(variables)
    assert all(torch.equal(v, want[k].reshape(v.shape)) for k, v in model.state_dict().items())
    # timm's derived index buffers are dropped by both importers
    exported["visual.trunk.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.long)
    ours = tswin.convert_timm_swin_state_dict(exported)
    params = dict(variables["params"])
    params["visual"] = jax_timm({k: v.numpy() for k, v in exported.items()})
    theirs = {k: v for k, v in jax_params_to_state_dict(params).items()
              if k.startswith("visual.")}
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(v, theirs[k]) for k, v in ours.items())
    for bad in ("visual.trunk.layers.0.blocks.0.attn.q.weight", "visual.trunk.absolute_pos"):
        with pytest.raises(KeyError):
            tswin.convert_timm_swin_state_dict({bad: torch.zeros(2)})
        with pytest.raises(KeyError):
            jax_timm({bad: np.zeros(2, np.float32)})


def test_the_grid_check_raises_with_the_jax_message():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.swin import (
        SwinCfg, SwinVisionTower,
    )

    bad = dict(TINY, image_size=40)  # a 10 x 10 grid under a window of 4
    with pytest.raises(ValueError) as want:
        SwinVisionTower(cfg=SwinCfg(**bad), output_dim=8).init(jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 40, 40, 3)))
    with pytest.raises(ValueError) as got:
        tswin.SwinVisionTower(tswin.SwinCfg(**bad), 8)
    assert str(got.value) == str(want.value)
    assert "stage grid 10 is not divisible by window 4" in str(got.value)


def test_the_swin_name_builds_at_full_width(monkeypatch):
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

    name = "swin_base_patch4_window7_224"
    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)), init=False)
    assert isinstance(model.visual, tswin.SwinVisionTower)
    blocks = [b for stage in model.visual.trunk.layers for b in stage.blocks]
    # 56, 28, 14 and 7 grids: the last runs one 7 x 7 window, unshifted
    assert [b.shift for b in blocks[-2:]] == [0, 0] and blocks[1].shift == 3
    assert [b.attn.num_heads for b in blocks[::6]] == [4, 16, 16, 16]
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
    blk = "visual.trunk.layers.1.blocks.0."
    assert {blk + "attn.qkv.weight", blk + "attn.proj.weight", blk + "mlp.fc1.weight",
            blk + "mlp.fc2.weight"} <= split
    assert not {blk + "attn.relative_position_bias_table", "visual.trunk.patch_embed.proj.weight",
                "visual.trunk.layers.0.downsample.reduction.weight"} & split
    assert param_split(blk + "attn.relative_position_bias_table") is None
