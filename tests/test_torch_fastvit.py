"""The port's MobileCLIP towers (``models/fastvit.py``) against the JAX
package's ``models/fastvit.py`` on the CPU, at a tiny size: the FastViT of
``tests/test_fastvit.py``'s ``TINY`` (one block a stage, dims 8-64, 64 px;
a ``FASTVIT_DIMS`` entry in both packages) and a 2-block, 32-wide MCi ViT at
32 px (``MCI_DIMS`` and the JAX class's defaults patched), each under a
non-causal 2-layer text tower, on numpy-drawn weights
(``torch_port_utils.jax_drawn_clip``, drawn once a module) with the layer
scales in [0.5, 1.5] (their init, 1e-5, would hide a wrong block):

* eval and training-mode features at 1e-5 (NHWC and NCHW), the towers'
  pooled output and tokens (unnormalised: 1e-5 of their largest magnitude);
  the fp32 CLIP loss at 1e-5 relative and every gradient at cosine >= 0.9999
  against ``jax.value_and_grad`` (FastViT also with per-block
  checkpointing, whose recompute leaves the running statistics moved once);
  two ``make_train_step`` steps against the JAX step, losses and the running
  statistics after them (1e-5 of each tensor's largest element);
  ``freeze_bn_stats`` keeps the statistics bit for bit;
* the timm importers: the JAX exporter's file loads ``strict=True`` and
  equals the JAX importer's tree (round trip exact in JAX too); the
  layer-scale aliases import as JAX imports them; keys JAX refuses raise
  ``ValueError`` in both;
* ``label_params`` equals the JAX labels leaf for leaf with and without
  ``--lock-image`` (MCi's ``pos_embed`` is the JAX ``positional_embedding``);
* the three ``MobileCLIP-*`` names build with the JAX ``eval_shape``
  parameter counts; no FastViT tensor splits under the model axis (the JAX
  spec's placement of it is faulty) and MCi's blocks split as the JAX spec
  says.

The deploy fold, int8 and the two gloo ranks' split steps are in
``test_torch_convert_external.py``.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
)
from refining_clip_via_dinov2_representations_torch.models import fastvit as tfastvit
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.models.resnet import batch_norm_mode
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    make_loss_fn,
    make_train_step,
    train_parameters,
)

from .torch_port_utils import images, jax_drawn_clip, one_thread, token_ids  # noqa: F401

TINY_NAME = "fastvit_tiny_test"
TINY = dict(layers=(1, 1, 1, 1), embed_dims=(8, 16, 32, 64), image_size=64)
MCI = dict(width=32, layers=2, heads=2, image_size=32)
TEXT = {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4, "layers": 2,
        "no_causal_mask": True}
TIMM = {"timm_model_pretrained": False, "timm_proj": None, "timm_drop": 0.0,
        "timm_drop_path": 0.0}
CFGS = {"fastvit": {"embed_dim": 24, "custom_text": True, "text_cfg": TEXT,
                    "vision_cfg": {"image_size": 64, "timm_model_name": TINY_NAME,
                                   "timm_pool": "avg", **TIMM}},
        "mci": {"embed_dim": 24, "custom_text": True, "text_cfg": TEXT,
                "vision_cfg": {"image_size": 32, "timm_model_name": "vit_base_mci_224",
                               "timm_pool": "token", **TIMM}}}
SIZE = {"fastvit": 64, "mci": 32}
FAMILIES = ("fastvit", "mci")
B, CTX = 4, 12
OPTIM_KW = dict(lr=1e-3, head_lr=2e-3, text_lr=5e-4, logit_scale_lr=1e-2, eps=1e-3)


def _patch_tables():
    """The tiny trunks in both packages' tables (returns an undo)."""
    from refining_clip_via_dinov2_representations_tpu.models import fastvit as jfastvit

    saved = (dict(tfastvit.FASTVIT_DIMS), dict(tfastvit.MCI_DIMS),
             dict(jfastvit.FASTVIT_DIMS), jfastvit.MciVisionTransformer)
    tfastvit.FASTVIT_DIMS[TINY_NAME] = tfastvit.FastVitCfg(**TINY)
    tfastvit.MCI_DIMS["vit_base_mci_224"] = tfastvit.MciCfg(**MCI)
    jfastvit.FASTVIT_DIMS[TINY_NAME] = jfastvit.FastVitCfg(**TINY)

    class TinyMci(saved[3]):
        width: int = MCI["width"]
        layers: int = MCI["layers"]
        heads: int = MCI["heads"]

    jfastvit.MciVisionTransformer = TinyMci

    def undo():
        tfastvit.FASTVIT_DIMS.clear()
        tfastvit.FASTVIT_DIMS.update(saved[0])
        tfastvit.MCI_DIMS.clear()
        tfastvit.MCI_DIMS.update(saved[1])
        jfastvit.FASTVIT_DIMS.clear()
        jfastvit.FASTVIT_DIMS.update(saved[2])
        jfastvit.MciVisionTransformer = saved[3]

    return undo


@pytest.fixture(autouse=True, scope="module")
def tiny_trunks():
    undo = _patch_tables()
    yield
    undo()


_DRAWN = {}


def _jax(family):
    """(flax CLIP, variables) of ``family``, drawn once a module; the layer
    scales in [0.5, 1.5]."""
    import jax

    if family not in _DRAWN:
        jmodel, variables = jax_drawn_clip(CFGS[family], seed=6)
        rng = np.random.default_rng(7)
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda p, x: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
            if "layer_scale" in jax.tree_util.keystr(p) else x, variables["params"])
        _DRAWN[family] = (jmodel, variables)
    return _DRAWN[family]


def _port(family, variables=None, **kw):
    variables = variables or _jax(family)[1]
    model = build_model(parse_model_cfg(CFGS[family]), **kw)
    model.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return model


def _batch(family, n=B, seed=10):
    return {"images": images(n, SIZE[family], seed=seed),
            "texts": token_ids(n, CTX, seed=seed + 1)}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "texts" else torch.from_numpy(v)
            for k, v in batch.items()}


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if ".running_" in k}


def _jax_stats(variables, stats):
    sd = jax_params_to_state_dict(variables["params"], batch_stats=stats)
    return {k: v for k, v in sd.items() if ".running_" in k}


def _assert_stats(got, want, tol=1e-5):
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= tol * float(w.abs().max()), (k, err, float(w.abs().max()))


def _cosine(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


@pytest.mark.parametrize("family", FAMILIES)
def test_features_and_tokens_equal_jax_in_eval_and_training_mode(family):
    import jax

    jmodel, variables = _jax(family)
    batch = _batch(family)
    x, ids = _torch(batch)["images"], _torch(batch)["texts"]
    want = jax.jit(jmodel.apply)(variables, batch["images"], batch["texts"])
    model = _port(family).eval()
    tower = tfastvit.FastVitTower if family == "fastvit" else tfastvit.MciVisionTransformer
    assert isinstance(model.visual, tower) and "text" in model._modules and model.custom_text
    with torch.no_grad():
        got = model(x, ids)
        nchw = model.encode_image(x.permute(0, 3, 1, 2), normalize=True)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    # the NHWC image is made contiguous (models/fastvit.py): other conv algorithms
    torch.testing.assert_close(nchw, got["image_features"], rtol=0, atol=1e-6)

    want, mutated = jax.jit(lambda v, a, t: jmodel.apply(
        v, a, t, deterministic=False, mutable=["batch_stats"]))(variables, batch["images"],
                                                                 batch["texts"])
    with torch.no_grad(), batch_norm_mode(model, True):
        got = model(x, ids)
    np.testing.assert_allclose(got["image_features"].numpy(), np.asarray(want["image_features"]),
                               atol=1e-5, rtol=0)
    _assert_stats(_stats(model), _jax_stats(variables, jax.device_get(mutated["batch_stats"])))

    # the tower with its tokens
    from refining_clip_via_dinov2_representations_tpu.models import fastvit as jfastvit

    vis = {"params": variables["params"]["visual"],
           "batch_stats": variables["batch_stats"]["visual"]}
    if family == "fastvit":
        jtower = jfastvit.FastVitTower(cfg=jfastvit.FastVitCfg(**TINY), output_dim=24,
                                       output_tokens=True)
        port = tfastvit.FastVitTower(tfastvit.FastVitCfg(**TINY), 24, output_tokens=True)
    else:
        jtower = jfastvit.MciVisionTransformer(output_dim=24, image_size=32, output_tokens=True)
        port = tfastvit.MciVisionTransformer(tfastvit.MciCfg(**MCI), 24, output_tokens=True)
    wp, wt = jax.jit(jtower.apply)(vis, batch["images"])
    port.load_state_dict({k[len("visual."):]: v for k, v in
                          jax_params_to_state_dict(variables).items() if k.startswith("visual.")})
    with torch.no_grad():
        gp, gt = port.eval()(x)
    assert gt.shape == ((B, 4, 128) if family == "fastvit" else (B, 4, 32))
    for g, w in ((gp, wp), (gt, wt)):  # unnormalised: 1e-5 of the largest magnitude
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("family,grad_checkpointing",
                         [("fastvit", False), ("fastvit", True), ("mci", False)])
def test_loss_and_gradients_equal_jax(family, grad_checkpointing):
    """In training mode (batch statistics), as the step runs."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_loss_fn,
    )

    jmodel, variables = _jax(family)
    batch = _batch(family, seed=20)
    loss_fn = jax_loss_fn(jmodel, JaxStepCfg(loss_type="clip"))

    def value(params):
        return loss_fn({"model": params}, batch, 0, jax.random.PRNGKey(0),
                       variables["batch_stats"])

    (jloss, (_, jstats)), jgrads = jax.jit(jax.value_and_grad(value, has_aux=True))(
        variables["params"])
    want = jax_params_to_state_dict(jax.device_get(jgrads), batch_stats=variables["batch_stats"])
    model = _port(family, grad_checkpointing=grad_checkpointing).train()
    loss, _ = make_loss_fn(model, StepCfg(loss_type="clip"))(_torch(batch), 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == {k for k in want if ".running_" not in k}
    # the text attention's key bias: zero but for rounding in both
    low = min((_cosine(g, want[n].reshape(g.shape)), n) for n, g in grads.items()
              if not n.endswith("attn.in_proj_bias"))
    assert low[0] >= 0.9999, low
    # the statistics moved once, the recompute's run of the norms included
    _assert_stats(_stats(model), _jax_stats(variables, jax.device_get(jstats)))


def _jax_step(jmodel, variables):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, build_optimizer as jax_build_optimizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr as jax_cos
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    tx, _ = jax_build_optimizer({"model": variables["params"]}, JaxOptimCfg(**OPTIM_KW),
                                jax_cos(1e-3, 0, 4))
    state = create_train_state(jax.random.PRNGKey(0), variables["params"], tx,
                               batch_stats=variables["batch_stats"])
    return state, jax_make_step(jmodel, tx, JaxStepCfg(loss_type="clip"))


def _port_step(family, **step_kw):
    model = _port(family)
    opt, _ = optim.build_optimizer(train_parameters(model, None), optim.OptimCfg(**OPTIM_KW),
                                   scheduler.cosine_lr(1e-3, 0, 4))
    return TrainState(model, None, opt), make_train_step(model, StepCfg(loss_type="clip",
                                                                        **step_kw))


@pytest.mark.parametrize("family", FAMILIES)
def test_two_steps_and_running_statistics_equal_jax(family):
    import jax
    import jax.numpy as jnp

    jmodel, variables = _jax(family)
    jstate, jstep = _jax_step(jmodel, variables)
    state, step = _port_step(family)
    for i in range(2):
        batch = _batch(family, seed=30 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, _torch(batch))
        np.testing.assert_allclose(float(m["total_loss"]), float(jm["total_loss"]),
                                   rtol=1e-5 if i == 0 else 1e-4)
    _assert_stats(_stats(state.model), _jax_stats(variables, jax.device_get(jstate.batch_stats)))
    # --lock-image-freeze-bn-stats: the statistics bit for bit
    before = _stats(_port(family))
    frozen_state, frozen = _port_step(family, freeze_bn_stats=True)
    frozen(frozen_state, _torch(_batch(family)))
    assert all(torch.equal(v, before[k]) for k, v in _stats(frozen_state.model).items())


def _exported(family, variables):
    """The JAX exporter's open_clip file, as torch tensors."""
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    return {k: torch.as_tensor(np.asarray(v)) for k, v in flax_params_to_torch_state_dict(
        variables["params"], batch_stats=variables["batch_stats"]).items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_importers_take_and_refuse_what_the_jax_importers_do(family):
    import jax

    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights
    from refining_clip_via_dinov2_representations_tpu.models import fastvit as jfastvit

    _, variables = _jax(family)
    exported = _exported(family, variables)
    assert "text.token_embedding.weight" in exported
    want = jax_params_to_state_dict(variables)
    jimport = (jfastvit.convert_timm_fastvit_state_dict if family == "fastvit"
               else jfastvit.convert_timm_mci_vit_state_dict)
    timport = (tfastvit.convert_timm_fastvit_state_dict if family == "fastvit"
               else tfastvit.convert_timm_mci_vit_state_dict)
    # the JAX exporter and importer are symmetric: the round trip is exact
    back = jimport(exported)
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(x)  # noqa: E731
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    vis = {"params": variables["params"]["visual"],
           "batch_stats": variables["batch_stats"]["visual"]}
    assert leaves(back).keys() == leaves(vis).keys()
    assert all(np.array_equal(v, leaves(vis)[k]) for k, v in leaves(back).items())

    model = build_model(parse_model_cfg(CFGS[family]))
    load_weights(model, exported, strict=True)
    assert all(torch.equal(v, want[k].reshape(v.shape)) for k, v in model.state_dict().items())

    sd = dict(exported)
    if family == "fastvit":  # the layer scales as Apple's names them, without .gamma
        for k in [k for k in sd if k.endswith(".gamma")]:
            sd[k[:-len(".gamma")]] = sd.pop(k).reshape(-1)
        bad = ("visual.trunk.stages.0.blocks.0.token_mixer.conv.weight",
               "visual.trunk.stem.0.rbr_conv.0.conv.weight", "visual.trunk.head.proj",
               "visual.trunk.stages.1.downsample.proj.2.conv.weight")
    else:  # the table and the token of other shapes of their size
        sd["visual.trunk.pos_embed"] = sd["visual.trunk.pos_embed"].reshape(4, 32)
        sd["visual.trunk.cls_token"] = sd["visual.trunk.cls_token"].reshape(32)
        bad = ("visual.trunk.blocks.0.attn.q_proj.weight", "visual.trunk.fc_norm.weight",
               "visual.trunk.patch_embed.proj.weight")
    ours = timport(sd)
    theirs = {k: v for k, v in jax_params_to_state_dict(
        {**variables["params"], "visual": jimport(sd)["params"]},
        batch_stats={"visual": jimport(sd)["batch_stats"]}).items() if k.startswith("visual.")}
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(v.reshape(theirs[k].shape), theirs[k]) for k, v in ours.items())
    load_weights(build_model(parse_model_cfg(CFGS[family])), sd, strict=True)
    for key in bad:
        with pytest.raises(ValueError):
            timport({key: torch.zeros(2)})
        with pytest.raises(ValueError):
            jimport({key: np.zeros(2, np.float32)})
    # BatchNorm's num_batches_tracked (timm's files carry it): the port drops it,
    # the JAX importer refuses it
    nbt = next(k for k in exported if k.endswith(".running_mean")).replace(
        "running_mean", "num_batches_tracked")
    assert timport({nbt: torch.tensor(3)}) == {}
    with pytest.raises(ValueError):
        jimport({nbt: np.asarray(3)})


@pytest.mark.parametrize("family,lock_image", [(f, lock) for f in FAMILIES
                                               for lock in (False, True)])
def test_label_params_equal_the_jax_labels(family, lock_image):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, label_params as jax_label_params,
    )

    _, variables = _jax(family)
    leaves, tree = jax.tree_util.tree_flatten(variables["params"])
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    index = {k: int(v.flatten()[0]) for k, v in
             jax_params_to_state_dict(marked, variables["batch_stats"]).items()
             if ".running_" not in k}
    jlabels = jax.tree_util.tree_leaves(jax_label_params(
        {"model": variables["params"]}, JaxOptimCfg(lock_image=lock_image)))
    names = dict(build_model(parse_model_cfg(CFGS[family])).named_parameters())
    got = optim.label_params(names, optim.OptimCfg(lock_image=lock_image))
    assert got == {n: jlabels[index[n]] for n in names}
    visual = {got[n] for n in names if n.startswith("visual.")}
    if lock_image:  # MCi's blocks sit outside visual.transformer: no block unlocks
        assert visual == {"frozen"}
    elif family == "mci":
        assert got["visual.trunk.pos_embed"] == "text"  # the JAX positional_embedding


# the JAX ``eval_shape`` counts (parameters; BatchNorm running statistics)
COUNTS = {"MobileCLIP-S1": (84_969_729, 89_344), "MobileCLIP-S2": (99_243_329, 124_480),
          "MobileCLIP-B": (149_777_921, 2_304)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_three_names_build_with_the_jax_counts(name, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import (
        get_model_config, list_models,
    )
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    monkeypatch.setitem(tfastvit.MCI_DIMS, "vit_base_mci_224", tfastvit.MciCfg())
    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)), init=False)
    params, stats = COUNTS[name]
    assert sum(p.numel() for p in model.parameters()) == params
    assert sum(b.numel() for k, b in model.named_buffers() if ".running_" in k) == stats
    assert model.custom_text and model.text.causal == (name == "MobileCLIP-B")
    size = JAX_CONFIGS[name]["vision_cfg"]["image_size"]
    assert model.visual.image_size == (size, size)
    if name == "MobileCLIP-S2":
        assert model.visual.trunk.stages[3].blocks[0].token_mixer.heads == 20  # 640 / 32


def test_model_axis_keeps_fastvit_whole_and_splits_the_mci_blocks():
    import jax

    from refining_clip_via_dinov2_representations_torch.parallel.tensor import param_split
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import (
        MODEL_AXIS, _param_spec,
    )

    from .test_torch_tp_spec import _check, _markers

    _, variables = _jax("fastvit")
    names = jax_params_to_state_dict(variables)
    assert not [n for n in names if n.startswith("visual.") and param_split(n) is not None]
    assert param_split("text.transformer.resblocks.0.attn.in_proj_weight").packs == 3
    # the JAX spec's fault: a 4-D 1x1 kernel split on a dimension of size 1
    kernel = variables["params"]["visual"]["stage0_block0"]["mlp"]["fc1"]["kernel"]
    spec = tuple(_param_spec(("visual", "stage0_block0", "mlp", "fc1", "kernel"), kernel))
    assert kernel.shape[:2] == (1, 1) and MODEL_AXIS in spec[:2]

    _, variables = _jax("mci")
    split = _check(jax_params_to_state_dict(_markers(variables["params"]), jax.tree.map(
        np.zeros_like, variables["batch_stats"])))
    blk = "visual.trunk.blocks.1."
    assert {blk + "attn.qkv.weight", blk + "attn.proj.weight", blk + "mlp.fc1.weight",
            blk + "mlp.fc2.weight"} <= split
    assert not {n for n in split if n.startswith("visual.trunk.patch_embed.")}
