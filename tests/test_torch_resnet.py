"""The port's ModifiedResNet (``models/resnet.py``) against the JAX package's
``models/resnet.py`` on the CPU, at a tiny size (stages of one block, width
8, 64 px, a two-layer text tower), on one set of numpy-drawn weights and
running statistics (``torch_port_utils.jax_drawn_clip``):

* features in eval mode (running statistics) and in training mode (batch
  statistics) at 1e-5 on the L2-normalised features, NHWC and NCHW alike;
  the running statistics after one training forward equal the JAX
  ``batch_stats`` within 1e-5 of each tensor's largest magnitude (the
  updates ``0.99 * running + 0.01 * batch`` cancel to values near zero,
  where an element-wise relative test would read fp32 summation order);
* the fp32 CLIP step: loss at 1e-5 relative and every gradient at cosine
  >= 0.9999 against ``jax.value_and_grad`` of the JAX loss; two steps of
  ``make_train_step`` and one under ``--accum-freq 2`` against the JAX
  step, losses at 1e-5 and the running statistics after them as above
  (flax's momentum and the biased variance, N updates in each phase);
* ``--lock-image --lock-image-freeze-bn-stats`` keeps the statistics bit
  for bit (the step normalises with them); ``--lock-image`` alone moves
  them as the JAX forward does; a CLI run with evaluation and the engine
  leave them bit for bit;
* ``label_params`` equals the JAX labels leaf for leaf, with and without
  ``--lock-image`` (``attnpool`` in heads, ``layer4``/``layer3`` in the
  fork's ResNet groups);
* the int8 engine quantizes the JAX quantizer's leaves (the convolutions
  per output channel) and equals the JAX int8 engine at 1e-5; a bucket-1
  ``export``/``load_exported`` round trip equals the engine at 1e-5;
* two gloo ranks equal the one-process step at the global batch (the
  statistics are the global batch's: loss 1e-5, every gradient cosine >=
  0.9999, running statistics 1e-6);
* an OpenAI TorchScript archive of the tower (``num_batches_tracked``
  included, as OpenAI's carry it) loads exactly, by path and by tag; the
  ten ``RN*`` names build at full width on the meta device.
"""

import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.models.resnet import (
    BatchNorm2d,
    ModifiedResNet,
    batch_norm_mode,
)
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    make_loss_fn,
    make_train_step,
    train_parameters,
)

from .torch_dist_utils import run_ranks
from .torch_port_utils import images, jax_drawn_clip, one_thread, token_ids  # noqa: F401

CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8, "patch_size": None},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                 "layers": 2},
}
MODEL = "tiny-torch-rn"
register_model_config(MODEL, CFG)
B, SIZE, CTX = 4, 64, 12
OPTIM_KW = dict(lr=1e-3, head_lr=2e-3, text_lr=5e-4, logit_scale_lr=1e-2, eps=1e-3,
                resnet_lr4=2e-3, resnet_lr3=3e-3)
RN_NAMES = ("RN50", "RN50-quickgelu", "RN101", "RN101-quickgelu", "RN50x4", "RN50x4-quickgelu",
            "RN50x16", "RN50x16-quickgelu", "RN50x64", "RN50x64-quickgelu")


@pytest.fixture(scope="module")
def jax_rn():
    """(flax module, variables) of ``CFG``, drawn once for the module."""
    return jax_drawn_clip(CFG, seed=3)


@pytest.fixture(scope="module")
def jax_train_forward(jax_rn):
    """The JAX training forward on ``_batch()``: (outputs, new batch_stats)."""
    import jax

    jmodel, variables = jax_rn
    batch = _batch()
    out, mutated = jax.jit(lambda v, x, t: jmodel.apply(
        v, x, t, deterministic=False, mutable=["batch_stats"]))(variables, batch["images"],
                                                                 batch["texts"])
    return out, jax.device_get(mutated["batch_stats"])


def _port(variables, attn_impl="fused"):
    model = build_model(parse_model_cfg(CFG), attn_impl=attn_impl)
    model.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return model


def _batch(n=B, seed=10):
    return {"images": images(n, SIZE, seed=seed), "texts": token_ids(n, CTX, seed=seed + 1)}


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


# the pool's key bias adds one constant to every logit of a row, which the
# softmax takes away: its gradient is zero but for rounding, in both
ZERO_GRAD = "visual.attnpool.k_proj.bias"


def _assert_grads(got, want, min_cos=0.9999):
    top = max(float(g.abs().max()) for g in want.values())
    for n in (ZERO_GRAD,):
        assert float(got[n].abs().max()) <= 1e-5 * top >= float(want[n].abs().max()), n
    low = min((_cosine(g, want[n].reshape(g.shape)), n) for n, g in got.items()
              if n != ZERO_GRAD)
    assert low[0] >= min_cos, low


def test_features_equal_jax_in_eval_and_training_mode(jax_rn, jax_train_forward):
    import jax

    jmodel, variables = jax_rn
    batch = _batch()
    want = jax.jit(jmodel.apply)(variables, batch["images"], batch["texts"])
    model = _port(variables)
    assert isinstance(model.visual, ModifiedResNet) and model.visual.attnpool.num_heads == 4
    x, ids = _torch(batch)["images"], _torch(batch)["texts"]
    with torch.no_grad():
        got = model(x, ids)
        nchw = model.encode_image(x.permute(0, 3, 1, 2), normalize=True)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    torch.testing.assert_close(nchw, got["image_features"], rtol=0, atol=0)
    loaded = _stats(_port(variables))
    assert all(torch.equal(v, loaded[k]) for k, v in _stats(model).items())

    want, mutated = jax_train_forward
    with torch.no_grad(), batch_norm_mode(model, True):
        got = model(x, ids)
    np.testing.assert_allclose(got["image_features"].numpy(), np.asarray(want["image_features"]),
                               atol=1e-5, rtol=0)
    _assert_stats(_stats(model), _jax_stats(variables, mutated))


def _jax_step(jmodel, variables, accum, **step_kw):
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
    return state, jax_make_step(jmodel, tx, JaxStepCfg(loss_type="clip", accum_freq=accum,
                                                       **step_kw))


def _port_step(variables, accum, **step_kw):
    model = _port(variables)
    named = train_parameters(model, None)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**OPTIM_KW),
                                   scheduler.cosine_lr(1e-3, 0, 4))
    state = TrainState(model, None, opt)
    return state, make_train_step(model, StepCfg(loss_type="clip", accum_freq=accum, **step_kw))


def test_loss_and_gradients_equal_jax(jax_rn):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_loss_fn,
    )

    jmodel, variables = jax_rn
    batch = _batch(seed=20)
    loss_fn = jax_loss_fn(jmodel, JaxStepCfg(loss_type="clip"))

    def value(params):
        return loss_fn({"model": params}, batch, 0, jax.random.PRNGKey(0),
                       variables["batch_stats"])

    (jloss, (_, _)), jgrads = jax.jit(jax.value_and_grad(value, has_aux=True))(
        variables["params"])
    want = jax_params_to_state_dict(jax.device_get(jgrads), batch_stats=variables["batch_stats"])
    model = _port(variables)
    loss, _ = make_loss_fn(model, StepCfg(loss_type="clip"))(_torch(batch), 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(model.named_parameters())
    assert grads.keys() == {k for k in want if ".running_" not in k}
    _assert_grads({n: p.grad for n, p in grads.items()}, want)


@pytest.mark.parametrize("accum", [1, 2])
def test_steps_and_running_statistics_equal_jax(jax_rn, accum):
    """accum 1: two steps; accum 2: one step of two microbatches (the
    statistics update twice in each phase)."""
    import jax
    import jax.numpy as jnp

    jmodel, variables = jax_rn
    jstate, jstep = _jax_step(jmodel, variables, accum)
    state, step = _port_step(variables, accum)
    for i in range(2 if accum == 1 else 1):
        batch = _batch(B * accum, seed=30 + i)
        if accum > 1:
            batch = {k: v.reshape(accum, B, *v.shape[1:]) for k, v in batch.items()}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, _torch(batch))
        # the second step's weights carry the first update of each side's
        # gradients; the JAX ones hold more fp32 rounding (3e-5 of a
        # tensor's largest element against the port's 8e-6, both against a
        # float64 run of the port), which AdamW passes on at lr / eps
        np.testing.assert_allclose(float(m["total_loss"]), float(jm["total_loss"]),
                                   rtol=1e-5 if i == 0 else 1e-4)
    _assert_stats(_stats(state.model),
                  _jax_stats(variables, jax.device_get(jstate.batch_stats)))


def test_lock_image_freeze_keeps_statistics_and_lock_image_alone_moves_them(
        jax_rn, jax_train_forward):
    _, variables = jax_rn
    batch = _batch()
    before = _stats(_port(variables))
    frozen_state, frozen = _port_step(variables, 1, freeze_bn_stats=True)
    _, m = frozen(frozen_state, _torch(batch))
    assert all(torch.equal(v, before[k]) for k, v in _stats(frozen_state.model).items())
    with torch.no_grad():  # the frozen step normalised with the running statistics
        out = _port(variables)(*_torch(batch).values())
    from refining_clip_via_dinov2_representations_torch.losses import clip_loss

    np.testing.assert_allclose(float(m["total_loss"]), float(clip_loss(
        out["image_features"], out["text_features"], out["logit_scale"])), rtol=1e-6)

    # --lock-image alone: the tower is frozen in the optimizer, its
    # statistics still move, to what the JAX training forward gives
    model = _port(variables)
    opt, labels = optim.build_optimizer(train_parameters(model, None),
                                        optim.OptimCfg(**OPTIM_KW, lock_image=True),
                                        scheduler.cosine_lr(1e-3, 0, 4))
    assert all(labels[n] == "frozen" for n in labels if n.startswith("visual."))
    state = TrainState(model, None, opt)
    make_train_step(model, StepCfg(loss_type="clip"))(state, _torch(batch))
    _assert_stats(_stats(model), _jax_stats(variables, jax_train_forward[1]))


def test_cli_freeze_flag_evaluation_and_engine_leave_statistics(tmp_path, caplog):
    """``train.main`` with ``--lock-image --lock-image-freeze-bn-stats``, a
    pre-train and a per-epoch evaluation: the final checkpoint's statistics
    are the seeded model's bit for bit; without the freeze flag they move,
    and the checkpoint loads them back; ``--force-patch-dropout`` gives the
    JAX CLI's warning and no patch dropout. The engine leaves a model's
    buffers as they were."""
    import logging

    import sys

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train import main

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    try:
        import mini_flickr
    finally:
        sys.path.pop(0)
    data = str(tmp_path / "data")
    mini_flickr.generate(data, n_train=8, n_val=4, size_px=SIZE)
    seeded = _stats(build_model(parse_model_cfg(CFG), seed=0))
    for freeze in (True, False):
        logs = str(tmp_path / f"logs{int(freeze)}")
        argv = ["--model", MODEL, "--train-data", f"{data}/train.csv", "--val-data",
                f"{data}/val.csv", "--dataset-type", "csv", "--batch-size", "4", "--epochs", "1",
                "--workers", "1", "--logs", logs, "--name", "run", "--precision", "fp32",
                "--force-cpu", "--lock-image", "--seed", "0"]
        with caplog.at_level(logging.WARNING):
            main.main(argv + (["--lock-image-freeze-bn-stats"] if freeze
                              else ["--force-patch-dropout", "0.5"]))
        warned = any("no effect on BatchNorm towers" in r.getMessage() for r in caplog.records)
        assert warned != freeze
        caplog.clear()
        path = os.path.join(logs, "run", "checkpoints", "epoch_1.pt")
        sd = torch.load(path, weights_only=False)["state_dict"]
        same = [torch.equal(sd[k], v) for k, v in seeded.items()]
        assert all(same) if freeze else not any(same), freeze
    # the checkpoint carries the statistics back (what a resume restores)
    resumed, _ = create_model(MODEL, pretrained=path, device="cpu")
    assert all(torch.equal(v, sd[k]) for k, v in _stats(resumed).items())

    model = build_model(parse_model_cfg(CFG), seed=0)
    engine = ClipInferenceEngine(model, (SIZE, SIZE), CTX, buckets=(2,), dtype=torch.float32)
    engine.encode_image(images(3, SIZE))
    assert all(torch.equal(v, seeded[k]) for k, v in _stats(model).items())


@pytest.mark.parametrize("lock_image", [False, True])
def test_label_params_equal_the_jax_labels(jax_rn, lock_image):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, label_params as jax_label_params,
    )

    _, variables = jax_rn
    # each JAX leaf filled with its own index, carried through the converter
    leaves, tree = jax.tree_util.tree_flatten(variables["params"])
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    index = {k: int(v.flatten()[0]) for k, v in
             jax_params_to_state_dict(marked, variables["batch_stats"]).items()
             if ".running_" not in k}
    jlabels = jax.tree_util.tree_leaves(jax_label_params(
        {"model": variables["params"]}, JaxOptimCfg(lock_image=lock_image)))
    names = dict(build_model(parse_model_cfg(CFG)).named_parameters())
    got = optim.label_params(names, optim.OptimCfg(lock_image=lock_image))
    assert got == {n: jlabels[index[n]] for n in names}
    groups = set(got.values())
    assert ({"frozen"} if lock_image else {"resnet_l4", "resnet_l3"}) <= groups
    if not lock_image:
        assert got["visual.attnpool.positional_embedding"] == "heads"
        assert got["visual.layer4.0.conv2.weight"] == "resnet_l4"


def test_int8_engine_matches_the_jax_int8_engine(jax_rn):
    import jax

    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, Int8Weight, dequantize, quantize_state_dict_int8,
    )
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine, dequantize_variables, quantize_variables_int8,
    )

    jmodel, variables = jax_rn
    min_size = 1024
    jq = quantize_variables_int8(variables, min_size)
    is_q = lambda x: isinstance(x, dict) and set(x) == {"_q", "_s"}  # noqa: E731
    marks = jax.tree.map(lambda x: np.ones(x["_q"].shape, np.float32) if is_q(x)
                         else np.zeros(np.shape(x), np.float32), jq["params"], is_leaf=is_q)
    jax_int8 = {k for k, v in jax_params_to_state_dict(marks, variables["batch_stats"]).items()
                if ".running_" not in k and bool((v == 1).all())}
    ours = quantize_state_dict_int8(jax_params_to_state_dict(variables), min_size)
    assert {k for k, v in ours.items() if isinstance(v, Int8Weight)} == jax_int8
    assert "visual.layer4.0.conv3.weight" in jax_int8  # a convolution, per output channel
    want = jax_params_to_state_dict(jax.device_get(dequantize_variables(jq, np.float32)))
    got = dequantize(ours)
    assert all(torch.equal(got[k], want[k]) for k in jax_int8)

    engine = ClipInferenceEngine(_port(variables, "xla"), (SIZE, SIZE), CTX, buckets=(4,),
                                 quantize="int8", quantize_min_size=min_size)
    jengine = JaxEngine(jmodel, variables, (SIZE, SIZE), CTX, buckets=(4,), quantize="int8",
                        quantize_min_size=min_size)
    x = images(3, SIZE, seed=50)
    np.testing.assert_allclose(engine.encode_image(x), jengine.encode_image(x), atol=1e-5,
                               rtol=0)


def test_bucket_one_export_round_trip_equals_the_engine(jax_rn, tmp_path):
    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, load_exported,
    )

    _, variables = jax_rn
    model = _port(variables)
    before = _stats(model)
    engine = ClipInferenceEngine(model, (SIZE, SIZE), CTX, buckets=(1,), dtype=torch.float32)
    paths = engine.export(str(tmp_path))
    x = images(1, SIZE, seed=60)
    got = load_exported(paths["encode_image_b1"])(x)
    np.testing.assert_allclose(np.asarray(got), engine.encode_image(x), atol=1e-5, rtol=0)
    assert all(torch.equal(v, before[k]) for k, v in _stats(model).items())


def _rank_step(rank, world, state_dict, batch, rows):
    """One fp32 CLIP step of the tiny ResNet over this rank's ``rows`` under
    DDP (``group`` the world): loss, gradients, running statistics."""
    import torch.distributed as dist

    from refining_clip_via_dinov2_representations_torch.parallel.mesh import wrap_ddp
    from refining_clip_via_dinov2_representations_torch.train.step import Towers

    model = build_model(parse_model_cfg(CFG), attn_impl="fused")
    model.load_state_dict(state_dict, strict=True)
    group = dist.group.WORLD if world > 1 else None
    towers = wrap_ddp(Towers(model), torch.device("cpu"), group) if group else None
    opt, _ = optim.build_optimizer(train_parameters(model, None), optim.OptimCfg(**OPTIM_KW),
                                   scheduler.cosine_lr(1e-3, 0, 4))
    state = TrainState(model, None, opt)
    step = make_train_step(model, StepCfg(loss_type="clip"), group=group, towers=towers)
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    _, m = step(state, local)
    return {"loss": float(m["total_loss"]),  # numpy: tensors would leave through shared memory
            "stats": {k: v.numpy() for k, v in _stats(model).items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()}}


def test_two_ranks_equal_the_one_process_step_at_the_global_batch(jax_rn):
    _, variables = jax_rn
    sd = jax_params_to_state_dict(variables)
    batch = _torch(_batch(2 * B, seed=70))
    as_torch = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    ranks = [{"loss": r["loss"], "stats": as_torch(r["stats"]), "grads": as_torch(r["grads"])}
             for r in [_rank_step(0, 1, sd, batch, 2 * B)] + run_ranks(_rank_step, 2, sd, batch,
                                                                       B)]
    one = ranks.pop(0)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        _assert_grads(r["grads"], one["grads"])
        _assert_stats(r["stats"], one["stats"], tol=1e-6)


TINY_OPENAI_RN = {  # OpenAI's shapes give text heads = width // 64
    "embed_dim": 32, "quick_gelu": True,
    "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8, "patch_size": None},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 64, "heads": 1,
                 "layers": 1},
}


def test_openai_archive_loads_exactly_by_path_and_by_tag(tmp_path, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, openai, pretrained,
    )

    from .torch_port_utils import seed_hub_snapshot

    model = build_model(parse_model_cfg(TINY_OPENAI_RN), seed=5)
    with torch.no_grad():
        for m in model.modules():  # statistics away from their init
            if isinstance(m, BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = model.state_dict()
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    archive = openai.save_openai_archive(sd, str(tmp_path / "RN.pt"))
    cfg = openai.infer_openai_config(openai.load_openai_state_dict(archive))
    assert cfg["vision_cfg"] == {"layers": [1, 1, 1, 1], "width": 8, "patch_size": None,
                                 "image_size": 64}
    want = {k: v.half().float() for k, v in model.state_dict().items()}
    by_path = openai.load_openai_model(archive, device="cpu")
    assert all(torch.equal(v, want[k]) for k, v in by_path.state_dict().items())

    register_model_config("tiny-torch-rn-openai", TINY_OPENAI_RN)
    entry = pretrained.get_pretrained_cfg("RN50", "openai")
    monkeypatch.setitem(pretrained._PRETRAINED, "tiny-torch-rn-openai", {"openai": entry})
    snap = seed_hub_snapshot(str(tmp_path / "hub"), repo=entry["hf_hub"].rstrip("/"))
    os.replace(archive, os.path.join(snap, "open_clip_pytorch_model.bin"))
    by_tag, _ = create_model("tiny-torch-rn-openai", pretrained="openai",
                             cache_dir=str(tmp_path / "hub"), device="cpu")
    assert all(torch.equal(v, want[k]) for k, v in by_tag.state_dict().items())


@pytest.mark.parametrize("name", RN_NAMES)
def test_the_ten_names_build_at_full_width(name):
    from refining_clip_via_dinov2_representations_torch.models import (
        get_model_config, list_models,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import param_split
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)))
    visual = model.visual
    assert isinstance(visual, ModifiedResNet)
    cfg = JAX_CONFIGS[name]["vision_cfg"]
    keys = {"RN50": 50, "RN101": 50, "RN50x4": 82, "RN50x16": 145, "RN50x64": 197}
    assert visual.attnpool.positional_embedding.shape[0] == keys[name.split("-")[0]]
    assert visual.attnpool.num_heads * 64 == cfg["width"] * 32  # head dim 64
    assert len(visual.layer3) == cfg["layers"][2]
    # the conv tower stays whole under a model axis; the text tower splits
    assert not any(param_split(n) for n, _ in visual.named_parameters(prefix="visual"))
    assert param_split("transformer.resblocks.0.attn.in_proj_weight") is not None
