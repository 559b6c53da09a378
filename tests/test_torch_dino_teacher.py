"""The port's live DINOv2 teacher and soft-label helpers against the JAX
package's, and the teacher inside the train step.

The train-step case runs one DINO-soft step of a tiny CLIP with a live tiny
teacher in both packages, from one init carried across with the converters,
on the same seeded batch: the JAX ``make_train_step(dino_teacher=
LiveDinoTeacher(...))`` (attention through the interpreted Pallas kernels)
against the port's ``make_train_step(..., dino_teacher=...)``. The student
sees 32-px images, so the teacher resizes them to 28 px and its 3x3
position table to 2x2. Tolerances in fp32: the losses at 1e-5 relative (as
``tests/test_torch_train_step.py``), the gradient norm at 1e-4, teacher
features and the helpers at 2e-4 / 1e-5 (the helpers' softmax at
temperature 0.02 and the KL at 1e-5 absolute, ``tests/test_dinov2.py``).
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import (
    DinoLossCfg,
    DinoProjectionHead,
)
from refining_clip_via_dinov2_representations_torch.models import build_model, parse_model_cfg
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
    LiveDinoTeacher,
    compute_pairwise_similarities,
    compute_soft_label_loss,
    create_soft_labels,
    renormalize_clip_to_imagenet,
)
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    make_train_step,
    train_parameters,
)

from .torch_port_utils import (
    DINO_TINY,
    TINY_CFG,
    images,
    jax_clip,
    jax_dinov2,
    port_dinov2,
    token_ids,
)

LIVE_CFG = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "image_size": 32}}
DIM = DINO_TINY["hidden_size"]
B = 6


def _port_teacher(variables, **kw) -> LiveDinoTeacher:
    return LiveDinoTeacher(port_dinov2(variables["params"]), **kw)


@pytest.mark.parametrize("stats", ["openai", "half"])
def test_renormalize_clip_to_imagenet_matches_jax(stats):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import (
        renormalize_clip_to_imagenet as jax_renorm,
    )

    kw = {} if stats == "openai" else dict(input_mean=(0.5,) * 3, input_std=(0.5,) * 3)
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_renorm(jnp.asarray(x), **kw))
    got = renormalize_clip_to_imagenet(torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=1e-6)


def test_soft_label_helpers_match_jax():
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train import dino_teacher as jt

    rng = np.random.default_rng(1)
    feats = rng.normal(size=(6, 8)).astype(np.float32)
    pred = rng.normal(size=(6, 6)).astype(np.float32)
    sims = compute_pairwise_similarities(torch.from_numpy(feats))
    jsims = jt.compute_pairwise_similarities(jnp.asarray(feats))
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=1e-6)
    q = create_soft_labels(sims, temperature=0.02)
    jq = jt.create_soft_labels(jsims, temperature=0.02)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)
    loss = compute_soft_label_loss(torch.from_numpy(pred), q)
    jloss = jt.compute_soft_label_loss(jnp.asarray(pred), jq)
    assert abs(float(loss) - float(jloss)) < 1e-5


@pytest.mark.parametrize("size", [28, 32], ids=["patch-multiple", "resized"])
def test_live_teacher_extract_matches_jax(size):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import (
        LiveDinoTeacher as JaxTeacher,
    )

    jmodel, variables = jax_dinov2()
    x = images(3, size, seed=9)
    want = np.asarray(JaxTeacher(jmodel, variables).extract(jnp.asarray(x)))
    teacher = _port_teacher(variables)
    assert not any(p.requires_grad for p in teacher.model.parameters())
    pixels = torch.from_numpy(x).requires_grad_()
    got = teacher.extract(pixels)
    assert not got.requires_grad  # no graph through the teacher
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    nchw = teacher.extract(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(nchw, got, atol=0, rtol=0)


def _batch():
    return {"images": images(B, 32, seed=6),
            "texts": token_ids(B, LIVE_CFG["text_cfg"]["context_length"], seed=7)}


def test_live_teacher_step_matches_jax_make_train_step():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build_model, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import (
        LiveDinoTeacher as JaxTeacher,
    )
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, build_optimizer as jax_build_optimizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr as jax_cos
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    loss_kw = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
    step_kw = dict(loss_type="dino", log_grad_norm=True)
    optim_kw = dict(lr=1e-3, eps=1e-3)
    jteacher_model, tvars = jax_dinov2()

    _, variables = jax_clip(LIVE_CFG)
    jmodel = jax_build_model(jax_parse(LIVE_CFG), attn_impl="fused")
    head_params = jax.device_get(JaxHead(dino_dim=DIM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, LIVE_CFG["embed_dim"])))["params"])
    params = {"model": variables["params"], "dino_head": head_params}
    tx, _ = jax_build_optimizer(params, JaxOptimCfg(**optim_kw), jax_cos(1e-3, 0, 3))
    jstate = create_train_state(jax.random.PRNGKey(0), variables["params"], tx, head_params)
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(dino=JaxLossCfg(**loss_kw), **step_kw),
                          head=JaxHead(dino_dim=DIM),
                          dino_teacher=JaxTeacher(jteacher_model, tvars))

    model = build_model(parse_model_cfg(LIVE_CFG), attn_impl="fused")
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    head = DinoProjectionHead(LIVE_CFG["embed_dim"], DIM)
    head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    teacher = _port_teacher(tvars)
    opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(**optim_kw),
                                   scheduler.cosine_lr(1e-3, 0, 3))
    state = TrainState(model, head, opt)
    step = make_train_step(model, StepCfg(dino=DinoLossCfg(**loss_kw), **step_kw), head,
                           dino_teacher=teacher)

    batch = _batch()
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m = step(state, {"images": torch.from_numpy(batch["images"]),
                        "texts": torch.from_numpy(batch["texts"]).long()})
    assert float(m["soft_loss"]) > 0 and float(m["weighted_loss"]) > 0
    for k in ("total_loss", "soft_loss", "classic_loss", "weighted_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_teacher_stays_out_of_the_optimizer_and_the_checkpoint(tmp_path):
    _, tvars = jax_dinov2()
    teacher = _port_teacher(tvars)
    teacher_before = {k: v.clone() for k, v in teacher.model.state_dict().items()}
    model = build_model(parse_model_cfg(LIVE_CFG), attn_impl="fused")
    head = DinoProjectionHead(LIVE_CFG["embed_dim"], DIM)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(lr=1e-3), scheduler.const_lr(1e-3, 0, 2))
    state = TrainState(model, head, opt, 0, torch.Generator().manual_seed(0))
    step = make_train_step(model, StepCfg(loss_type="dino", log_grad_norm=True,
                                          dino=DinoLossCfg(lambda_soft=0.5)),
                           head, dino_teacher=teacher)
    batch = _batch()
    state, m = step(state, {"images": torch.from_numpy(batch["images"]),
                            "texts": torch.from_numpy(batch["texts"]).long()})
    assert float(m["soft_loss"]) > 0
    teacher_ids = {id(p) for p in teacher.model.parameters()}
    assert not teacher_ids & {id(p) for p in model.parameters()}
    assert not teacher_ids & {id(p) for p in opt.params}
    assert len(opt.params) == len(named) == len(opt.grads())
    assert all(p.grad is None for p in teacher.model.parameters())
    for k, v in teacher.model.state_dict().items():
        torch.testing.assert_close(v, teacher_before[k], atol=0, rtol=0)

    path = save_checkpoint(str(tmp_path), state, 1)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert set(saved["state_dict"]) == set(model.state_dict())
    assert set(saved["dino_head"]) == set(head.state_dict())
    n_state = sum(len(s) > 0 for s in saved["optimizer"]["state"].values())
    assert len(saved["optimizer"]["state"]) == len(named) == n_state
    restored, epoch, step_in_epoch, data_order = restore_checkpoint(path, state)
    assert epoch == 1 and restored.step == 1 and (step_in_epoch, data_order) == (0, {})
    for k, v in teacher.model.state_dict().items():
        torch.testing.assert_close(v, teacher_before[k], atol=0, rtol=0)
