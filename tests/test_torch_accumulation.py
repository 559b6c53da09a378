"""Cached-feature gradient accumulation in the port's train step.

* Against the JAX package: one step of ``make_train_step(accum_freq=2)``
  on a tiny CLIP (attention through the interpreted Pallas kernels, forward
  and backward) and the port's step with ``StepCfg(accum_freq=2)``, from one
  init carried across with the converters, on the same two stacked
  microbatches; for the ``clip`` loss and for ``dino`` with the projection
  head. fp32: the loss and every metric at 1e-5 relative, the gradient norm
  at 1e-4, every updated tensor at 1e-5 relative and 5e-6 absolute (lr
  1e-3; AdamW at eps 1e-3, as ``tests/test_torch_train_step.py`` says why).
* Against the big batch: the port's accumulated gradients over two
  microbatches of 4 equal its gradients of one batch of 8 for every tensor,
  except the logit scale's, which is twice the big batch's (it is live in
  both passes); each tensor within 1e-5 of its largest magnitude (fp32,
  sums in another order).
* With the live teacher: ``extract`` runs once a microbatch (phase 1), not
  twice, and phase 2 reuses its rows.
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
from refining_clip_via_dinov2_representations_torch.train.dino_teacher import LiveDinoTeacher
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    accumulate_grads,
    make_loss_fn,
    make_train_step,
    train_parameters,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, jax_dinov2, port_dinov2, token_ids

ACCUM, MICRO, DINO_DIM = 2, 4, 24
# one layer a tower: the JAX step's compile with the interpreted kernels
# sets this file's time
CFG = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "layers": 1},
       "text_cfg": {**TINY_CFG["text_cfg"], "layers": 1}}
LOSS_KW = {"clip": {}, "dino": dict(lambda_soft=0.5, soft_mode="kl_teacher",
                                    lambda_weighted=0.3)}
METRICS = {"clip": ("total_loss", "contrastive_loss", "logit_scale"),
           "dino": ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale")}
OPTIM_KW = dict(lr=1e-3, head_lr=2e-3, text_lr=5e-4, logit_scale_lr=1e-2, eps=1e-3)


def _stacked_batch(with_dino: bool = True):
    """Two microbatches of 4 stacked on a leading axis, as the CLI groups
    ``--accum-freq 2`` loader batches."""
    n = ACCUM * MICRO
    size = CFG["vision_cfg"]["image_size"]
    flat = {"images": images(n, size, seed=16),
            "texts": token_ids(n, CFG["text_cfg"]["context_length"], seed=17)}
    if with_dino:
        flat["dino_features"] = np.random.default_rng(18).normal(
            size=(n, DINO_DIM)).astype(np.float32)
    return {k: v.reshape(ACCUM, MICRO, *v.shape[1:]) for k, v in flat.items()}


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["texts"] = out["texts"].long()
    return out


@pytest.mark.parametrize("loss", ["clip", "dino"])
def test_accumulated_step_matches_jax_make_train_step(loss):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build_model, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, build_optimizer as jax_build_optimizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr as jax_cos
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    dino = loss == "dino"
    step_kw = dict(loss_type=loss, accum_freq=ACCUM, log_grad_norm=True)
    _, variables = jax_clip(CFG)
    jmodel = jax_build_model(jax_parse(CFG), attn_impl="fused")
    params = {"model": variables["params"]}
    head_params = jhead = None
    if dino:
        jhead = JaxHead(dino_dim=DINO_DIM)
        head_params = jax.device_get(jhead.init(
            jax.random.PRNGKey(1), jnp.zeros((1, CFG["embed_dim"])))["params"])
        params["dino_head"] = head_params
    tx, _ = jax_build_optimizer(params, JaxOptimCfg(**OPTIM_KW), jax_cos(1e-3, 0, 2))
    jstate = create_train_state(jax.random.PRNGKey(0), variables["params"], tx, head_params)
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(dino=JaxLossCfg(**LOSS_KW[loss]), **step_kw),
                          head=jhead)

    model = build_model(parse_model_cfg(CFG), attn_impl="fused")
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    head = None
    if dino:
        head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
        head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**OPTIM_KW),
                                   scheduler.cosine_lr(1e-3, 0, 2))
    state = TrainState(model, head, opt)
    step = make_train_step(model, StepCfg(dino=DinoLossCfg(**LOSS_KW[loss]), **step_kw), head)

    batch = _stacked_batch(with_dino=dino)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, _torch(batch))
    for k in METRICS[loss]:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = jax_params_to_state_dict(jax.device_get(jstate.params["model"]))
    if dino:
        want.update({optim.HEAD_PREFIX + k: v for k, v in jax_head_params_to_state_dict(
            jax.device_get(jstate.params["dino_head"])).items()})
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape).numpy(),
                                   rtol=1e-5, atol=5e-6, err_msg=n)


def _grads(named):
    return {n: p.grad.detach().clone() for n, p in named.items()}


def test_accumulated_gradients_equal_the_big_batch():
    _, variables = jax_clip(CFG)
    model = build_model(parse_model_cfg(CFG))
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    torch.manual_seed(0)
    head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
    named = train_parameters(model, head)
    loss_fn = make_loss_fn(model, StepCfg(loss_type="dino", dino=DinoLossCfg(**LOSS_KW["dino"])),
                           head)
    batch = _torch(_stacked_batch())
    accumulate_grads(loss_fn, batch, 0, ACCUM)
    accumulated = _grads(named)
    for p in named.values():
        p.grad = None
    loss_fn({k: v.flatten(0, 1) for k, v in batch.items()}, 0)[0].backward()
    big = _grads(named)
    for n, g in big.items():
        want = ACCUM * g if n == "logit_scale" else g
        scale = float(want.abs().max())
        torch.testing.assert_close(accumulated[n], want, rtol=0, atol=1e-5 * scale + 1e-12,
                                   msg=n)


def test_live_teacher_runs_once_per_microbatch():
    _, tvars = jax_dinov2()
    teacher = LiveDinoTeacher(port_dinov2(tvars["params"]))
    calls = []
    extract = teacher.extract

    def counted(x):
        calls.append(tuple(x.shape))
        return extract(x)

    teacher.extract = counted
    model = build_model(parse_model_cfg(CFG))
    head = DinoProjectionHead(CFG["embed_dim"], teacher.hidden_size)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(lr=1e-3), scheduler.const_lr(1e-3, 0, 2))
    step = make_train_step(model, StepCfg(loss_type="dino", accum_freq=ACCUM,
                                          dino=DinoLossCfg(lambda_soft=0.5,
                                                           soft_mode="kl_teacher")),
                           head, dino_teacher=teacher)
    _, m = step(TrainState(model, head, opt), _torch(_stacked_batch(with_dino=False)))
    size = CFG["vision_cfg"]["image_size"]
    assert calls == [(MICRO, size, size, 3)] * ACCUM
    assert float(m["soft_loss"]) > 0 and np.isfinite(float(m["total_loss"]))
