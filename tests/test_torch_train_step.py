"""Three train steps of a tiny CLIP with the DINO head: the JAX package's
``make_train_step`` (no mesh; attention through the interpreted Pallas
kernels, forward and backward) against the port's step, from one init
carried across with the converters and on the same seeded random batch.
The loss has the soft KL and the weighted CE, lambda_soft warms up over 2
steps, and the logit scale starts above ln 100 so the clamp acts.

AdamW runs with eps 1e-3 here: the attention key biases have an exact
gradient of 0 (softmax ignores a per-row constant), so their computed
gradients are rounding noise, which AdamW at eps 1e-6 would scale up to a
full +-lr step of random sign in each framework.

Tolerances. fp32: the losses at 1e-5 relative, the gradient norm at 1e-4,
every parameter after each step at 5e-6 absolute (lr 1e-3). bf16 compute:
the losses at 2e-2 relative and the gradient norm at 5e-2 (the towers
round activations to bf16 at other places and in another order in the two
frameworks, and the soft term divides similarities by a temperature of
0.02); the parameters' change since the init, all tensors together, at a
cosine of at least 0.99 with JAX's (elementwise, a weight whose gradient
is near 0 can step the other way).
"""

import math

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
from refining_clip_via_dinov2_representations_torch.train.step import (
    LN100,
    StepCfg,
    TrainState,
    make_train_step,
    train_parameters,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, token_ids

B, DINO_DIM = 8, 24
CASES = {
    # weighted CE, lambda_soft warm-up over 2 steps, and a logit scale that
    # starts above ln 100 so the clamp acts after the first update
    "fp32": dict(dtype="float32", lr=1e-3, loss_rtol=1e-5, norm_rtol=1e-4, param_atol=5e-6),
    "bf16": dict(dtype="bfloat16", lr=1e-4, loss_rtol=2e-2, norm_rtol=5e-2,
                 min_update_cosine=0.99),
}


def _batch():
    rng = np.random.default_rng(5)
    size = TINY_CFG["vision_cfg"]["image_size"]
    return {"images": images(B, size, seed=6),
            "texts": token_ids(B, TINY_CFG["text_cfg"]["context_length"], seed=7),
            "dino_features": rng.normal(size=(B, DINO_DIM)).astype(np.float32)}


def _state_dict(params):
    import jax

    sd = jax_params_to_state_dict(jax.device_get(params["model"]))
    sd.update({optim.HEAD_PREFIX + k: v for k, v in
               jax_head_params_to_state_dict(jax.device_get(params["dino_head"])).items()})
    return sd


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax_make_train_step(case):
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

    c = CASES[case]
    loss_kw = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
    step_kw = dict(loss_type="dino", enable_warmup_dino_hyperparams=True, warmup=2,
                   log_grad_norm=True)
    lr = c["lr"]
    optim_kw = dict(lr=lr, head_lr=2 * lr, text_lr=lr / 2, logit_scale_lr=1e-2, eps=1e-3)

    _, variables = jax_clip(TINY_CFG)
    variables["params"]["logit_scale"] = np.asarray(4.7, np.float32)
    jmodel = jax_build_model(jax_parse(TINY_CFG), dtype=getattr(jnp, c["dtype"]),
                             attn_impl="fused")
    head_params = jax.device_get(JaxHead(dino_dim=DINO_DIM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, TINY_CFG["embed_dim"])))["params"])
    params = {"model": variables["params"], "dino_head": head_params}
    tx, _ = jax_build_optimizer(params, JaxOptimCfg(**optim_kw), jax_cos(lr, 0, 3))
    jstate = create_train_state(jax.random.PRNGKey(0), variables["params"], tx, head_params)
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(dino=JaxLossCfg(**loss_kw), **step_kw),
                          head=JaxHead(dino_dim=DINO_DIM))

    model = build_model(parse_model_cfg(TINY_CFG), dtype=getattr(torch, c["dtype"]),
                        attn_impl="fused")
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    head = DinoProjectionHead(TINY_CFG["embed_dim"], DINO_DIM)
    head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    named = train_parameters(model, head)
    start = {n: p.detach().clone() for n, p in named.items()}
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**optim_kw),
                                   scheduler.cosine_lr(lr, 0, 3))
    state = TrainState(model, head, opt)
    step = make_train_step(model, StepCfg(dino=DinoLossCfg(**loss_kw), **step_kw), head)

    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["texts"] = tbatch["texts"].long()
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, tbatch)
        assert state.step == i + 1
        for k in ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=c["loss_rtol"],
                                       atol=1e-7, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=c["norm_rtol"])
        # the warm-up: total = classic + (i / 2) * 0.5 * soft + 0.3 * weighted
        frac = min(1.0, i / 2)
        np.testing.assert_allclose(
            float(m["total_loss"]),
            float(m["classic_loss"]) + frac * 0.5 * float(m["soft_loss"])
            + 0.3 * float(m["weighted_loss"]), rtol=1e-6)
        if i == 0:  # the logit scale started at 4.7 > ln 100: clamped after the update
            assert float(model.logit_scale.detach()) == pytest.approx(LN100, abs=1e-6)
            assert math.isclose(float(jstate.params["model"]["logit_scale"]), LN100,
                                abs_tol=1e-6)
        want = _state_dict(jstate.params)
        got_moves, want_moves = [], []
        for n, p in named.items():
            assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
            w = want[n].reshape(p.shape)
            if "param_atol" in c:
                np.testing.assert_allclose(p.detach().numpy(), w.numpy(), atol=c["param_atol"],
                                           rtol=0, err_msg=f"step {i} {n}")
            else:  # bf16: the change since the init
                got_moves.append((p.detach() - start[n]).flatten())
                want_moves.append((w - start[n]).flatten())
        if got_moves:
            a, b = torch.cat(got_moves).double(), torch.cat(want_moves).double()
            cosine = float((a @ b) / (a.norm() * b.norm()))
            assert cosine >= c["min_update_cosine"], (i, cosine)


def test_unported_step_options_raise():
    # patch dropout, every loss type and device preprocessing are ported
    # (tests/test_torch_patch_dropout.py, tests/test_torch_dist_losses.py,
    # tests/test_torch_coca_train.py, tests/test_torch_loss_zoo_step.py,
    # tests/test_torch_device_preprocess_step.py); an unknown loss type and a
    # device_preprocess that is not (out_h, out_w, mean, std) are refused
    StepCfg(device_preprocess=(224, 224, (0.5,) * 3, (0.5,) * 3))
    with pytest.raises(ValueError, match="out_h, out_w, mean, std"):
        StepCfg(device_preprocess=(224, 224))
    with pytest.raises(ValueError, match="loss_type"):
        StepCfg(loss_type="triplet")
    with pytest.raises(ValueError, match="dist_model"):
        make_train_step(torch.nn.Linear(1, 1), StepCfg(loss_type="distill"))
