"""The ``"cyclip"`` and ``"distill"`` train steps and their CLI flags.

* Against the JAX package: one step of ``make_train_step`` for each loss on
  a tiny student (and, for ``"distill"``, a tiny frozen CLIP teacher of
  other widths; attention through the interpreted Pallas kernels), the JAX
  step's optimizer an optax transformation that keeps the gradients it is
  given as its state and updates nothing, the port's step at lr 0; the
  loss and every metric at 1e-5 relative, every gradient within 1e-5 of
  its largest magnitude (fp32).
* Distillation under accumulation: the port's accumulated gradients over
  two microbatches equal one step's over the big batch (the logit scale's
  twice, as for the other losses), and the teacher runs once a microbatch.
* The CLI: ``--use_CyClip`` and ``--distill-model/--distill-pretrained``
  (a teacher file) train a few steps on synthetic data; the teacher takes
  no gradient and is in no checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model, parse_model_cfg, register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.main import main
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg, TrainState, accumulate_grads, make_loss_fn, make_train_step, train_parameters,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

B = 6
# one layer a tower: the JAX step's compile with the interpreted kernels
STUDENT = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "layers": 1},
           "text_cfg": {**TINY_CFG["text_cfg"], "layers": 1}}
TEACHER = {"embed_dim": 24,
           "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 48, "layers": 1,
                          "head_width": 16},
           "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 48, "heads": 3,
                        "layers": 1}}
METRICS = {"cyclip": ("total_loss", "clip_loss", "inmodal_cyclic", "crossmodal_cyclic",
                      "logit_scale"),
           "distill": ("total_loss", "contrastive_loss", "distill_loss", "logit_scale")}
STEP_KW = {"cyclip": dict(lambda_cyc_inmodal=0.4, lambda_cyc_crossmodal=0.7), "distill": {}}


def _batch(n: int = B):
    size = STUDENT["vision_cfg"]["image_size"]
    return {"images": images(n, size, seed=21),
            "texts": token_ids(n, STUDENT["text_cfg"]["context_length"], seed=22)}


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["texts"] = out["texts"].long()
    return out


def _keep_grads():
    """An optax transformation that updates nothing and keeps the gradients
    as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates), updates))


@pytest.mark.parametrize("loss", ["cyclip", "distill"])
def test_step_matches_jax_make_train_step(loss):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    jmodel, variables = jax_clip(STUDENT, seed=4)
    jteacher = tvars = teacher = None
    if loss == "distill":
        jteacher, tvars = jax_clip(TEACHER, seed=5)
        teacher = port_clip(TEACHER, tvars["params"], attn_impl="fused").requires_grad_(False)
    tx = _keep_grads()
    jstate = create_train_state(jax.random.PRNGKey(0), variables["params"], tx)
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(loss_type=loss, **STEP_KW[loss]),
                          dist_model=jteacher, dist_variables=tvars)
    batch = _batch()
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax_params_to_state_dict(jax.device_get(jstate.opt_state["model"]))

    model = port_clip(STUDENT, variables["params"], attn_impl="fused").train()
    named = train_parameters(model, None)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(lr=0.0), scheduler.const_lr(0.0, 0, 1))
    step = make_train_step(model, StepCfg(loss_type=loss, **STEP_KW[loss]), dist_model=teacher)
    _, m = step(TrainState(model, None, opt), _torch(batch))
    assert sorted(m) == sorted(jm)
    for k in METRICS[loss]:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m["total_loss"]),
                               sum(float(m[k]) for k in METRICS[loss][1:-1]) if loss == "distill"
                               else float(m["clip_loss"]) + 0.4 * float(m["inmodal_cyclic"])
                               + 0.7 * float(m["crossmodal_cyclic"]), rtol=1e-6)
    for n, p in named.items():
        want = jgrads[n].reshape(p.shape)
        tol = 1e-5 * float(want.abs().max()) + 1e-12
        torch.testing.assert_close(p.grad, want, rtol=0, atol=tol, msg=n)
    if teacher is not None:
        assert all(p.grad is None for p in teacher.parameters())


def _counted(teacher):
    calls = []
    forward = teacher.forward

    def counted(images, texts, *args, **kwargs):
        calls.append(tuple(images.shape))
        return forward(images, texts, *args, **kwargs)

    teacher.forward = counted
    return calls


def test_accumulated_distill_step_equals_one_step_and_runs_the_teacher_once_a_microbatch():
    _, variables = jax_clip(STUDENT, seed=4)
    _, tvars = jax_clip(TEACHER, seed=5)
    model = port_clip(STUDENT, variables["params"]).train()
    teacher = port_clip(TEACHER, tvars["params"]).requires_grad_(False)
    calls = _counted(teacher)
    named = train_parameters(model, None)
    loss_fn = make_loss_fn(model, StepCfg(loss_type="distill"), dist_model=teacher)
    flat = _torch(_batch(8))
    stacked = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in flat.items()}
    metrics = accumulate_grads(loss_fn, stacked, 0, 2)
    assert calls == [(4, 16, 16, 3)] * 2  # phase 1 only
    accumulated = {n: p.grad.clone() for n, p in named.items()}
    for p in named.values():
        p.grad = None
    loss, big_metrics = loss_fn(flat, 0)
    loss.backward()
    np.testing.assert_allclose(float(metrics["total_loss"]), float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["distill_loss"]), float(big_metrics["distill_loss"]),
                               rtol=1e-6)
    for n, p in named.items():
        want = 2 * p.grad if n == "logit_scale" else p.grad
        tol = 1e-5 * float(want.abs().max()) + 1e-12
        torch.testing.assert_close(accumulated[n], want, rtol=0, atol=tol, msg=n)


STUDENT_NAME, TEACHER_NAME = "tiny-torch-zoo-student", "tiny-torch-zoo-teacher"
register_model_config(STUDENT_NAME, TINY_CFG)
register_model_config(TEACHER_NAME, TEACHER)


def _argv(tmp_path, *extra):
    return ["--model", STUDENT_NAME, "--dataset-type", "synthetic", "--train-num-samples", "12",
            "--batch-size", "4", "--epochs", "1", "--workers", "1", "--logs", str(tmp_path),
            "--name", "run", "--precision", "fp32", "--force-cpu", "--log-every-n-steps", "1",
            *extra]


@pytest.mark.parametrize("flags", [["--use_CyClip", "--lambda_cyc_inmodal", "0.5"],
                                   ["--distill-model", TEACHER_NAME, "--distill-pretrained",
                                    "TEACHER_FILE"]])
def test_cli_trains_with_the_loss(tmp_path, flags):
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    if "TEACHER_FILE" in flags:
        teacher = build_model(parse_model_cfg(TEACHER), seed=9)
        path = os.path.join(tmp_path, "teacher.pt")
        torch.save(teacher.state_dict(), path)
        flags = [path if f == "TEACHER_FILE" else f for f in flags]
    records = main(_argv(tmp_path, *flags))
    assert len(records) == 3
    keys = ("clip_loss", "inmodal_cyclic") if "--use_CyClip" in flags else (
        "contrastive_loss", "distill_loss")
    for r in records:
        assert np.isfinite(r["total_loss"]) and all(k in r for k in keys)
    ckpt = torch.load(os.path.join(tmp_path, "run", "checkpoints", "final_torch_state.pt"),
                      weights_only=False)
    student = build_model(parse_model_cfg(TINY_CFG))
    student.load_state_dict(ckpt["state_dict"], strict=True)  # no teacher tensors in it
    # the distillation flags take precedence over every other loss, as in JAX
    from refining_clip_via_dinov2_representations_torch.train.main import resolve_loss_type

    both = parse_args(["--model", "coca_ViT-B-32", "--distill-model", "x", "--distill-pretrained",
                       "y", "--siglip", "--use_CyClip"])
    assert resolve_loss_type(both) == "distill"
    both.distill_pretrained = None
    assert resolve_loss_type(both) == "coca"
