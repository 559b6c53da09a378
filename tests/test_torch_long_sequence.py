"""The long-sequence training slice against the JAX package, on the CPU.

A small config with ViT-L-14-336's vision grid (336 px, patch 14: 577
tokens, head dim 64) at width 128, 2 layers, so the vision attention opens
the flash gate (Lq >= 512) while the 12-token text tower takes the plain
path. The port runs ``attn_impl="flash"`` (on the CPU: the flash kernel's
plain version, through its autograd Function); the JAX model runs its plain
attention, which is what its flash dispatch runs off the TPU. Tolerances:
features 1e-5 (fp32); the train step at ``tests/test_torch_train_step.py``'s
fp32 tolerances (loss 1e-5 relative, gradient norm 1e-4, parameters 5e-6
absolute).
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import DinoLossCfg, DinoProjectionHead
from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    jax_params_to_state_dict,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.ops import flash_attention as flash_ops
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    make_train_step,
    train_parameters,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

LONG = "long-seq-torch-test"
LONG_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 336, "patch_size": 14, "width": 128, "layers": 2,
                   "head_width": 64},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 2,
                 "layers": 2},
}
TINY = "tiny-long-seq-torch-test"
register_model_config(LONG, LONG_CFG)
register_model_config(TINY, TINY_CFG)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the flash kernel's plain-version calls (the CPU's launches)."""
    calls = []
    plain = flash_ops.flash_attention_reference

    def counted(q, *args):
        calls.append(tuple(q.shape))
        return plain(q, *args)

    monkeypatch.setattr(flash_ops, "flash_attention_reference", counted)
    return calls


def test_577_token_clip_through_flash_matches_jax(flash_calls):
    import jax.numpy as jnp

    jmodel, variables = jax_clip(LONG_CFG, attn_impl="xla", seed=5)
    model = port_clip(LONG_CFG, variables["params"], attn_impl="flash")
    img, txt = images(2, 336, seed=5), token_ids(2, 12, seed=5)
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(txt))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(txt))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    assert flash_calls == [(2, 2, 577, 64)] * 2  # the vision layers only


def test_grad_checkpointed_train_step_matches_jax(flash_calls):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        create_model as jax_create_model,
    )
    from refining_clip_via_dinov2_representations_tpu.models.config import (
        register_model_config as jax_register,
    )
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, build_optimizer as jax_build_optimizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr as jax_cos
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    b, dino_dim, lr = 4, 24, 1e-3
    loss_kw = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
    step_kw = dict(loss_type="dino", log_grad_norm=True)
    # eps 1e-3: the attention key biases' exact gradient is 0 (see test_torch_train_step)
    optim_kw = dict(lr=lr, head_lr=2 * lr, text_lr=lr / 2, logit_scale_lr=1e-2, eps=1e-3)

    jax_register(LONG, LONG_CFG)
    jmodel, _, _ = jax_create_model(LONG, attn_impl="flash", grad_checkpointing=True,
                                    init_params=False)
    _, variables = jax_clip(LONG_CFG, seed=6)
    head_params = jax.device_get(JaxHead(dino_dim=dino_dim).init(
        jax.random.PRNGKey(1), jnp.zeros((1, LONG_CFG["embed_dim"])))["params"])
    params = {"model": variables["params"], "dino_head": head_params}
    tx, _ = jax_build_optimizer(params, JaxOptimCfg(**optim_kw), jax_cos(lr, 0, 2))
    jstate = create_train_state(jax.random.PRNGKey(0), variables["params"], tx, head_params)
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(dino=JaxLossCfg(**loss_kw), **step_kw),
                          head=JaxHead(dino_dim=dino_dim))

    model, _ = create_model(LONG, device="cpu", attn_impl="flash", grad_checkpointing=True)
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    model.train()
    assert model.visual.transformer.grad_checkpointing and model.transformer.grad_checkpointing
    head = DinoProjectionHead(LONG_CFG["embed_dim"], dino_dim)
    head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**optim_kw),
                                   scheduler.cosine_lr(lr, 0, 2))
    step = make_train_step(model, StepCfg(dino=DinoLossCfg(**loss_kw), **step_kw), head)

    rng = np.random.default_rng(8)
    batch = {"images": images(b, 336, seed=9), "texts": token_ids(b, 12, seed=10),
             "dino_features": rng.normal(size=(b, dino_dim)).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["texts"] = tbatch["texts"].long()
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m = step(TrainState(model, head, opt), tbatch)

    # the flash forward ran twice per vision layer: the forward and the recompute
    assert flash_calls == [(b, 2, 577, 64)] * 4
    for k in ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = jax_params_to_state_dict(jax.device_get(jstate.params["model"]))
    want.update({optim.HEAD_PREFIX + k: v for k, v in jax_head_params_to_state_dict(
        jax.device_get(jstate.params["dino_head"])).items()})
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape).numpy(),
                                   atol=5e-6, rtol=0, err_msg=n)


def test_checkpointing_changes_no_gradient():
    """The same step with and without grad checkpointing: equal gradients
    (the recompute repeats the forward's arithmetic)."""
    grads = []
    for remat in (False, True):
        model, _ = create_model(LONG, device="cpu", attn_impl="flash", seed=3)
        model.set_grad_checkpointing(remat)
        model.train()
        out = model(torch.from_numpy(images(2, 336, seed=11)),
                    torch.from_numpy(token_ids(2, 12, seed=12)))
        (out["image_features"] @ out["text_features"].t()).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=0, rtol=0, msg=n)


def test_force_image_size_matches_jax_factory():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        create_model as jax_create_model,
    )

    jmodel, _, jpp = jax_create_model("ViT-B-16", force_image_size=384, init_params=False)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 384, 384, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    want_pos = shapes["params"]["visual"]["positional_embedding"].shape
    model, pp = create_model("ViT-B-16", device="cpu", force_image_size=384)
    assert tuple(model.visual.positional_embedding.shape) == tuple(want_pos) == (577, 768)
    assert pp.size == jpp.size and model.visual.image_size == (384, 384)


def test_checkpoint_of_another_grid_raises(tmp_path):
    model, _ = create_model(TINY, device="cpu")
    path = tmp_path / "tiny.pt"
    torch.save(model.state_dict(), path)
    with pytest.raises(NotImplementedError, match="resizing is not ported"):
        create_model(TINY, str(path), device="cpu", force_image_size=32)
    create_model(TINY, str(path), device="cpu", force_image_size=16)  # same grid loads
