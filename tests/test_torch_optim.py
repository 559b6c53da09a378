"""The port's param groups, schedules and AdamW against the JAX package.

* Labels, leaf for leaf at ViT-B-16: the JAX parameter tree comes from
  ``jax.eval_shape`` (no compute); every leaf is replaced by a one-element
  array holding its own index and carried through the port's converters,
  so each port parameter name finds the JAX leaf it came from.
* Schedules: every step of 50 against the JAX schedule (fp32 there, so
  1e-6 relative plus 1e-10 absolute: one fp32 ulp of 5e-4 is 6e-11).
* AdamW: 5 steps on seeded gradients, optax ``build_optimizer`` against the
  port's; parameters at 1e-6 absolute (float rounding in the update order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead
from refining_clip_via_dinov2_representations_torch.models import get_model_config, parse_model_cfg
from refining_clip_via_dinov2_representations_torch.models.clip import CLIP
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.step import train_parameters
from .torch_port_utils import TINY_CFG, jax_clip, port_clip

LABEL_CASES = {
    "default": {},
    "lock_image": dict(lock_image=True),
    "lock_image_unlocked_2": dict(lock_image=True, lock_image_unlocked_groups=2),
    "lock_text_unlocked_2": dict(lock_text=True, lock_text_unlocked_layers=2),
    "freeze_projection": dict(freeze_projection=True),
}


def _jax_vitb16_tree():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model, get_model_config as jax_get_config, parse_model_cfg as jax_parse,
    )

    model = build_model(jax_parse(jax_get_config("ViT-B-16")))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, key, jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 77), jnp.int32))["params"]
    head = jax.eval_shape(JaxHead(dino_dim=384).init, key, jnp.zeros((1, 512)))["params"]
    return {"model": shapes, "dino_head": head}


@pytest.fixture(scope="module")
def vitb16():
    import jax

    tree = _jax_vitb16_tree()
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    index_tree = jax.tree_util.tree_unflatten(
        treedef, [np.full((1,) * len(x.shape), i, np.float32) for i, x in enumerate(leaves)])
    index_of = {k: int(v.flatten()[0]) for k, v in jax_params_to_state_dict(index_tree["model"]).items()}
    index_of.update({optim.HEAD_PREFIX + k: int(v.flatten()[0])
                     for k, v in jax_head_params_to_state_dict(index_tree["dino_head"]).items()})
    with torch.device("meta"):
        cfg = parse_model_cfg(get_model_config("ViT-B-16"))
        model = CLIP(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg)
        head = DinoProjectionHead(512, 384)
    names = list(train_parameters(model, head))
    return tree, treedef, index_of, names


@pytest.mark.parametrize("case", list(LABEL_CASES))
def test_labels_match_jax_leaf_for_leaf_at_vit_b16(vitb16, case):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxCfg,
        label_params as jax_labels,
    )

    tree, treedef, index_of, names = vitb16
    assert sorted(names) == sorted(index_of)  # every port parameter is one JAX leaf
    want = jax.tree_util.tree_leaves(jax_labels(tree, JaxCfg(**LABEL_CASES[case])))
    assert len(want) == len(names) == treedef.num_leaves
    got = optim.label_params(names, optim.OptimCfg(**LABEL_CASES[case]))
    mismatched = {n: (got[n], want[index_of[n]]) for n in names if got[n] != want[index_of[n]]}
    assert not mismatched
    assert set(got.values()) >= {"heads", "default", "text"} - (
        {"default"} if case == "lock_image" else set())


SCHEDULES = [
    ("cosine", dict(lr_scheduler="cosine", warmup=10, lr_min=1e-5)),
    ("cosine_no_warmup", dict(lr_scheduler="cosine", warmup=0, lr_min=0.0)),
    ("const", dict(lr_scheduler="const", warmup=7)),
    ("const-cooldown", dict(lr_scheduler="const-cooldown", warmup=5, epochs_cooldown=2, epochs=5,
                            lr_cooldown_power=2.0, lr_cooldown_end=1e-5)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax_for_50_steps(name, kw):
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import (
        make_schedule as jax_make,
    )

    args = SimpleNamespace(**kw)
    want = jax_make(args, 5e-4, 50, steps_per_epoch=10)
    got = scheduler.make_schedule(args, 5e-4, 50, steps_per_epoch=10)
    for step in range(50):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-10,
                                   err_msg=f"step {step}")


ADAMW_CASES = {
    "default_groups": dict(lr=1e-3),
    "clip_with_lock": dict(lr=1e-3, lock_image=True, lock_image_unlocked_groups=1,
                           grad_clip_norm=0.5),
    "flatten_group_lrs": dict(lr=1e-3, flatten_group_lrs=True, wd=0.1),
    "lock_text_no_param_groups": dict(lr=1e-3, lock_text=True, use_param_groups=False),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_matches_optax_for_5_steps(case):
    import jax
    import jax.numpy as jnp
    import optax

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxCfg,
        build_optimizer as jax_build,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr as jax_cos

    kw = ADAMW_CASES[case]
    _, variables = jax_clip(TINY_CFG)
    head_params = jax.device_get(JaxHead(dino_dim=24).init(
        jax.random.PRNGKey(1), jnp.zeros((1, TINY_CFG["embed_dim"])))["params"])
    params = {"model": variables["params"], "dino_head": head_params}
    tx, _ = jax_build(params, JaxCfg(**kw), jax_cos(1e-3, 2, 5))
    opt_state = tx.init(params)

    model = port_clip(TINY_CFG, variables["params"])
    head = DinoProjectionHead(TINY_CFG["embed_dim"], 24)
    head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    named = train_parameters(model, head)
    opt, labels = optim.build_optimizer(named, optim.OptimCfg(**kw), scheduler.cosine_lr(1e-3, 2, 5))

    rng = np.random.default_rng(0)
    for step in range(5):
        grads = jax.tree.map(lambda x: rng.normal(0, 0.1, np.shape(x)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g_sd = jax_params_to_state_dict(grads["model"])
        g_sd.update({optim.HEAD_PREFIX + k: v
                     for k, v in jax_head_params_to_state_dict(grads["dino_head"]).items()})
        for n, p in named.items():
            p.grad = g_sd[n].reshape(p.shape).clone()  # logit_scale arrives as [1]
        opt.step(step)

        want = jax_params_to_state_dict(jax.device_get(params["model"]))
        want.update({optim.HEAD_PREFIX + k: v for k, v in
                     jax_head_params_to_state_dict(jax.device_get(params["dino_head"])).items()})
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {n} ({labels[n]})")
    frozen = [n for n, lbl in labels.items() if lbl == "frozen"]
    assert bool(frozen) == ("lock" in case)


def test_unported_optimizers_raise():
    with pytest.raises(NotImplementedError):
        optim.build_optimizer({}, optim.OptimCfg(opt="lion"), scheduler.const_lr(1e-3, 0, 1))
    with pytest.raises(NotImplementedError):
        optim.build_fused_optimizer()
