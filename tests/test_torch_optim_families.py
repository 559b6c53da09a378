"""The ``--opt`` families, the bf16 first moment and the fused AdamW against
the JAX package's optax optimizers.

The tree: a CLIP with a 128-wide vision tower (``in_proj`` [384,128],
``c_fc`` [512,128] and the square ``out_proj`` [128,128] are factored by
adafactor; the patch kernel [128,3,8,8] is a 4-D leaf it does not factor),
a 32-wide text tower, 1-D LayerNorm and bias leaves, and the DINO head:
every group (heads, logit_scale, text, default) holds leaves. The JAX tree
is seeded and carried into the port with ``jax_params_to_state_dict``;
5 steps on the same seeded numpy gradients through optax
``build_optimizer`` (its update jitted, as the JAX train step runs it) and
the port's. Parameters within 1e-6 absolute: the two differ in summation
order and in the last bit of a few fp32 operations (XLA's rsqrt, its
reductions). With a bf16 first moment the rounding points are the same in
both (b1 rounded to bf16, the product in fp32, the sum stored in bf16), but
where the fp32 sum of one of them lands a last bit across a bf16 rounding
midpoint, the stored moments differ by one bf16 ulp (2^-8 of the moment),
which moves that element by up to lr * 2^-8 * |moment| in the next step: so
bf16 moments hold every element within 1e-5 and all but 1e-4 of them within
1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train.step import train_parameters
from .torch_port_utils import jax_clip, port_clip

CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 128, "layers": 1,
                   "head_width": 64},
    "text_cfg": {"context_length": 12, "vocab_size": 256, "width": 32, "heads": 4,
                 "layers": 1},
}
DINO_DIM = 24
ATOL = 1e-6
# (opt, mu_dtype, lock): every family with and without a bf16 first moment
# where it takes one (sgd ignores it, as optax.trace does), the reference
# CLI's timm/ spellings and aliases, and each family with towers locked
FAMILY_CASES = [
    ("adamw", None, "unlocked"), ("timm/adamw", "bfloat16", "locked"), ("lion", None, "locked"),
    ("timm/lion", "bfloat16", "unlocked"), ("timm/lamb", None, "locked"),
    ("adafactor", "bfloat16", "locked"), ("timm/adafactor", None, "unlocked"),
    ("momentum", "bfloat16", "locked"), ("sgdw", None, "unlocked"),
]
LOCKS = {"unlocked": {}, "locked": dict(lock_image=True, lock_image_unlocked_groups=1,
                                        lock_text=True, lock_text_unlocked_layers=1)}


@functools.lru_cache(maxsize=1)
def _jax_tree():
    """The seeded JAX train tree (numpy leaves), built once: the tests only
    read it (optax returns new trees)."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )

    _, variables = jax_clip(CFG, seed=0)
    head = jax.device_get(JaxHead(dino_dim=DINO_DIM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, CFG["embed_dim"])))["params"])
    return {"model": variables["params"], "dino_head": head}


def _trees():
    """(the JAX train tree, the port's parameters holding the same values)."""
    params = _jax_tree()
    head = params["dino_head"]
    model = port_clip(CFG, params["model"])
    port_head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
    port_head.load_state_dict(jax_head_params_to_state_dict(head), strict=True)
    return params, train_parameters(model, port_head)


def _to_port(tree):
    import jax

    out = jax_params_to_state_dict(jax.device_get(tree["model"]))
    out.update({optim.HEAD_PREFIX + k: v for k, v in
                jax_head_params_to_state_dict(jax.device_get(tree["dino_head"])).items()})
    return out


def _run_both(kw, jax_build_fn, port_build_fn, steps=5, seed=0):
    """Both optimizers over the same gradients; yields (step, port params,
    the JAX params in the port's layout, labels) after each step."""
    import jax
    import optax

    from refining_clip_via_dinov2_representations_tpu.train.optim import OptimCfg as JaxCfg
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr

    params, named = _trees()
    tx, _ = jax_build_fn(params, JaxCfg(**kw), cosine_lr(1e-3, 2, steps))
    opt_state = tx.init(params)
    # one compiled update: op by op, optax's first update takes seconds
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    opt, labels = port_build_fn(named, optim.OptimCfg(**kw), scheduler.cosine_lr(1e-3, 2, steps))
    rng = np.random.default_rng(seed)
    for step in range(steps):
        grads = jax.tree.map(lambda x: rng.normal(0, 0.1, np.shape(x)).astype(np.float32),
                             params)
        params, opt_state = update(grads, opt_state, params)
        g_sd = _to_port(grads)
        for n, p in named.items():
            p.grad = g_sd[n].reshape(p.shape).clone()  # logit_scale arrives as [1]
        opt.step(step)
        yield step, named, _to_port(params), labels, opt, opt_state


def _assert_params_match(step, named, want, labels, bf16_moment=False):
    if not bf16_moment:
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape).numpy(),
                                       atol=ATOL, rtol=0, err_msg=f"step {step} {n} ({labels[n]})")
        return
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].reshape(p.shape).numpy()).ravel()
                            for n, p in named.items()])
    assert diffs.max() <= 10 * ATOL, (step, diffs.max())
    assert (diffs > ATOL).mean() <= 1e-4, (step, int((diffs > ATOL).sum()), diffs.size)


@pytest.mark.parametrize("opt,mu,lock", FAMILY_CASES,
                         ids=[f"{o}-{m or 'fp32'}-{lk}" for o, m, lk in FAMILY_CASES])
def test_family_matches_optax_for_5_steps(opt, mu, lock):
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        build_optimizer as jax_build,
    )

    kw = dict(lr=1e-3, opt=opt, mu_dtype=mu, wd=0.1, **LOCKS[lock])
    start = {n: p.detach().clone() for n, p in _trees()[1].items()}
    bf16_moment = mu is not None and optim.optimizer_family(optim.OptimCfg(**kw)) != "sgd"
    for step, named, want, labels, opt_, _ in _run_both(kw, jax_build, optim.build_optimizer):
        _assert_params_match(step, named, want, labels, bf16_moment)
    assert set(labels.values()) >= {"heads", "logit_scale", "text"}
    frozen = [n for n, lbl in labels.items() if lbl == "frozen"]
    assert bool(frozen) == (lock == "locked")
    for n in frozen:  # in no group: neither moved nor decayed
        torch.testing.assert_close(named[n].detach(), start[n], atol=0, rtol=0)
    moments = [s["mu"] for s in opt_.state.values()]
    assert {m.dtype for m in moments} == {torch.bfloat16 if bf16_moment else torch.float32}


def test_adafactor_factors_the_shapes_optax_factors():
    """After 5 steps (one group, wd 0.1), the port's statistics hold optax's
    shapes and values: a tensor is factored where optax factors its JAX
    twin; the row statistic of a non-square weight is the same vector in
    both layouts, and a square weight's row and column statistics swap (its
    JAX kernel is the transpose)."""
    import jax
    from optax._src.factorized import FactoredState

    from refining_clip_via_dinov2_representations_tpu.train.optim import make_inner_optimizer

    def jax_single_group(params, cfg, schedule):
        return make_inner_optimizer(cfg, schedule, cfg.wd), None

    def port_single_group(named, cfg, schedule):
        labels = {n: "default" for n in named}
        return optim.GroupOptimizer(named, labels, cfg, schedule, cfg.lr), labels

    kw = dict(lr=1e-3, opt="adafactor", mu_dtype="bfloat16", wd=0.1, use_param_groups=False)
    step, named, want, labels, port_opt, state = list(
        _run_both(kw, jax_single_group, port_single_group))[-1]
    _assert_params_match(step, named, want, labels, bf16_moment=True)
    params, _ = _trees()
    fs = jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, FactoredState))
    fs = [x for x in fs if isinstance(x, FactoredState)][0]
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    jax_rows, jax_cols = flat(fs.v_row), flat(fs.v_col)
    jax_params = flat(params)

    n_factored = n_square = 0
    for path, leaf in jax_params.items():
        name = jax.tree_util.keystr(path)
        factored = optim.factored_dims(leaf.shape) is not None
        assert (jax_rows[path].shape != (1,)) == factored or leaf.shape == (1,), name
        if not factored:
            continue
        n_factored += 1
        jr, jc = np.asarray(jax_rows[path]), np.asarray(jax_cols[path])
        # the port's twin of this leaf: the only parameter of the same
        # element count and the same set of dims whose name ends alike
        twins = [n for n, p in port_opt.state.items() if "v_row" in p
                 and named[n].numel() == leaf.size
                 and sorted(named[n].shape) == sorted(leaf.shape)
                 and n.split(".")[-1].replace("weight", "") in name.replace("kernel", "")]
        matches = 0
        for n in twins:
            pr = port_opt.state[n]["v_row"].numpy()
            pc = port_opt.state[n]["v_col"].numpy()
            assert {pr.shape, pc.shape} == {jr.shape, jc.shape}
            square = leaf.shape[0] == leaf.shape[1]
            a, b = (jc, jr) if square else (jr, jc)
            if np.allclose(pr, a, rtol=1e-5, atol=0) and np.allclose(pc, b, rtol=1e-5, atol=0):
                matches += 1
                n_square += square
        assert matches >= 1, name
    assert n_factored >= 4 and n_square >= 1


def test_fused_adamw_matches_the_jax_fused_optimizer():
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        build_fused_optimizer as jax_fused,
    )

    kw = dict(lr=1e-3, wd=0.1, lock_image=True, lock_image_unlocked_groups=1)
    for step, named, want, labels, opt, _ in _run_both(kw, jax_fused,
                                                       optim.build_fused_optimizer):
        _assert_params_match(step, named, want, labels)
    assert opt.count == 5 and all(st["m"].dtype == torch.float32 and st["m"].dim() == 1
                                  for st in opt.groups.values())
    assert "frozen" not in opt.groups


@pytest.mark.parametrize("kw,match", [
    (dict(opt="lamb", mu_dtype="bfloat16"), "not supported with --opt lamb"),
    (dict(opt="timm/lamb", mu_dtype="bfloat16"), "not supported with --opt lamb"),
    (dict(opt="adamax"), "unknown --opt"),
    (dict(opt="timm/rmsprop"), "unknown --opt"),
])
def test_errors_as_in_jax(kw, match):
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxCfg,
        make_inner_optimizer,
    )

    with pytest.raises(ValueError, match=match):
        make_inner_optimizer(JaxCfg(**kw), 1e-3, 0.0)
    with pytest.raises(ValueError, match=match):
        optim.build_optimizer({}, optim.OptimCfg(**kw), scheduler.const_lr(1e-3, 0, 1))


def test_names_resolve_as_in_jax():
    for name, family in (("adamw", "adamw"), ("timm/AdamW", "adamw"), (" lion ", "lion"),
                         ("timm/lamb", "lamb"), ("adafactor", "adafactor"), ("sgd", "sgd"),
                         ("timm/sgdw", "sgd"), ("momentum", "sgd"), (None, "adamw")):
        assert optim.optimizer_family(optim.OptimCfg(opt=name)) == family


def test_fused_rejects_other_families():
    with pytest.raises(ValueError, match="AdamW only"):
        optim.build_fused_optimizer({}, optim.OptimCfg(opt="lion"), scheduler.const_lr(1e-3, 0, 1))
