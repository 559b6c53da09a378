"""The port's DINO-soft train step on a ``(data, model)`` mesh against the
JAX ``make_train_step`` on the same mesh shapes.

Two gloo ranks form a ``(1, 2)`` mesh and four a ``(2, 2)`` one; the JAX
step runs on ``conftest.py``'s forced host devices with ``"xla"``
attention (the Pallas kernels' plain reference), its parameters split over
the model axis by ``_param_spec`` (``state_shardings(state, mesh)``). Not
over the data axis as well: on the ``(2, 2)`` mesh a parameter placed over
both axes changes the JAX step's gradient, though not its loss (FSDP from
the first step, ``grad_norm`` 83.835 against 74.345; ZeRO-1 from the
second, whose updated parameters leave the step with their moments' data
placement, 62.347 against 53.152; the replicated placement and the
``(2, 1)`` mesh agree with the TP one; ROADMAP Queue 3,
``scripts/jax_tp_placement_grads.py``). The port's ZeRO-1
and FSDP routes are held to the placement that agrees. One seeded
init, made in the port and perturbed, crosses to
JAX through ``convert_clip_state_dict``; the results come back through
``jax_params_to_state_dict``. The port runs each route on the same rows
(data rank ``r`` takes the JAX data shard ``r``): replicated optimizer
state and ZeRO-1 at both shapes, FSDP at ``(2, 2)``, two AdamW steps with
global-norm clipping, and the live DINOv2 teacher of
``dryrun_multichip``'s tiny config (24 wide, 2 heads, patch 16), split over
the model group, at ``(1, 2)``. Losses and metrics at 1e-5 relative,
``grad_norm`` at 1e-4; every parameter, gathered whole, after each step at
1e-5 relative and 5e-6 absolute (lr 1e-3, AdamW eps 1e-3, as
``tests/test_torch_dist_step.py``).
"""

import numpy as np
import pytest

from .torch_dist_utils import run_ranks
from .torch_port_utils import images, token_ids

B, DINO_DIM, STEPS = 4, 24, 2
CFG = {"embed_dim": 32,
       "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 32, "layers": 1,
                      "head_width": 16},
       "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                    "layers": 1}}
TEACHER = dict(hidden_size=24, layers=2, heads=2, patch_size=16, native_image_size=32)
LOSS_KW = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
OPTIM_KW = dict(lr=1e-3, head_lr=2e-3, text_lr=5e-4, logit_scale_lr=1e-2, eps=1e-3,
                grad_clip_norm=0.05)
METRICS = ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale")
RUNS = {(1, 2): ("replicated", "zero1", "teacher"), (2, 2): ("replicated", "zero1", "fsdp")}


def _inputs():
    """The seeded, perturbed port init (model, head, teacher) and each mesh's
    global batches; numpy only."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead
    from refining_clip_via_dinov2_representations_torch.models import (
        Dinov2, Dinov2Cfg, build_model, parse_model_cfg,
    )

    rng = np.random.default_rng(0)

    def perturbed(module):
        return {k: v.numpy() + rng.normal(0.0, 0.02, v.shape).astype(np.float32)
                for k, v in module.state_dict().items()}

    sd = perturbed(build_model(parse_model_cfg(CFG), seed=2))
    sd["logit_scale"] = np.float32(np.log(1 / 0.07))
    torch.manual_seed(3)
    head = perturbed(DinoProjectionHead(CFG["embed_dim"], DINO_DIM))
    teacher = perturbed(Dinov2(Dinov2Cfg(**TEACHER)).init_weights(4))
    batches = {}
    for data, _ in RUNS:
        n, size = data * B, CFG["vision_cfg"]["image_size"]
        batches[data] = [{"images": images(n, size, seed=40 + 2 * i),
                          "texts": token_ids(n, 12, seed=41 + 2 * i),
                          "dino_features": rng.normal(size=(n, DINO_DIM)).astype(np.float32)}
                         for i in range(STEPS)]
    return {"state_dict": sd, "head": head, "teacher": teacher, "batches": batches}


def _port_run(inputs, data, route):
    """This rank's steps of ``route`` on a ``(data, 2)`` mesh: [(metrics,
    {name: whole parameter})] a step."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        Dinov2, Dinov2Cfg, build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        DATA_AXIS, apply_fsdp, create_mesh, full_state_dict, tp_sharding, wrap_ddp,
        zero1_sharding,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )
    from refining_clip_via_dinov2_representations_torch.train.distributed import (
        data_group, model_group,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters, train_splits,
    )

    mesh = create_mesh(model=2, device_type="cpu")
    mp = model_parallel(model_group())
    as_t = lambda sd: {k: torch.as_tensor(v) for k, v in sd.items()}  # noqa: E731
    model = build_model(parse_model_cfg(CFG), attn_impl="xla")
    model.load_state_dict(as_t(inputs["state_dict"]), strict=True)
    head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
    head.load_state_dict(as_t(inputs["head"]), strict=True)
    shard_module(model, mp)
    shard_module(head, mp, head=True)
    teacher = None
    if route == "teacher":
        tmodel = Dinov2(Dinov2Cfg(**TEACHER), attn_impl="xla")
        tmodel.load_state_dict(as_t(inputs["teacher"]), strict=True)
        shard_module(tmodel, mp)
        teacher = LiveDinoTeacher(tmodel)
    named, dgroup = train_parameters(model, head), mesh[DATA_AXIS].get_group()
    if route == "fsdp":
        sharding = apply_fsdp(model, head, mesh, named, 0)
        towers = Towers(model, head)
    else:
        sharding = (zero1_sharding(named, dgroup, 0, mp, train_splits(model, head))
                    if route == "zero1" else tp_sharding(named, dgroup, mp,
                                                         train_splits(model, head)))
        towers = wrap_ddp(Towers(model, head), torch.device("cpu"), dgroup)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**OPTIM_KW),
                                   scheduler.cosine_lr(1e-3, 0, 4), sharding=sharding)
    step = make_train_step(model, StepCfg(loss_type="dino", dino=DinoLossCfg(**LOSS_KW),
                                          log_grad_norm=True),
                           head, teacher, group=data_group(), towers=towers)
    state = TrainState(model, head, opt)
    rank = mesh[DATA_AXIS].get_local_rank()
    out = []
    for batch in inputs["batches"][data]:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[rank * B:(rank + 1) * B]))
                for k, v in batch.items() if route != "teacher" or k != "dino_features"}
        mine["texts"] = mine["texts"].long()
        state, m = step(state, mine)
        params = {k: v.numpy().copy() for k, v in full_state_dict(model).items()}
        params.update({optim.HEAD_PREFIX + k: v.numpy().copy()
                       for k, v in full_state_dict(head).items()})
        out.append(({k: float(v) for k, v in m.items()}, params))
    return out


def _worker(rank, world, inputs):
    data = world // 2
    return {route: _port_run(inputs, data, route) for route in RUNS[(data, 2)]}


def _jax_run(inputs, data, teacher):
    """The JAX step's [(metrics, {port name: parameter})] on a ``(data, 2)``
    mesh."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_head_params_to_state_dict, jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_torch.train.optim import HEAD_PREFIX
    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import DinoProjectionHead
    from refining_clip_via_dinov2_representations_tpu.models import build_model, parse_model_cfg
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        convert_clip_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.models.dinov2 import (
        Dinov2, Dinov2Cfg, convert_dinov2_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import (
        create_mesh, param_shardings, shard_batch, state_shardings,
    )
    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import LiveDinoTeacher
    from refining_clip_via_dinov2_representations_tpu.train.optim import OptimCfg, build_optimizer
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg, create_train_state, make_train_step,
    )

    params = convert_clip_state_dict(inputs["state_dict"])
    hd = inputs["head"]
    head_params = {n: {"kernel": np.ascontiguousarray(hd[f"{n}.weight"].T),
                       "bias": hd[f"{n}.bias"]} for n in ("fc1", "fc2")}
    tx, _ = build_optimizer({"model": params, "dino_head": head_params}, OptimCfg(**OPTIM_KW),
                            cosine_lr(1e-3, 0, 4))
    mesh = create_mesh(data=data, model=2, devices=jax.devices()[:2 * data])
    dino_teacher = extra = None
    if teacher:
        tvars = {"params": convert_dinov2_state_dict(inputs["teacher"])}
        dino_teacher = LiveDinoTeacher(Dinov2(cfg=Dinov2Cfg(**TEACHER)), tvars)
        dino_teacher.variables = {"params": jax.device_put(
            dino_teacher.variables["params"],
            param_shardings(dino_teacher.variables["params"], mesh))}
        extra = {"dino_teacher": dino_teacher.variables}
    step = make_train_step(build_model(parse_model_cfg(CFG), attn_impl="xla"), tx,
                           StepCfg(loss_type="dino", dino=DinoLossCfg(**LOSS_KW),
                                   log_grad_norm=True),
                           head=DinoProjectionHead(dino_dim=DINO_DIM), mesh=mesh,
                           dino_teacher=dino_teacher)
    state = create_train_state(jax.random.PRNGKey(0), params, tx, head_params)
    out = []
    with jax.set_mesh(mesh):
        # parameters over the model axis only: see the module docstring
        state = jax.device_put(state, state_shardings(state, mesh))
        for batch in inputs["batches"][data]:
            batch = {k: jnp.asarray(v) for k, v in batch.items()
                     if not teacher or k != "dino_features"}
            args = (state, shard_batch(batch, mesh)) + ((extra,) if teacher else ())
            state, m = step(*args)
            got = jax_params_to_state_dict(jax.device_get(state.params["model"]))
            got.update({HEAD_PREFIX + k: v for k, v in jax_head_params_to_state_dict(
                jax.device_get(state.params["dino_head"])).items()})
            out.append(({k: float(v) for k, v in m.items()},
                        {k: v.numpy() for k, v in got.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor

    inputs = _inputs()
    with ThreadPoolExecutor(2) as pool:
        # the ranks run while the JAX steps run here
        port = {world: pool.submit(run_ranks, _worker, world, inputs) for world in (2, 4)}
        jax_runs = {(1, False): _jax_run(inputs, 1, False), (1, True): _jax_run(inputs, 1, True),
                    (2, False): _jax_run(inputs, 2, False)}
        return {world: f.result() for world, f in port.items()}, jax_runs


@pytest.mark.parametrize("mesh,route", [(m, r) for m, routes in RUNS.items() for r in routes],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_tp_dino_step_matches_jax_make_train_step_on_the_same_mesh(runs, mesh, route):
    port, jax_runs = runs
    data = mesh[0]
    want_steps = jax_runs[(data, route == "teacher")]
    for r, res in enumerate(port[2 * data]):
        assert len(res[route]) == STEPS
        for i, ((gm, gp), (wm, wp)) in enumerate(zip(res[route], want_steps)):
            for k in METRICS:
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i} rank {r} {k}")
            np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=1e-4,
                                       err_msg=f"step {i} rank {r} grad_norm")
            assert set(gp) == set(wp)
            for n, p in gp.items():
                np.testing.assert_allclose(p, wp[n].reshape(p.shape), rtol=1e-5, atol=5e-6,
                                           err_msg=f"step {i} rank {r} {n}")
