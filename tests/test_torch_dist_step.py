"""The port's train step across two gloo ranks.

* Against the JAX package: the DINO-soft step (soft KL and weighted CE, the
  projection head) on the tiny config, two AdamW steps on two ranks (DDP),
  against ``make_train_step`` on a 2-device mesh (the loss under
  ``shard_map``), from one init carried across with the converters; plain
  and with ``accum_freq=2``. The JAX model takes ``"xla"`` attention (the
  plain reference of the Pallas kernels, as the port's CPU path). Losses and
  metrics at 1e-5 relative, every parameter after each step at 1e-5
  relative and 5e-6 absolute (lr 1e-3; AdamW at eps 1e-3, as
  ``tests/test_torch_train_step.py`` says why). Rank ``r``'s rows are the
  JAX device ``r``'s block: under accumulation the JAX step reshapes the
  ``[accum, W B]`` batch to ``accum W B`` rows and gives each device a
  contiguous ``accum B`` of them, so rank ``r``'s microbatch ``s`` is rows
  ``(r accum + s) B`` onward of that flattening.
* ZeRO-1 (``zero1_sharding`` under DDP) and FSDP (``apply_fsdp``) against
  the replicated two-rank route: adamw, lamb and adafactor with a bf16
  first moment, global-norm clipping on, two steps (AdamW also with
  ``accum_freq=2``, whose passes but the last keep the gradients
  unreduced), on a config 128 wide
  (adafactor factors tensors whose second dimension has 128 entries, split
  on either of their two dimensions); every parameter at 1e-5 relative,
  but the attention's packed QKV bias under adafactor: its key part has a
  gradient that is zero but for rounding (a softmax does not move when a
  key bias shifts every score of a row alike), adafactor divides a gradient
  by its own RMS, so that part moves by rounding noise scaled to the lr,
  and the block RMS clip carries the noise into the query and value parts.
  The last bits of the clipping norm differ between the routes (sums in
  another order), and the noise with them.
* The fast sibling, no JAX: the two-rank step (DDP) against the
  one-process step at the global batch for ``clip`` and SigLIP (``bidir``,
  ``gather``), where the rank mean is the global batch's loss.
"""

import numpy as np
import pytest

from .torch_dist_utils import run_ranks
from .torch_port_utils import TINY_CFG, images, jax_clip, token_ids

W, B, DINO_DIM, ACCUM = 2, 4, 24, 2
CFG = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "layers": 1},
       "text_cfg": {**TINY_CFG["text_cfg"], "layers": 1}}
WIDE_CFG = {"embed_dim": 64,
            "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 128, "layers": 1,
                           "head_width": 32},
            "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 128, "heads": 4,
                         "layers": 1}}
LOSS_KW = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
OPTIM_KW = dict(lr=1e-3, head_lr=2e-3, text_lr=5e-4, logit_scale_lr=1e-2, eps=1e-3)
METRICS = ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale")


def _batches(cfg, n, steps=2, seed=30):
    size, ctx = cfg["vision_cfg"]["image_size"], cfg["text_cfg"]["context_length"]
    rng = np.random.default_rng(seed)
    return [{"images": images(n, size, seed=seed + 2 * i),
             "texts": token_ids(n, ctx, seed=seed + 2 * i + 1),
             "dino_features": rng.normal(size=(n, DINO_DIM)).astype(np.float32)}
            for i in range(steps)]


def _torch_batch(batch):
    import torch

    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["texts"] = out["texts"].long()
    return out


def _port_run(cfg, state_dict, head_sd, batches, route, loss="dino", optim_kw=OPTIM_KW,
              accum=1, min_size=2 ** 16, siglip_impl="bidir"):
    """Steps of the port on this process's rows (``batches`` are this rank's
    already); returns [(metrics, {name: whole parameter})] a step."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        apply_fsdp, create_mesh, full_state_dict, wrap_ddp, zero1_sharding,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.distributed import data_group
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters,
    )

    model = build_model(parse_model_cfg(cfg))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    head = None
    if head_sd is not None:
        head = DinoProjectionHead(cfg["embed_dim"], DINO_DIM)
        head.load_state_dict({k: torch.as_tensor(v) for k, v in head_sd.items()}, strict=True)
    towers = sharding = None
    group = data_group()
    if route == "fsdp":
        sharding = apply_fsdp(model, head, create_mesh(device_type="cpu"),
                              train_parameters(model, head), min_size)
        towers = Towers(model, head)
    elif route in ("ddp", "zero1"):
        if route == "zero1":
            sharding = zero1_sharding(train_parameters(model, head), group, min_size)
        towers = wrap_ddp(Towers(model, head), torch.device("cpu"))
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(**optim_kw),
                                   scheduler.cosine_lr(optim_kw["lr"], 0, 4), sharding=sharding)
    step_cfg = StepCfg(loss_type=loss, dino=DinoLossCfg(**LOSS_KW), accum_freq=accum,
                       log_grad_norm=True, siglip_dist_impl=siglip_impl)
    step = make_train_step(model, step_cfg, head, group=group, towers=towers)
    state = TrainState(model, head, opt)
    out = []
    for batch in batches:
        state, m = step(state, _torch_batch(batch))
        params = {k: v.numpy().copy() for k, v in full_state_dict(model).items()}
        if head is not None:
            params.update({optim.HEAD_PREFIX + k: v.numpy().copy()
                           for k, v in full_state_dict(head).items()})
        out.append(({k: float(v) for k, v in m.items()}, params))
    return out


def _rank_rows(batch, rank, accum):
    """Rank ``rank``'s rows of a JAX global batch (see the module docstring)."""
    if accum == 1:
        return {k: v[rank * B:(rank + 1) * B] for k, v in batch.items()}
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
    first = rank * accum * B
    return {k: v[first:first + accum * B].reshape(accum, B, *v.shape[1:])
            for k, v in flat.items()}


def _jax_inputs():
    """The seeded JAX init (model and head) and, for the port, its state
    dicts and the global batches of each ``accum``."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_head_params_to_state_dict, jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )

    _, variables = jax_clip(CFG, attn_impl="xla", jit=True)
    head_params = jax.device_get(JaxHead(dino_dim=DINO_DIM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, CFG["embed_dim"])))["params"])
    batches = {}
    for accum in (1, ACCUM):
        flat = _batches(CFG, W * B * accum)
        batches[accum] = flat if accum == 1 else [
            {k: v.reshape(accum, W * B, *v.shape[1:]) for k, v in b.items()} for b in flat]
    return {"params": variables["params"], "head_params": head_params, "batches": batches,
            "state_dict": {k: v.numpy() for k, v in
                           jax_params_to_state_dict(variables["params"]).items()},
            "head_sd": {k: v.numpy() for k, v in
                        jax_head_params_to_state_dict(head_params).items()}}


@pytest.mark.parametrize("accum", [1, ACCUM])
def test_two_rank_dino_step_matches_jax_make_train_step_on_a_two_device_mesh(ranks, accum):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_head_params_to_state_dict, jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_torch.train.optim import HEAD_PREFIX
    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build_model, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import (
        create_mesh, replicated, shard_batch,
    )
    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxOptimCfg, build_optimizer as jax_build_optimizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, create_train_state, make_train_step as jax_make_step,
    )

    inputs, results = ranks
    jax_in = inputs["jax"]
    jmodel = jax_build_model(jax_parse(CFG), attn_impl="xla")
    jhead = JaxHead(dino_dim=DINO_DIM)
    params = {"model": jax_in["params"], "dino_head": jax_in["head_params"]}
    tx, _ = jax_build_optimizer(params, JaxOptimCfg(**OPTIM_KW), cosine_lr(1e-3, 0, 4))
    mesh = create_mesh(data=W, model=1, devices=jax.devices()[:W])
    jstep = jax_make_step(jmodel, tx, JaxStepCfg(loss_type="dino", dino=JaxLossCfg(**LOSS_KW),
                                                 accum_freq=accum, log_grad_norm=True),
                          head=jhead, mesh=mesh)
    jstate = create_train_state(jax.random.PRNGKey(0), jax_in["params"], tx,
                                jax_in["head_params"])
    with jax.set_mesh(mesh):
        jstate = jax.device_put(jstate, replicated(mesh))
        for i, batch in enumerate(jax_in["batches"][accum]):
            jstate, jm = jstep(jstate, shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                                   mesh, microbatched=accum > 1))
            want = jax_params_to_state_dict(jax.device_get(jstate.params["model"]))
            want.update({HEAD_PREFIX + k: v for k, v in jax_head_params_to_state_dict(
                jax.device_get(jstate.params["dino_head"])).items()})
            for r, res in enumerate(results):
                metrics, got = res["jax"][accum][i]
                for k in METRICS:
                    np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=1e-5, atol=1e-7,
                                               err_msg=f"step {i} rank {r} {k}")
                np.testing.assert_allclose(metrics["grad_norm"], float(jm["grad_norm"]),
                                           rtol=1e-4, err_msg=f"step {i} grad_norm")
                for n, p in got.items():
                    np.testing.assert_allclose(p, want[n].reshape(p.shape).numpy(), rtol=1e-5,
                                               atol=5e-6, err_msg=f"step {i} rank {r} {n}")


SIBLING_CASES = [("clip", "bidir"), ("siglip", "bidir"), ("siglip", "gather")]
SHARDED_OPTS = {
    "adamw": dict(OPTIM_KW, grad_clip_norm=0.05),
    "adamw-accum2": dict(OPTIM_KW, grad_clip_norm=0.05),
    "lamb": dict(OPTIM_KW, opt="lamb", grad_clip_norm=0.05),
    "adafactor": dict(OPTIM_KW, opt="adafactor", mu_dtype="bfloat16", grad_clip_norm=0.05),
}


def _wide_inputs():
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )

    model = build_model(parse_model_cfg(WIDE_CFG), seed=5)
    torch.manual_seed(6)
    head = DinoProjectionHead(WIDE_CFG["embed_dim"], DINO_DIM)
    return {"state_dict": {k: v.numpy() for k, v in model.state_dict().items()},
            "head_sd": {k: v.numpy() for k, v in head.state_dict().items()},
            "batches": {1: _batches(WIDE_CFG, W * B),
                        ACCUM: [{k: v.reshape(ACCUM, W * B, *v.shape[1:]) for k, v in b.items()}
                                for b in _batches(WIDE_CFG, W * B * ACCUM, seed=60)]}}


def _sibling_inputs():
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )

    return {"state_dict": {k: v.numpy() for k, v in build_model(parse_model_cfg(CFG), seed=7)
                           .state_dict().items()},
            "batches": _batches(CFG, W * B, steps=1)}


def _worker(rank, world, inputs):
    """The two-rank runs of the parts ``inputs`` names ("jax", "wide",
    "sibling")."""
    out = {}
    if "jax" in inputs:
        jax_in = inputs["jax"]
        out["jax"] = {accum: _port_run(CFG, jax_in["state_dict"], jax_in["head_sd"],
                                       [_rank_rows(b, rank, accum)
                                        for b in jax_in["batches"][accum]],
                                       "ddp", accum=accum) for accum in (1, ACCUM)}
    if "wide" in inputs:
        wide = inputs["wide"]
        out["sharded"] = {}
        for name, kw in SHARDED_OPTS.items():
            accum = ACCUM if name.endswith("accum2") else 1
            mine = [_rank_rows(b, rank, accum) for b in wide["batches"][accum]]
            for route in ("ddp", "zero1", "fsdp"):
                out["sharded"][(route, name)] = _port_run(WIDE_CFG, wide["state_dict"],
                                                          wide["head_sd"], mine, route,
                                                          optim_kw=kw, accum=accum,
                                                          min_size=1024)
    if "sibling" in inputs:
        mine = [_rank_rows(b, rank, 1) for b in inputs["sibling"]["batches"]]
        out["sibling"] = {case: _port_run(CFG, inputs["sibling"]["state_dict"], None, mine,
                                          "ddp", loss=case[0], siglip_impl=case[1])
                          for case in SIBLING_CASES}
    return out


@pytest.fixture(scope="module")
def ranks():
    from concurrent.futures import ThreadPoolExecutor

    rest = {"wide": _wide_inputs(), "sibling": _sibling_inputs()}
    with ThreadPoolExecutor(1) as pool:
        # the ranks that need no JAX run while the JAX init runs here
        rest_runs = pool.submit(run_ranks, _worker, W, rest)
        jax_in = {"jax": _jax_inputs()}
        jax_runs = run_ranks(_worker, W, jax_in)
        runs = [{**a, **b} for a, b in zip(rest_runs.result(), jax_runs)]
    return {**rest, **jax_in}, runs


@pytest.mark.parametrize("route", ["zero1", "fsdp"])
@pytest.mark.parametrize("opt", list(SHARDED_OPTS))
def test_sharded_state_routes_equal_the_replicated_route(ranks, route, opt):
    for r, res in enumerate(ranks[1]):
        runs = res["sharded"]
        want, got = runs[("ddp", opt)], runs[(route, opt)]
        assert len(got) == 2
        for i, ((wm, wp), (gm, gp)) in enumerate(zip(want, got)):
            for k in METRICS + ("grad_norm",):
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=f"{i} {r} {k}")
            assert set(gp) == set(wp)
            for n in wp:
                if opt == "adafactor" and n.endswith("attn.in_proj_bias"):
                    continue  # rounding noise scaled to the lr (the module docstring)
                np.testing.assert_allclose(gp[n], wp[n], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i} rank {r} {n}")


@pytest.mark.parametrize("case", SIBLING_CASES, ids=lambda c: "-".join(c))
def test_two_rank_step_equals_the_one_process_step_at_the_global_batch(ranks, case):
    inputs, results = ranks
    sib = inputs["sibling"]
    (want_m, want_p), = _port_run(CFG, sib["state_dict"], None, sib["batches"], "single",
                                  loss=case[0], siglip_impl=case[1])
    for r, res in enumerate(results):
        (got_m, got_p), = res["sibling"][case]
        for k in ("total_loss", "contrastive_loss", "grad_norm"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, err_msg=f"rank {r} {k}")
        for n in want_p:
            np.testing.assert_allclose(got_p[n], want_p[n], rtol=1e-5, atol=5e-6,
                                       err_msg=f"rank {r} {n}")
