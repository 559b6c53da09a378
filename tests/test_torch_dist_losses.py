"""The port's losses across gloo ranks against the JAX functions under
``shard_map``.

Each rank gets ``B = 4`` rows of ``D = 8`` features (the global batch is
the ranks' rows in rank order), at ``W = 2`` and ``W = 3`` (3 is the first
size where SigLIP's ``bidir`` takes both a bidirectional hop and its
remainder hop). The cases: ``clip_loss`` (local rows against gathered
columns, and the global ``[W B, W B]`` mode), ``dino_enhanced_loss`` with
the soft KL, the text KL and the weighted CE on both sides (the block
offsets), ``siglip_loss`` under each of the four ``dist_impl``, and
``cyclip_loss`` and ``distill_clip_loss`` (the total the train step takes,
contrastive plus distillation, with teacher rows of ``DT = 12``), each with
``local_loss`` on (CyCLIP's penalties over the local pairs only, the
reference's rule) and off (every rank's pairs, the global matrices); and
open_clip's ``CyCLIPLoss`` and ``DistillClipLoss`` (``losses/compat.py``)
at ``world_size=W`` with ``local_loss``, which take the default process
group. Each
rank's loss, and the gradient of the rank-mean loss with respect to its own
image and text rows, against the JAX function under ``jax.shard_map`` over
``W`` of the 8 virtual CPU devices (per-rank losses out of ``P("data")``,
the gradient by ``jax.grad`` of the ``pmean``); fp32, 1e-5 relative (the
gradients within 1e-5 of their largest magnitude), 1e-6 for CyCLIP and
distillation. The ranks are spawned
processes (``tests/torch_dist_utils.py``) that import no JAX.
"""

import numpy as np
import pytest

from .torch_dist_utils import run_ranks

B, D, DD, DT = 4, 8, 6, 12
SCALE, BIAS, T_SCALE = 14.3, -2.5, 30.0
CASES = ("clip", "clip_global", "dino", "siglip_shift", "siglip_bidir", "siglip_gather",
         "siglip_reduce", "cyclip", "cyclip_global", "distill", "distill_global",
         "cyclip_class", "distill_class")
DINO_KW = dict(lambda_soft=0.5, soft_mode="kl_teacher", soft_dino_to_text=True, text_lambda=0.3,
               lambda_weighted=0.7, weight_text_symmetry=True, use_projection=False)


def _inputs(world: int):
    rng = np.random.default_rng(100 + world)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    n = world * B
    return {"img": unit(rng.normal(size=(n, D))).astype(np.float32),
            "txt": unit(rng.normal(size=(n, D))).astype(np.float32),
            "dino": rng.normal(size=(n, DD)).astype(np.float32),
            "t_img": unit(rng.normal(size=(n, DT))).astype(np.float32),
            "t_txt": unit(rng.normal(size=(n, DT))).astype(np.float32)}


def _port_loss(case, img, txt, dino, group, t_img=None, t_txt=None):
    import torch
    import torch.distributed as dist

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, clip_loss, cyclip_loss, dino_enhanced_loss, distill_clip_loss,
    )
    from refining_clip_via_dinov2_representations_torch.losses.contrastive import siglip_loss

    scale = torch.tensor(SCALE)
    local = not case.endswith("_global")
    if case.endswith("_class"):
        from refining_clip_via_dinov2_representations_torch.losses import compat

        world = dist.get_world_size()
        if case == "cyclip_class":
            loss = compat.CyCLIPLoss(0.4, 0.3, local_loss=True, world_size=world)
            return loss(img, txt, scale)
        loss = compat.DistillClipLoss(local_loss=True, world_size=world)
        return sum(loss(img, txt, scale, t_img, t_txt, torch.tensor(T_SCALE)))
    if case.startswith("cyclip"):
        return cyclip_loss(img, txt, scale, 0.4, 0.3, group, local)["total_loss"]
    if case.startswith("distill"):
        out = distill_clip_loss(img, txt, scale, t_img, t_txt, torch.tensor(T_SCALE), group,
                                local)
        return out["contrastive_loss"] + out["distill_loss"]
    if case == "clip":
        return clip_loss(img, txt, scale, group)
    if case == "clip_global":
        return clip_loss(img, txt, scale, group, local_loss=False)
    if case == "dino":
        return dino_enhanced_loss(img, txt, scale, dino, DinoLossCfg(**DINO_KW),
                                  group=group)["total_loss"]
    return siglip_loss(img, txt, scale, torch.tensor(BIAS), group, case.split("_")[1])


def _rank_worker(rank, world, inputs):
    """This rank's loss and the gradients of the rank-mean loss wrt its rows,
    for every case."""
    import torch
    import torch.distributed as dist

    rows = slice(rank * B, (rank + 1) * B)
    out = {}
    for case in CASES:
        img = torch.from_numpy(inputs["img"][rows]).requires_grad_()
        txt = torch.from_numpy(inputs["txt"][rows]).requires_grad_()
        dino = torch.from_numpy(inputs["dino"][rows])
        t_img, t_txt = (torch.from_numpy(inputs[k][rows]) for k in ("t_img", "t_txt"))
        loss = _port_loss(case, img, txt, dino, dist.group.WORLD, t_img, t_txt)
        (loss / world).backward()
        out[case] = (float(loss), img.grad.numpy(), txt.grad.numpy())
    return out


def _jax_case(case, world, inputs):
    """(per-rank losses [W], d mean / d img [W B, D], d mean / d txt)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.contrastive import (
        clip_loss, cyclip_loss, distill_clip_loss, siglip_loss,
    )
    from refining_clip_via_dinov2_representations_tpu.losses.dino import dino_enhanced_loss
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(data=world, model=1, devices=jax.devices()[:world])
    scale, bias = jnp.float32(SCALE), jnp.float32(BIAS)

    def local(img, txt, dino, t_img, t_txt):
        loc = not case.endswith("_global")  # the classes run with local_loss
        if case.startswith("cyclip"):
            return cyclip_loss(img, txt, scale, 0.4, 0.3, axis_name="data",
                               local_loss=loc)["total_loss"]
        if case.startswith("distill"):
            out = distill_clip_loss(img, txt, scale, t_img, t_txt, jnp.float32(T_SCALE),
                                    axis_name="data", local_loss=loc)
            return out["contrastive_loss"] + out["distill_loss"]
        if case == "clip":
            return clip_loss(img, txt, scale, axis_name="data")
        if case == "clip_global":
            return clip_loss(img, txt, scale, axis_name="data", local_loss=False)
        if case == "dino":
            return dino_enhanced_loss(img, txt, scale, dino, DinoLossCfg(**DINO_KW),
                                      axis_name="data")["total_loss"]
        return siglip_loss(img, txt, scale, bias, axis_name="data", axis_size=world,
                           dist_impl=case.split("_")[1])

    specs = (P("data"),) * 5
    per_rank = jax.shard_map(lambda *a: local(*a)[None], mesh=mesh, in_specs=specs,
                             out_specs=P("data"))
    mean = jax.shard_map(lambda *a: lax.pmean(local(*a), "data"), mesh=mesh,
                         in_specs=specs, out_specs=P())
    args = [jnp.asarray(inputs[k]) for k in ("img", "txt", "dino", "t_img", "t_txt")]
    losses = jax.jit(per_rank)(*args)
    g_img, g_txt = jax.jit(jax.grad(mean, argnums=(0, 1)))(*args)
    return np.asarray(losses), np.asarray(g_img), np.asarray(g_txt)


@pytest.fixture(scope="module")
def port_runs():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:  # both groups of ranks at once
        runs = {w: pool.submit(run_ranks, _rank_worker, w, _inputs(w)) for w in (2, 3)}
        return {w: (_inputs(w), run.result()) for w, run in runs.items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [2, 3])
def test_rank_losses_and_local_gradients_match_jax_shard_map(port_runs, world, case):
    inputs, ranks = port_runs[world]
    losses, g_img, g_txt = _jax_case(case, world, inputs)
    rtol = 1e-6 if case.startswith(("cyclip", "distill")) else 1e-5
    for r, res in enumerate(ranks):
        loss, gi, gt = res[case]
        np.testing.assert_allclose(loss, losses[r], rtol=rtol, err_msg=f"rank {r} loss")
        rows = slice(r * B, (r + 1) * B)
        for got, want, what in ((gi, g_img[rows], "img"), (gt, g_txt[rows], "txt")):
            tol = rtol * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=rtol, atol=tol,
                                       err_msg=f"rank {r} d/d{what}")
