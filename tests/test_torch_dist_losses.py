"""The port's losses across gloo ranks against the JAX functions under
``shard_map``.

Each rank gets ``B = 4`` rows of ``D = 8`` features (the global batch is
the ranks' rows in rank order), at ``W = 2`` and ``W = 3`` (3 is the first
size where SigLIP's ``bidir`` takes both a bidirectional hop and its
remainder hop). The cases: ``clip_loss`` (local rows against gathered
columns, and the global ``[W B, W B]`` mode), ``dino_enhanced_loss`` with
the soft KL, the text KL and the weighted CE on both sides (the block
offsets), and ``siglip_loss`` under each of the four ``dist_impl``. Each
rank's loss, and the gradient of the rank-mean loss with respect to its own
image and text rows, against the JAX function under ``jax.shard_map`` over
``W`` of the 8 virtual CPU devices (per-rank losses out of ``P("data")``,
the gradient by ``jax.grad`` of the ``pmean``); fp32, 1e-5 relative (the
gradients within 1e-5 of their largest magnitude). The ranks are spawned
processes (``tests/torch_dist_utils.py``) that import no JAX.
"""

import numpy as np
import pytest

from .torch_dist_utils import run_ranks

B, D, DD = 4, 8, 6
SCALE, BIAS = 14.3, -2.5
CASES = ("clip", "clip_global", "dino", "siglip_shift", "siglip_bidir", "siglip_gather",
         "siglip_reduce")
DINO_KW = dict(lambda_soft=0.5, soft_mode="kl_teacher", soft_dino_to_text=True, text_lambda=0.3,
               lambda_weighted=0.7, weight_text_symmetry=True, use_projection=False)


def _inputs(world: int):
    rng = np.random.default_rng(100 + world)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    n = world * B
    return {"img": unit(rng.normal(size=(n, D))).astype(np.float32),
            "txt": unit(rng.normal(size=(n, D))).astype(np.float32),
            "dino": rng.normal(size=(n, DD)).astype(np.float32)}


def _port_loss(case, img, txt, dino, group):
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, clip_loss, dino_enhanced_loss,
    )
    from refining_clip_via_dinov2_representations_torch.losses.contrastive import siglip_loss

    scale = torch.tensor(SCALE)
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
        loss = _port_loss(case, img, txt, dino, dist.group.WORLD)
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
        clip_loss, siglip_loss,
    )
    from refining_clip_via_dinov2_representations_tpu.losses.dino import dino_enhanced_loss
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(data=world, model=1, devices=jax.devices()[:world])
    scale, bias = jnp.float32(SCALE), jnp.float32(BIAS)

    def local(img, txt, dino):
        if case == "clip":
            return clip_loss(img, txt, scale, axis_name="data")
        if case == "clip_global":
            return clip_loss(img, txt, scale, axis_name="data", local_loss=False)
        if case == "dino":
            return dino_enhanced_loss(img, txt, scale, dino, DinoLossCfg(**DINO_KW),
                                      axis_name="data")["total_loss"]
        return siglip_loss(img, txt, scale, bias, axis_name="data", axis_size=world,
                           dist_impl=case.split("_")[1])

    specs = (P("data"), P("data"), P("data"))
    per_rank = jax.shard_map(lambda i, t, d: local(i, t, d)[None], mesh=mesh, in_specs=specs,
                             out_specs=P("data"))
    mean = jax.shard_map(lambda i, t, d: lax.pmean(local(i, t, d), "data"), mesh=mesh,
                         in_specs=specs, out_specs=P())
    args = [jnp.asarray(inputs[k]) for k in ("img", "txt", "dino")]
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
    for r, res in enumerate(ranks):
        loss, gi, gt = res[case]
        np.testing.assert_allclose(loss, losses[r], rtol=1e-5, err_msg=f"rank {r} loss")
        rows = slice(r * B, (r + 1) * B)
        for got, want, what in ((gi, g_img[rows], "img"), (gt, g_txt[rows], "txt")):
            tol = 1e-5 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol,
                                       err_msg=f"rank {r} d/d{what}")
