"""Checkpoints across ``(data, model)`` layouts.

A 128-wide model (so that adafactor factors its matrices, TP-split ones
included) with the DINO head (``mlp``, split too), adafactor with a bf16
first moment, global-norm clipping, the classic CLIP loss (the data ranks'
mean is the global batch's loss, so every layout takes the same step; the
head takes no gradient and rides in the optimizer and the files):

* two gloo ranks at ``(1, 2)`` under ZeRO-1 take a step and save, then take
  the next step;
* one process, ``(1, 1)``, restores that file: its model, head and
  optimizer state are the saved whole tensors, exactly (the packed QKV, the
  TP-split moments and factored statistics put back in their order); its
  next step's loss equals the ranks' at 1e-5 relative and every parameter
  at 1e-5 relative and 5e-6 absolute (but the attention's packed QKV bias:
  its key part's gradient is zero but for rounding, which adafactor divides
  by its own RMS, as ``tests/test_torch_dist_step.py`` says); it saves
  again and steps on;
* two gloo ranks at ``(2, 1)`` restore the first file and take the same
  next step on their halves of the batch; at ``(1, 2)`` they restore the
  one-process file ("and back") and take its next step. Both states equal
  the files exactly, both steps the one process's.
"""

import numpy as np
import torch

from .torch_dist_utils import run_ranks
from .torch_port_utils import images, token_ids

W, B, DINO_DIM = 2, 4, 24
CFG = {"embed_dim": 64,
       "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 128, "layers": 1,
                      "head_width": 32},
       "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 128, "heads": 4,
                    "layers": 1}}
OPTIM_KW = dict(lr=1e-3, opt="adafactor", mu_dtype="bfloat16", grad_clip_norm=1.0)


def _state(model_axis=None, zero1=False):
    """A fresh train state (seeded weights) on a ``(world / model_axis,
    model_axis)`` mesh, or in one process (None)."""
    from refining_clip_via_dinov2_representations_torch.losses import DinoProjectionHead
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        DATA_AXIS, create_mesh, tp_sharding, wrap_ddp, zero1_sharding,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.distributed import (
        data_group, model_group,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters, train_splits,
    )

    model = build_model(parse_model_cfg(CFG), seed=11)
    torch.manual_seed(12)
    head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
    sharding = towers = group = None
    if model_axis is not None:
        mesh = create_mesh(model=model_axis, device_type="cpu")
        mp, group = model_parallel(model_group()), data_group()
        shard_module(model, mp)
        shard_module(head, mp, head=True)
        named, dgroup = train_parameters(model, head), mesh[DATA_AXIS].get_group()
        splits = train_splits(model, head)
        sharding = (zero1_sharding(named, dgroup, 1024, mp, splits) if zero1
                    else tp_sharding(named, dgroup, mp, splits))
        # the clip loss leaves the head out of the forward (and so of DDP)
        towers = wrap_ddp(Towers(model), torch.device("cpu"), dgroup)
    opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(**OPTIM_KW),
                                   scheduler.const_lr(1e-3, 0, 4), sharding=sharding)
    step = make_train_step(model, StepCfg(loss_type="clip", log_grad_norm=True), head,
                           group=group, towers=towers)
    return TrainState(model, head, opt, 0, torch.Generator().manual_seed(0)), step


def _batch(seed, data_rank=0, data_world=1):
    size, ctx = CFG["vision_cfg"]["image_size"], CFG["text_cfg"]["context_length"]
    n = W * B
    rows = slice(data_rank * n // data_world, (data_rank + 1) * n // data_world)
    return {"images": torch.from_numpy(images(n, size, seed=seed)[rows]),
            "texts": torch.from_numpy(token_ids(n, ctx, seed=seed + 1)[rows]).long()}


def _whole(state):
    """The whole model, head and optimizer state as numpy (a collective)."""
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import full_state_dict

    opt = state.optimizer.state_dict()
    return {"model": {k: v.numpy().copy() for k, v in full_state_dict(state.model).items()},
            "head": {k: v.numpy().copy() for k, v in full_state_dict(state.head).items()},
            "opt": {f"{n}.{k}": t.float().numpy().copy()
                    for n, s in opt["state"].items() for k, t in s.items()},
            "count": opt["count"], "step": state.step}


def _step(state, step, batch):
    state, m = step(state, batch)
    return state, float(m["total_loss"])


def _save_worker(rank, world, out_dir):
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import save_checkpoint

    state, step = _state(model_axis=world, zero1=True)
    state, _ = _step(state, step, _batch(40))
    path = save_checkpoint(out_dir, state, 1, name="tp")
    saved = _whole(state)
    state, loss = _step(state, step, _batch(50))
    return path, saved, loss, _whole(state)


def _resume_worker(rank, world, first, second):
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        restore_checkpoint,
    )

    out = {}
    # (2, 1): the data ranks take halves of the batch
    state, step = _state(model_axis=1, zero1=True)
    state, _, _, _ = restore_checkpoint(first, state)
    restored = _whole(state)
    state, loss = _step(state, step, _batch(50, rank, world))
    out["2x1"] = (restored, loss, _whole(state))
    # (1, 2): back to a model axis, from the one-process file
    state, step = _state(model_axis=world)
    state, _, _, _ = restore_checkpoint(second, state)
    restored = _whole(state)
    state, loss = _step(state, step, _batch(60))
    out["1x2"] = (restored, loss, _whole(state))
    return out


def _assert_equal(got, want):
    for part in ("model", "head", "opt"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")
    assert (got["count"], got["step"]) == (want["count"], want["step"])


def _assert_close(got, want):
    for part in ("model", "head"):
        for k, v in want[part].items():
            if k.endswith("attn.in_proj_bias"):
                continue  # adafactor's rounding noise (the module docstring)
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=5e-6,
                                       err_msg=f"{part} {k}")


def test_checkpoints_resume_across_data_and_model_layouts(tmp_path):
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    saves = run_ranks(_save_worker, W, str(tmp_path / "tp"))
    path, saved, tp_loss, tp_after = saves[0]
    _assert_equal(saves[1][1], saved)
    # one process, (1, 1)
    state, step = _state()
    state, _, _, _ = restore_checkpoint(path, state)
    _assert_equal(_whole(state), saved)
    state, loss = _step(state, step, _batch(50))
    np.testing.assert_allclose(loss, tp_loss, rtol=1e-5)
    one_after = _whole(state)
    _assert_close(tp_after, one_after)
    second = save_checkpoint(str(tmp_path / "one"), state, 2, name="one")
    state, loss_next = _step(state, step, _batch(60))
    want_next = _whole(state)
    # two ranks at (2, 1) and back at (1, 2)
    for r, res in enumerate(run_ranks(_resume_worker, W, path, second)):
        restored, loss, after = res["2x1"]
        _assert_equal(restored, saved)
        np.testing.assert_allclose(loss, tp_loss, rtol=1e-5, err_msg=f"rank {r} 2x1")
        _assert_close(after, one_after)
        restored, loss, after = res["1x2"]
        _assert_equal(restored, one_after)
        np.testing.assert_allclose(loss, loss_next, rtol=1e-5, err_msg=f"rank {r} 1x2")
        _assert_close(after, want_next)
