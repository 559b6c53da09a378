"""Checkpoints between one process and two FSDP ranks.

A one-process run (a 128-wide model, so that adafactor factors its
matrices; the DINO head; adafactor with a bf16 first moment) takes a step
and saves. Two gloo ranks under FSDP (``--fsdp-min-size`` 1024, so the
matrices and the head are sharded and the small tensors replicated) restore
that file: each rank's whole model, head and optimizer state (gathered) is
the saved one, exactly. The ranks then take a step on their halves of a
batch and save; rank 0 alone writes the file, which has the one-process
layout and loads strictly into one process with tensors and optimizer
state equal to the ranks' own, exactly. The save's gather (``cpu_offload``)
leaves the whole state with rank 0 alone.
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


def _state(fsdp: bool):
    """A fresh train state (seeded weights); under ``fsdp`` sharded over the
    process group."""
    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        apply_fsdp, create_mesh,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.distributed import data_group
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters,
    )

    model = build_model(parse_model_cfg(CFG), seed=11)
    torch.manual_seed(12)
    head = DinoProjectionHead(CFG["embed_dim"], DINO_DIM)
    sharding = towers = None
    if fsdp:
        sharding = apply_fsdp(model, head, create_mesh(device_type="cpu"),
                              train_parameters(model, head), 1024)
        towers = Towers(model, head)
    opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(**OPTIM_KW),
                                   scheduler.const_lr(1e-3, 0, 4), sharding=sharding)
    step = make_train_step(model, StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5)),
                           head, group=data_group(), towers=towers)
    return TrainState(model, head, opt, 0, torch.Generator().manual_seed(0)), step


def _batch(seed, rows=slice(None)):
    size, ctx = CFG["vision_cfg"]["image_size"], CFG["text_cfg"]["context_length"]
    n = W * B
    return {"images": torch.from_numpy(images(n, size, seed=seed)[rows]),
            "texts": torch.from_numpy(token_ids(n, ctx, seed=seed + 1)[rows]).long(),
            "dino_features": torch.from_numpy(np.random.default_rng(seed).normal(
                size=(n, DINO_DIM)).astype(np.float32)[rows])}


def _whole(state):
    """The whole model, head and optimizer state as numpy (a collective)."""
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import full_state_dict

    opt = state.optimizer.state_dict()
    return {"model": {k: v.numpy().copy() for k, v in full_state_dict(state.model).items()},
            "head": {k: v.numpy().copy() for k, v in full_state_dict(state.head).items()},
            "opt": {f"{n}.{k}": t.float().numpy().copy()
                    for n, s in opt["state"].items() for k, t in s.items()},
            "count": opt["count"], "step": state.step}


def _rank_worker(rank, world, saved, out_dir):
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import full_state_dict
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    state, step = _state(fsdp=True)
    state, epoch, _, _ = restore_checkpoint(saved, state)
    restored = _whole(state)
    state, _ = step(state, _batch(50, slice(rank * B, (rank + 1) * B)))
    path = save_checkpoint(out_dir, state, epoch + 1, name="two-rank")
    kept = (len(full_state_dict(state.model, cpu_offload=True)),
            len(state.optimizer.state_dict(cpu_offload=True)["state"]))
    return restored, _whole(state), path, kept


def _assert_equal(got, want):
    for part in ("model", "head", "opt"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")
    assert (got["count"], got["step"]) == (want["count"], want["step"])


def test_fsdp_checkpoints_round_trip_between_one_process_and_two_ranks(tmp_path):
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    state, step = _state(fsdp=False)
    state, _ = step(state, _batch(40))
    one = save_checkpoint(str(tmp_path / "one"), state, 1, name="one-process")
    want_restored = _whole(state)
    ranks = run_ranks(_rank_worker, W, one, str(tmp_path / "two"))
    for restored, _, _, _ in ranks:
        _assert_equal(restored, want_restored)
    after = ranks[0][1]
    _assert_equal(ranks[1][1], after)
    assert ranks[0][3] == (len(after["model"]), len({k.rsplit(".", 1)[0] for k in after["opt"]}))
    assert ranks[1][3] == (0, 0)
    path = ranks[0][2]
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["epoch"] == 2 and saved["name"] == "two-rank"
    fresh, _ = _state(fsdp=False)
    fresh, epoch, _, _ = restore_checkpoint(path, fresh)
    assert epoch == 2
    _assert_equal(_whole(fresh), after)
    # rank 0's file only: one writer
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == ["epoch_2.pt"]
