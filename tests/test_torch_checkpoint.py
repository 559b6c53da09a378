"""The port's checkpoints: resume continues a run exactly (2 steps, save,
``--resume latest``, 1 step give the parameters and loss of 3 steps straight,
within 1e-6), rotation keeps the right files, ``latest`` sorts naturally,
and the JAX package's ``export_torch_checkpoint`` file loads into the port
with ``strict=True`` and gives the JAX model's features (1e-5)."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
)
from refining_clip_via_dinov2_representations_torch.train.main import main

from .torch_port_utils import TINY_CFG, images, jax_clip, one_thread, token_ids  # noqa: F401

MODEL = "tiny-torch-ckpt-test"
register_model_config(MODEL, TINY_CFG)
# a 128-wide vision tower, so that adafactor factors its projections
WIDE_MODEL = "tiny-torch-ckpt-test-wide"
register_model_config(WIDE_MODEL, {**TINY_CFG, "vision_cfg": {
    **TINY_CFG["vision_cfg"], "width": 128, "head_width": 64, "layers": 1}})
RESUME_TOL = 1e-6
FEATURE_TOL = 1e-5


def _argv(logs, name, epochs, *extra):
    """One step an epoch: 4 synthetic samples at batch 4, DINO-soft, a
    constant lr (so the schedule does not depend on --epochs)."""
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "4",
            "--batch-size", "4", "--epochs", str(epochs), "--workers", "1", "--logs", str(logs),
            "--name", name, "--precision", "fp32", "--force-cpu", "--use_dino_general",
            "--soft_mode", "kl_teacher", "--lambda_soft", "0.5", "--synthetic-dino-dim", "24",
            "--lr", "1e-3", "--lr-scheduler", "const", "--warmup", "1",
            "--log-every-n-steps", "1", "--seed", "5", *extra]


def _saved(logs, name, ckpt):
    return torch.load(os.path.join(logs, name, "checkpoints", ckpt), map_location="cpu",
                      weights_only=True)


def test_resume_latest_continues_the_run_exactly(tmp_path):
    straight = main(_argv(tmp_path, "straight", 3))
    first = main(_argv(tmp_path, "resumed", 2))
    second = main(_argv(tmp_path, "resumed", 3, "--resume", "latest"))
    assert [r["step"] for r in first] == [1, 2]
    assert [r["step"] for r in straight] == [r["step"] for r in second] == [1, 2, 3]
    for got, want in zip(second, straight):
        assert got["total_loss"] == pytest.approx(want["total_loss"], abs=RESUME_TOL)
    with open(tmp_path / "resumed" / "loss_steps.json") as f:
        assert json.load(f) == second  # the earlier run's records carried over
    got, want = _saved(tmp_path, "resumed", "epoch_3.pt"), _saved(tmp_path, "straight",
                                                                   "epoch_3.pt")
    assert got["step"] == want["step"] == 3 and got["epoch"] == want["epoch"] == 3
    for part in ("state_dict", "dino_head"):
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, atol=RESUME_TOL, rtol=0)
    g_opt, w_opt = got["optimizer"]["state"], want["optimizer"]["state"]
    assert g_opt.keys() == w_opt.keys()
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 3
    for n in w_opt:  # AdamW's moments, by parameter name
        for k in ("mu", "nu"):
            torch.testing.assert_close(g_opt[n][k], w_opt[n][k], atol=RESUME_TOL, rtol=0)
    assert got["data_order"] == {"accum_freq": 1, "batch_size": 4, "seed": 5, "world": 1}


@pytest.mark.parametrize("extra, files", [
    ([], ["epoch_1.pt", "epoch_2.pt", "epoch_3.pt"]),
    (["--save-frequency", "2"], ["epoch_2.pt", "epoch_3.pt"]),
    (["--delete-previous-checkpoint"], ["epoch_3.pt"]),
    (["--save-most-recent", "--delete-previous-checkpoint"], ["epoch_3.pt", "epoch_latest.pt"]),
])
def test_rotation_keeps_the_right_files(tmp_path, extra, files):
    main(_argv(tmp_path, "run", 3, *extra))
    # beside the run's final export of the model
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == files + [
        "final_torch_state.pt"]


def test_resume_with_save_most_recent_reads_epoch_latest(tmp_path):
    main(_argv(tmp_path, "run", 2, "--save-most-recent", "--save-frequency", "5"))
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == [
        "epoch_2.pt", "epoch_latest.pt", "final_torch_state.pt"]
    os.remove(tmp_path / "run" / "checkpoints" / "epoch_2.pt")
    records = main(_argv(tmp_path, "run", 3, "--save-most-recent", "--resume", "latest"))
    assert [r["step"] for r in records] == [1, 2, 3]
    assert _saved(tmp_path, "run", "epoch_latest.pt")["step"] == 3


def test_latest_checkpoint_sorts_naturally(tmp_path):
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("epoch_2.pt", "epoch_10.pt", "epoch_9.pt", "epoch_latest.pt", "epoch_11.pt.tmp1",
                 "notes.txt", "final_torch_state.pt"):
        (tmp_path / name).write_text("")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10.pt")
    # a preemption save sorts after its epoch's completed checkpoint
    (tmp_path / "epoch_10_preempt.pt").write_text("")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10_preempt.pt")
    # and an fsspec URL lists the same way, the answer a URL
    assert latest_checkpoint("file://" + str(tmp_path)) == "file://" + str(
        tmp_path / "epoch_10_preempt.pt")
    assert latest_checkpoint("file://" + str(tmp_path / "absent")) is None


def test_restore_refuses_latest_and_a_missing_head(tmp_path):
    main(_argv(tmp_path, "clip", 1, "--lambda_soft", "0.0", "--no_projection"))
    path = os.path.join(tmp_path, "clip", "checkpoints", "epoch_1.pt")
    state = SimpleNamespace(head=torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="latest"):
        restore_checkpoint("latest", state)
    state.model, _ = create_model(MODEL, device="cpu")
    with pytest.raises(ValueError, match="no DINO head"):
        restore_checkpoint(path, state)


def test_jax_export_torch_checkpoint_loads_strictly_with_the_same_features(tmp_path):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train.checkpoint import (
        export_torch_checkpoint,
    )

    jmodel, variables = jax_clip(TINY_CFG, seed=3)
    path = str(tmp_path / "final_torch_state.pt")
    export_torch_checkpoint(SimpleNamespace(params={"model": variables["params"]}), 4, "run",
                            path)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert set(saved) == {"epoch", "name", "state_dict"} and saved["epoch"] == 4
    model, _ = create_model(MODEL, pretrained=path, device="cpu")  # strict=True inside
    size, ctx = TINY_CFG["vision_cfg"]["image_size"], TINY_CFG["text_cfg"]["context_length"]
    px, ids = images(3, size), token_ids(3, ctx)
    want = jmodel.apply(variables, jnp.asarray(px), jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(px), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=FEATURE_TOL, rtol=0)


def test_async_save_equals_the_synchronous_one_after_the_next_step(tmp_path):
    """An asynchronous save holds the state of its call, tensor for
    tensor, though the next step updates the parameters and the AdamW
    moments in place before the background write has run."""
    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg,
        DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import (
        save_checkpoint,
        wait_for_checkpoints,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg,
        TrainState,
        make_train_step,
        train_parameters,
    )

    model, _ = create_model(MODEL, device="cpu")
    head = DinoProjectionHead(TINY_CFG["embed_dim"], 24)
    opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(lr=1e-2),
                                   scheduler.const_lr(1e-2, 0, 3))
    state = TrainState(model, head, opt, 0, torch.Generator().manual_seed(0))
    step = make_train_step(model, StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5)),
                           head)
    size, ctx = TINY_CFG["vision_cfg"]["image_size"], TINY_CFG["text_cfg"]["context_length"]
    batch = {"images": torch.from_numpy(images(4, size)),
             "texts": torch.from_numpy(token_ids(4, ctx)).long(),
             "dino_features": torch.from_numpy(
                 np.random.default_rng(9).normal(size=(4, 24)).astype(np.float32))}
    state, _ = step(state, batch)
    sync = save_checkpoint(str(tmp_path / "sync"), state, 1, data_order={"seed": 0})
    later = save_checkpoint(str(tmp_path / "async"), state, 1, data_order={"seed": 0},
                            async_save=True)
    state, _ = step(state, batch)  # in place, while the write may still run
    wait_for_checkpoints()
    got, want = (torch.load(p, map_location="cpu", weights_only=True) for p in (later, sync))
    assert got.keys() == want.keys()

    def same(a, b, where):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), where
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), where
            for k in b:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    same(got, want, "checkpoint")
    moved = dict(model.named_parameters())["visual.conv1.weight"]
    assert not torch.equal(moved, want["state_dict"]["visual.conv1.weight"])


@pytest.mark.parametrize("opt,mu", [("adamw", None), ("adamw", "bfloat16"),
                                    ("lion", "bfloat16"), ("lamb", None),
                                    ("adafactor", "bfloat16"), ("sgd", None), ("fused", None)])
def test_each_family_state_makes_a_round_trip(tmp_path, opt, mu):
    """Two steps, a save, a restore into a fresh state: every moment back in
    its dtype (bf16 stays bf16), factored statistics in their shapes, bit
    for bit; a third step from the restored state equals the third step of
    the run that saved."""
    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg,
        DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.checkpoint import save_checkpoint
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg,
        TrainState,
        make_train_step,
        train_parameters,
    )

    def fresh():
        model, _ = create_model(WIDE_MODEL, device="cpu", seed=2)
        torch.manual_seed(0)
        head = DinoProjectionHead(TINY_CFG["embed_dim"], 24)
        cfg = optim.OptimCfg(lr=1e-2, opt="adamw" if opt == "fused" else opt, mu_dtype=mu)
        build = optim.build_fused_optimizer if opt == "fused" else optim.build_optimizer
        o, _ = build(train_parameters(model, head), cfg, scheduler.const_lr(1e-2, 0, 3))
        state = TrainState(model.train(), head, o, 0, torch.Generator().manual_seed(0))
        step = make_train_step(model, StepCfg(loss_type="dino",
                                              dino=DinoLossCfg(lambda_soft=0.5)), head)
        return state, step

    size, ctx = TINY_CFG["vision_cfg"]["image_size"], TINY_CFG["text_cfg"]["context_length"]
    batch = {"images": torch.from_numpy(images(4, size)),
             "texts": torch.from_numpy(token_ids(4, ctx)).long(),
             "dino_features": torch.from_numpy(
                 np.random.default_rng(9).normal(size=(4, 24)).astype(np.float32))}
    state, step = fresh()
    for _ in range(2):
        state, _ = step(state, batch)
    path = save_checkpoint(str(tmp_path), state, 1)
    saved = torch.load(path, map_location="cpu", weights_only=True)["optimizer"]
    restored, step2 = fresh()
    restored, *_ = restore_checkpoint(path, restored)

    def leaves(sd, prefix=""):
        for k, v in sd.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            elif isinstance(v, torch.Tensor):
                yield f"{prefix}{k}", v

    want = dict(leaves(state.optimizer.state_dict()))
    got = dict(leaves(restored.optimizer.state_dict()))
    assert got.keys() == want.keys() == dict(leaves(saved)).keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    if mu is not None:
        assert {v.dtype for k, v in got.items() if k.endswith(".mu")} == {torch.bfloat16}
    if opt == "adafactor":
        rows = {k: v.shape for k, v in got.items() if k.endswith(".v_row")}
        assert rows["state.visual.transformer.resblocks.0.attn.in_proj_weight.v_row"] == (128,)
        assert got["state.visual.transformer.resblocks.0.attn.in_proj_weight.v_col"].shape == (384,)
    state, _ = step(state, batch)
    restored, _ = step2(restored, batch)
    for (n, p), q in zip(state.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(p, q), n
