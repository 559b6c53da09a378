"""Preemption saves and mid-epoch resume through the port's training CLI.

A SIGTERM raised by the train step itself after its k-th call (no
wall-clock timer) under ``--save-on-preemption`` ends the epoch at that
step boundary: ``epoch_0_preempt.pt`` holds ``step_in_epoch == k`` and
``--resume latest`` continues at step k + 1, so that the two runs'
``loss_steps.json`` records equal an uninterrupted run's exactly (fp32 on
the CPU, synthetic data whose batches depend only on the seeded order);
with ``--accum-freq 1`` and a synchronous save, and with ``--accum-freq 2``
and ``--async-checkpoint``. A changed ``--batch-size`` makes the resume redo
the epoch with a warning, as in the JAX CLI. ``--stop-after-steps`` takes
the same path: a ``_preempt`` save and no evaluation of that epoch.
"""

import json
import math
import os
import signal

import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import register_model_config
from refining_clip_via_dinov2_representations_torch.train import step as step_mod
from refining_clip_via_dinov2_representations_torch.train.main import main

from .torch_port_utils import TINY_CFG

MODEL = "tiny-torch-resume-test"
register_model_config(MODEL, TINY_CFG)


def _argv(logs, name, *extra):
    """16 synthetic samples at batch 4: 4 loader batches an epoch, two
    epochs; DINO-soft, every step logged."""
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "2", "--workers", "1", "--logs", str(logs),
            "--name", name, "--precision", "fp32", "--force-cpu", "--use_dino_general",
            "--soft_mode", "kl_teacher", "--lambda_soft", "0.5", "--synthetic-dino-dim", "24",
            "--lr", "1e-3", "--warmup", "2", "--log-every-n-steps", "1", "--seed", "3", *extra]


def _sigterm_after(monkeypatch, k: int):
    """The CLI's train step raises SIGTERM in this process after its k-th
    call."""
    real = step_mod.make_train_step

    def make(*args, **kwargs):
        inner, calls = real(*args, **kwargs), []

        def train_step(state, batch):
            out = inner(state, batch)
            calls.append(1)
            if len(calls) == k:
                signal.raise_signal(signal.SIGTERM)
            return out

        return train_step

    monkeypatch.setattr(step_mod, "make_train_step", make)


def _records(logs, name):
    with open(os.path.join(logs, name, "loss_steps.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [[], ["--accum-freq", "2", "--async-checkpoint"]],
                         ids=["accum1-sync", "accum2-async"])
def test_sigterm_preemption_resumes_mid_epoch_exactly(tmp_path, monkeypatch, extra):
    accum = 2 if "--accum-freq" in extra else 1
    k = 4 // accum // 2  # half way through epoch 0
    straight = main(_argv(tmp_path, "straight", *extra))
    before = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as m:
        _sigterm_after(m, k)
        first = main(_argv(tmp_path, "run", "--save-on-preemption", *extra))
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is restored
    ckpts = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["epoch_0_preempt.pt", "final_torch_state.pt"]
    saved = torch.load(ckpts / "epoch_0_preempt.pt", map_location="cpu", weights_only=True)
    assert (saved["epoch"], saved["step"], saved["step_in_epoch"]) == (0, k, k)
    assert saved["data_order"] == {"accum_freq": accum, "batch_size": 4, "seed": 3, "world": 1}
    assert [r["step"] for r in first] == list(range(1, k + 1))
    assert "preemption: saving epoch_0_preempt" in (tmp_path / "run" / "out.log").read_text()

    second = main(_argv(tmp_path, "run", "--save-on-preemption", "--resume", "latest", *extra))
    assert second[k]["step"] == k + 1 and second[k]["epoch"] == 0
    assert len(straight) == 2 * 4 // accum
    assert _records(tmp_path, "run") == second == straight == _records(tmp_path, "straight")
    got, want = (torch.load(tmp_path / name / "checkpoints" / "epoch_2.pt", map_location="cpu",
                            weights_only=True)["state_dict"] for name in ("run", "straight"))
    for key, v in want.items():  # the same weights at the end
        torch.testing.assert_close(got[key], v, rtol=0, atol=0)


def test_changed_batch_size_redoes_the_preempted_epoch(tmp_path, monkeypatch):
    with monkeypatch.context() as m:
        _sigterm_after(m, 3)
        main(_argv(tmp_path, "run", "--save-on-preemption"))
    records = main(_argv(tmp_path, "run", "--resume", "latest", "--batch-size", "8"))
    log = (tmp_path / "run" / "out.log").read_text()
    assert "data-order flags changed" in log and "redoing epoch 0 from its start" in log
    # the optimizer steps already taken are kept; epoch 0 runs both of its
    # batches of 8 again, then epoch 1
    assert [(r["step"], r["epoch"]) for r in records] == (
        [(s, 0) for s in range(1, 6)] + [(s, 1) for s in range(6, 8)])


def test_stop_after_steps_saves_preempt_and_skips_the_epoch_evaluation(tmp_path):
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    argv = ["--model", MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", "8", "--workers", "1", "--logs",
            str(tmp_path), "--name", "run", "--precision", "fp32", "--force-cpu", "--epochs",
            "2", "--log-every-n-steps", "1", "--use_dino_general", "--lambda_soft", "0.5",
            "--soft_mode", "kl_teacher", "--dino_fts_path", d["dino_feats"],
            "--dino_index_map_path", d["dino_index_map"]]
    records = main(argv + ["--stop-after-steps", "7"])  # 40 caption rows: 5 steps an epoch
    run = tmp_path / "run"
    assert [(r["step"], r["epoch"]) for r in records] == [(s, 0) for s in range(1, 6)] + [
        (6, 1), (7, 1)]
    with open(run / "final_itm_results.json") as f:
        # the pre-train evaluation and epoch 0's; none of the stopped epoch
        assert [e["epoch"] for e in json.load(f)] == [0, 1]
    assert sorted(os.listdir(run / "checkpoints")) == ["epoch_1.pt", "epoch_1_preempt.pt",
                                                       "final_torch_state.pt"]
    saved = torch.load(run / "checkpoints" / "epoch_1_preempt.pt", map_location="cpu",
                       weights_only=True)
    assert (saved["epoch"], saved["step"], saved["step_in_epoch"]) == (1, 7, 2)
    resumed = main(argv + ["--resume", "latest"])
    assert [r["step"] for r in resumed] == list(range(1, 11))
    assert all(math.isfinite(r["total_loss"]) for r in resumed)
    with open(run / "final_itm_results.json") as f:
        assert [e["epoch"] for e in json.load(f)] == [0, 1, 2]
