"""Remote sync and remote resume of the port's CLI, with a local directory
as the remote through ``--remote-sync-protocol fsspec`` (no network), as
``tests/test_remote_sync.py`` does for the JAX CLI: the verification sync
at the start, the daemon, the final sync (without ``epoch_latest``),
``--resume latest`` from the remote run onto a fresh ``--logs`` with the
run's records, and ``--resume file://...`` of one checkpoint into a
staging directory."""

import json
import os
import time

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.models import register_model_config
from refining_clip_via_dinov2_representations_torch.train.file_utils import start_sync_process
from refining_clip_via_dinov2_representations_torch.train.main import main

from .torch_port_utils import TINY_CFG

MODEL = "tiny-torch-remote-sync-test"
register_model_config(MODEL, TINY_CFG)


def _argv(logs, epochs, *extra):
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", str(epochs), "--workers", "1", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--force-cpu", "--logs", str(logs),
            "--name", "run", "--log-every-n-steps", "1", "--seed", "2", *extra]


def _remote(remote):
    return ["--remote-sync", str(remote), "--remote-sync-protocol", "fsspec"]


def test_remote_sync_and_resume_latest_from_the_remote(tmp_path):
    remote = tmp_path / "bucket"
    remote.mkdir()
    main(_argv(tmp_path / "logs1", 1, "--save-most-recent", *_remote(remote)))
    run = remote / "run"
    assert (run / "params.txt").exists() and (run / "loss_steps.json").exists()
    assert sorted(os.listdir(run / "checkpoints")) == ["epoch_1.pt", "final_torch_state.pt"]
    assert (tmp_path / "logs1" / "run" / "checkpoints" / "epoch_latest.pt").exists()
    with pytest.raises(ValueError, match="save-most-recent"):
        main(_argv(tmp_path / "logs2", 2, "--resume", "latest", "--save-most-recent",
                   *_remote(remote)))

    # a fresh --logs: the checkpoint and the records come from the remote
    logs2 = tmp_path / "logs2"
    records = main(_argv(logs2, 2, "--resume", "latest", *_remote(remote)))
    assert (logs2 / "run" / "checkpoints" / "epoch_1.pt").exists()
    assert [(r["step"], r["epoch"]) for r in records] == [(s, 0) for s in range(1, 5)] + [
        (s, 1) for s in range(5, 9)]
    assert np.isfinite(records[-1]["total_loss"])
    with open(run / "loss_steps.json") as f:  # the final sync carried the whole run back
        assert json.load(f) == records
    assert (run / "checkpoints" / "epoch_2.pt").exists()


def test_resume_from_a_checkpoint_url(tmp_path):
    main(_argv(tmp_path / "logs1", 1))
    url = "file://" + str(tmp_path / "logs1" / "run" / "checkpoints" / "epoch_1.pt")
    logs2 = tmp_path / "logs2"
    records = main(_argv(logs2, 2, "--resume", url))
    ckpts = logs2 / "run" / "checkpoints"
    # fetched into a staging directory, out of this run's own checkpoints
    assert (ckpts / "_remote_staging" / "epoch_1.pt").exists()
    assert sorted(os.listdir(ckpts)) == ["_remote_staging", "epoch_2.pt", "final_torch_state.pt"]
    assert [(r["step"], r["epoch"]) for r in records] == [(s, 1) for s in range(5, 9)]


def test_sync_daemon_mirrors_the_run_directory(tmp_path):
    local, remote = tmp_path / "run", tmp_path / "bucket"
    local.mkdir()
    (local / "a.txt").write_text("first")
    proc = start_sync_process(1, str(local), str(remote), "fsspec")
    proc.start()
    try:
        (local / "sub").mkdir()
        (local / "sub" / "b.txt").write_text("second")
        (local / "epoch_latest.pt").write_text("in flight")
        deadline = time.time() + 60
        while time.time() < deadline and not (remote / "sub" / "b.txt").exists():
            time.sleep(0.2)
        assert (remote / "sub" / "b.txt").read_text() == "second"
        assert (remote / "a.txt").read_text() == "first"
        assert not (remote / "epoch_latest.pt").exists()
    finally:
        proc.terminate()
        proc.join(timeout=10)
    assert not proc.is_alive()


@pytest.mark.parametrize("with_fsspec", [True, False], ids=["fsspec", "no-fsspec"])
def test_sync_skips_equal_sizes_and_reads_back_with_or_without_fsspec(tmp_path, monkeypatch,
                                                                      with_fsspec):
    """Where fsspec is missing (the card's machine may lack it) a local
    remote is copied with the standard library, and ``pt_load`` /
    ``check_exists`` read the local filesystem."""
    import torch

    from refining_clip_via_dinov2_representations_torch.train import file_utils

    if not with_fsspec:
        monkeypatch.setattr(file_utils, "fsspec", None)
    local, remote = tmp_path / "run", tmp_path / "bucket" / "run"
    (local / "checkpoints").mkdir(parents=True)
    torch.save({"x": torch.arange(3)}, local / "checkpoints" / "epoch_1.pt")
    (local / "checkpoints" / "epoch_latest.pt").write_text("in flight")
    (local / "notes.txt").write_text("abc")
    assert file_utils.remote_sync(str(local), "file://" + str(remote), "fsspec")
    assert sorted(os.listdir(remote / "checkpoints")) == ["epoch_1.pt"]
    (remote / "notes.txt").write_text("xyz")  # same size: not copied again
    (local / "more.txt").write_text("new")
    assert file_utils.remote_sync(str(local), "file://" + str(remote), "fsspec")
    assert (remote / "notes.txt").read_text() == "xyz" and (remote / "more.txt").exists()
    url = "file://" + str(remote / "checkpoints" / "epoch_1.pt")
    assert file_utils.check_exists(url) and not file_utils.check_exists(url + ".missing")
    assert torch.equal(file_utils.pt_load(url)["x"], torch.arange(3))
    assert not file_utils.remote_sync(str(local), str(remote), "ftp")
