"""The port's Tracker, and Config 2 as ``docs/REPRODUCE.md`` publishes it
through the port's CLI with every artifact the JAX CLI writes.

* The JAX and the port Trackers take the same calls; both event files read
  back with TensorBoard's ``EventAccumulator`` (the port's as scalars,
  TensorFlow's as tensors) give the same (tag, step, value) triples,
  exactly in float32. Without ``tensorboard`` (and without ``wandb``) each
  backend is a no-op after one warning.
* Config 2's flags (``--pretrained openai --precision bf16 ...
  --report-to tensorboard --run_clip_blind``) run through the port's CLI,
  cut to: a tiny registered model in place of ViT-B-16, whose ``openai``
  tag resolves to seeded weights in a hub cache under ``--cache-dir``;
  mini-Flickr (8 train and 4 val images at 32 px, 24-dim DINO features) in
  place of CC3M and Flickr; batch 8 in place of 96; one epoch in place of
  10; on the CPU (``--force-cpu``) with one loader thread, and
  ``--copy-codebase``. The run writes TensorBoard events, ``loss_curves.png``
  and ``checkpoints/final_torch_state.pt``, which loads strictly, gives the
  last epoch checkpoint's features exactly and is read by the port's
  ``run_all_evals --checkpoint``; ``code/<package>`` holds the package
  without ``__pycache__``.
"""

import argparse
import json
import logging
import math
import os
import sys

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import pretrained
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train.loggers import Tracker
from refining_clip_via_dinov2_representations_torch.train.main import main

from .torch_port_utils import TINY_CFG, images, jax_clip, token_ids

MODEL = "tiny-torch-tracking-test"
register_model_config(MODEL, TINY_CFG)
PACKAGE = "refining_clip_via_dinov2_representations_torch"


def _drive(tracker):
    tracker.log_scalars({"total_loss": 2.5, "samples_per_s": 100.25}, step=1)
    tracker.log_scalars({"total_loss": 2.125, "samples_per_s": 120.5}, step=2)
    tracker.log_scalars({"text_to_image_R@1": 12.5, "clip_val_loss": 1.75}, step=1,
                        prefix="val/val")
    tracker.log_scalars({"retrieval_score": 40.0, "epoch": 1}, step=2, prefix="best")
    tracker.log_artifact(__file__)
    tracker.finish()


def _triples(log_dir, as_tensors: bool):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util.tensor_util import make_ndarray

    ea = EventAccumulator(os.path.join(log_dir, "tensorboard"))
    ea.Reload()
    if as_tensors:
        return {(tag, e.step, float(np.float32(make_ndarray(e.tensor_proto))))
                for tag in ea.Tags()["tensors"] for e in ea.Tensors(tag)}
    return {(tag, e.step, float(np.float32(e.value)))
            for tag in ea.Tags()["scalars"] for e in ea.Scalars(tag)}


def test_tracker_writes_the_jax_trackers_events(tmp_path, monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.train.loggers import Tracker as JaxTracker

    monkeypatch.delenv("MLFLOW_ENABLE", raising=False)
    _drive(Tracker(str(tmp_path / "port")))
    _drive(JaxTracker(str(tmp_path / "jax")))
    got, want = _triples(tmp_path / "port", False), _triples(tmp_path / "jax", True)
    assert len(want) == 8 and got == want
    assert ("val/val/text_to_image_R@1", 1, 12.5) in got


def test_tracker_without_its_packages_warns_once_each_and_does_nothing(tmp_path, monkeypatch,
                                                                     caplog):
    monkeypatch.delenv("MLFLOW_ENABLE", raising=False)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    args = argparse.Namespace(report_to="tensorboard,wandb", name="run", rank=0)
    with caplog.at_level(logging.WARNING):
        tracker = Tracker(str(tmp_path), args, enable_tb=True)
        _drive(tracker)
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2 and "tensorboard" in warnings[1] and "wandb" in warnings[0]
    assert tracker._tb is tracker._wandb is tracker._mlflow is None
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def config2(tmp_path_factory):
    """One run of Config 2's published flags, cut as the module docstring
    says."""
    from scripts.mini_flickr import generate

    root = tmp_path_factory.mktemp("config2")
    d = generate(str(root / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    _, variables = jax_clip(TINY_CFG, seed=12)
    snap = root / "hub" / "models--example--tiny-openai" / "snapshots" / "seeded"
    snap.mkdir(parents=True)
    torch.save(jax_params_to_state_dict(variables["params"]), snap / "open_clip_pytorch_model.bin")
    argv = ["--model", MODEL, "--pretrained", "openai", "--precision", "bf16",
            "--train-data", d["train_csv"], "--val-data", d["val_csv"], "--dataset-type", "csv",
            "--use_dino_general", "--soft_mode", "kl_teacher", "--lambda_soft", "0.5",
            "--teacher_temp", "0.15", "--use_projection", "--projection_type", "mlp",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--batch-size", "8", "--epochs", "1", "--warmup", "500", "--lr", "5e-4",
            "--report-to", "tensorboard", "--run_clip_blind",
            # the cuts' flags
            "--cache-dir", str(root / "hub"), "--force-cpu", "--workers", "1",
            "--log-every-n-steps", "1", "--copy-codebase", "--logs", str(root), "--name", "run"]
    with pytest.MonkeyPatch.context() as m:
        m.delenv("MLFLOW_ENABLE", raising=False)
        m.setitem(pretrained._PRETRAINED, MODEL,
                  {"openai": {"hf_hub": "example/tiny-openai/", "url": ""}})
        records = main(argv)
    return {"records": records, "run": root / "run", "data": d, "root": root,
            "weights": snap / "open_clip_pytorch_model.bin"}


def test_config2_published_flags_run_through_the_cli(config2):
    records, run = config2["records"], config2["run"]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5]  # 40 caption rows at batch 8
    assert all(math.isfinite(r["total_loss"]) and r["soft_loss"] > 0 for r in records)
    params_txt = (run / "params.txt").read_text()
    assert "report_to: tensorboard\n" in params_txt and "precision: bf16\n" in params_txt
    triples = _triples(run, False)
    tags = {t for t, _, _ in triples}
    assert {"train/total_loss", "train/samples_per_s", "val/val/text_to_image_R@1",
            "best/retrieval_score", "best/epoch"} <= tags
    steps = sorted(s for t, s, _ in triples if t == "train/total_loss")
    assert steps == [1, 2, 3, 4, 5]
    with open(run / "final_itm_results.json") as f:
        results = json.load(f)
    assert [e["epoch"] for e in results] == [0, 1]
    assert (run / "clip_blind" / "clip_blind_train.json").exists()
    # the pre-train evaluation is that of the tag's seeded file
    (got,) = main(["--model", MODEL, "--pretrained", str(config2["weights"]), "--precision",
                   "bf16", "--val-data", config2["data"]["val_csv"], "--dataset-type", "csv",
                   "--batch-size", "8", "--workers", "1", "--force-cpu", "--logs",
                   str(config2["root"]), "--name", "eval"])
    assert got["metrics"] == pytest.approx(results[0]["results"][0]["metrics"], abs=1e-6)


def test_final_artifacts_load_strictly_and_feed_the_offline_suite(config2, tmp_path):
    from refining_clip_via_dinov2_representations_torch.eval.run_all_evals import (
        main as all_evals_main,
    )

    run, d = config2["run"], config2["data"]
    assert (run / "loss_curves.png").stat().st_size > 0
    final = run / "checkpoints" / "final_torch_state.pt"
    saved = torch.load(final, map_location="cpu", weights_only=True)
    assert set(saved) == {"epoch", "name", "state_dict"} and saved["epoch"] == 1
    last, _ = create_model(MODEL, pretrained=str(run / "checkpoints" / "epoch_1.pt"),
                           device="cpu")
    exported, _ = create_model(MODEL, pretrained=str(final), device="cpu")  # strict inside
    size, ctx = TINY_CFG["vision_cfg"]["image_size"], TINY_CFG["text_cfg"]["context_length"]
    px, ids = torch.from_numpy(images(3, size)), torch.from_numpy(token_ids(3, ctx)).long()
    with torch.no_grad():
        a, b = last(px, ids), exported(px, ids)
    for k in ("image_features", "text_features", "logit_scale"):
        assert torch.equal(a[k], b[k]), k
    results = all_evals_main(["--train-csv", d["train_csv"], "--val-csv", d["val_csv"],
                              "--model", MODEL, "--checkpoint", str(final), "--out-dir",
                              str(tmp_path / "evals"), "--batch-size", "16", "--probe-epochs",
                              "2", "--force-cpu"])
    assert {"knn_top1", "linear_probe_top1"} <= set(results)
    assert (tmp_path / "evals" / "all_evals.json").exists()
    code = run / "code" / PACKAGE
    assert (code / "train" / "main.py").read_text() == open(sys.modules[main.__module__]
                                                             .__file__).read()
    copied = {os.path.relpath(os.path.join(dp, n), code)
              for dp, dns, ns in os.walk(code) for n in ns + dns}
    assert "train/main.py" in copied and "csrc/fused_attention_fwd.cu" in copied
    assert not any("__pycache__" in p or p.startswith("assets") or p.endswith(".so")
                   for p in copied)
