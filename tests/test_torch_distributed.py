"""The port's process-group runtime (``train/distributed.py``) and a
two-rank run of the training CLI.

* ``world_info_from_env`` and ``is_using_distributed`` against the JAX
  package's for the same launcher environments (torchrun, SLURM, OMPI,
  MPI, mixed, none).
* ``broadcast_object`` and ``all_gather_object``: identities in one
  process; on two spawned gloo ranks that joined through
  ``init_distributed_device`` from torchrun's variables.
* ``train.main`` on two gloo ranks (``tests/torch_dist_utils.py``, no JAX in
  the ranks): the tiny model on mini-Flickr CSV data with the precomputed
  DINO features, one epoch under ``--fsdp`` (and ``--save-on-preemption``,
  whose ranks agree at every step whether one was signalled), pre-train and
  epoch evaluation, the CLIP-blind check of both splits; both ranks log the same
  losses, each rank trains on its half of the epoch, the evaluations see
  every val row, rank 0 alone writes the run's files, and the checkpoint
  loads strictly into one process.
"""

import json
import os
from types import SimpleNamespace

import pytest

from refining_clip_via_dinov2_representations_torch.models import register_model_config
from refining_clip_via_dinov2_representations_torch.train import distributed as port_dist

from .torch_dist_utils import run_ranks
from .torch_port_utils import TINY_CFG

MODEL = "tiny-torch-dist-cli"
register_model_config(MODEL, TINY_CFG)

ENV_VARS = ("LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK",
            "RANK", "PMI_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "WORLD_SIZE",
            "PMI_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
ENVS = {
    "none": {},
    "torchrun": {"LOCAL_RANK": "1", "RANK": "3", "WORLD_SIZE": "4"},
    "slurm": {"SLURM_LOCALID": "2", "SLURM_PROCID": "6", "SLURM_NTASKS": "8"},
    "ompi": {"OMPI_COMM_WORLD_LOCAL_RANK": "0", "OMPI_COMM_WORLD_RANK": "1",
             "OMPI_COMM_WORLD_SIZE": "2"},
    "mpi": {"MPI_LOCALRANKID": "1", "PMI_RANK": "1", "PMI_SIZE": "2"},
    "mixed": {"LOCAL_RANK": "0", "SLURM_LOCALID": "5", "RANK": "2", "SLURM_PROCID": "7",
              "WORLD_SIZE": "1", "SLURM_NTASKS": "16"},
}


@pytest.mark.parametrize("env", list(ENVS))
def test_world_info_from_env_matches_jax(monkeypatch, env):
    from refining_clip_via_dinov2_representations_tpu.train import distributed as jax_dist

    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert port_dist.world_info_from_env() == jax_dist.world_info_from_env()
    assert port_dist.is_using_distributed() == jax_dist.is_using_distributed()


def test_objects_pass_unchanged_in_one_process():
    obj = {"a": [1, 2], "b": "x"}
    assert port_dist.broadcast_object(None, obj) is obj
    assert port_dist.all_gather_object(None, obj) == [obj]
    assert port_dist.data_group() is None


def _objects_worker(rank, world):
    args = SimpleNamespace(force_cpu=True, device=None, dist_url=None, dist_backend=None,
                           no_set_device_rank=False)
    device = port_dist.init_distributed_device(args)
    import torch.distributed as dist

    return {"args": (args.rank, args.local_rank, args.world_size, args.distributed, args.device),
            "device": str(device), "backend": dist.get_backend(),
            "broadcast": port_dist.broadcast_object(args, {"from": rank, "x": [rank] * 3}),
            "gathered": port_dist.all_gather_object(args, ("rank", rank)),
            "master": port_dist.is_master(args)}


def test_init_and_object_collectives_on_two_ranks():
    out = run_ranks(_objects_worker, 2, init=False)
    for rank, res in enumerate(out):
        assert res["args"] == (rank, rank, 2, True, "cpu")
        assert res["device"] == "cpu" and res["backend"] == "gloo"
        assert res["broadcast"] == {"from": 0, "x": [0, 0, 0]}
        assert res["gathered"] == [("rank", 0), ("rank", 1)]
        assert res["master"] == (rank == 0)


def _cli_worker(rank, world, argv):
    from refining_clip_via_dinov2_representations_torch.train.main import main

    return main(argv)


def test_two_rank_fsdp_cli_run_trains_evaluates_and_writes_once(tmp_path):
    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    argv = ["--model", MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", "8", "--workers", "1", "--logs",
            str(tmp_path), "--name", "run", "--precision", "fp32", "--force-cpu",
            "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode", "kl_teacher",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--dino_fts_path_val", d["dino_feats"], "--dino_index_map_path_val",
            d["dino_index_map"], "--run_clip_blind", "--clip_blind_val_key", "val",
            "--log-every-n-steps", "1", "--epochs", "1", "--fsdp", "--fsdp-min-size", "1024",
            "--save-on-preemption"]
    first, second = run_ranks(_cli_worker, 2, argv, init=False)
    # 40 caption rows: 20 a rank, two steps of 8
    assert [r["step"] for r in first] == [1, 2] and first == second
    assert all(r["total_loss"] > 0 and r["soft_loss"] > 0 for r in first)
    run = tmp_path / "run"
    with open(run / "loss_steps.json") as f:
        assert json.load(f) == first
    with open(run / "final_itm_results.json") as f:
        results = json.load(f)
    assert [e["epoch"] for e in results] == [0, 1]
    for entry in results:
        (val,) = entry["results"]
        assert val["metrics"]["num_samples"] == 20  # every val row on every rank
    for split, n in (("val", 4), ("train", 8)):
        with open(run / "clip_blind" / f"clip_blind_{split}.json") as f:
            assert json.load(f)["total_pairs"] == n * (n - 1) // 2
    assert sorted(os.listdir(run / "checkpoints")) == ["epoch_1.pt", "final_torch_state.pt"]
    saved = torch.load(run / "checkpoints" / "epoch_1.pt", map_location="cpu",
                       weights_only=True)
    assert saved["data_order"]["world"] == 2 and saved["step"] == 2
    model, _ = create_model(MODEL, str(run / "checkpoints" / "epoch_1.pt"), device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved["state_dict"][k], rtol=0, atol=0)
    assert "batch: 8/rank x 2 ranks = 16 global" in (run / "out.log").read_text()
