"""The training CLI at ``--mesh-model-axis 2`` on two gloo ranks.

A tiny EVA01 CLIP (registered with a tiny trunk in the port's
``EVA01_DIMS``) trains one epoch of synthetic data with Config 5's flags
(``--opt adafactor --adam-mu-dtype bfloat16 --grad-checkpointing
--remat-policy dots_with_no_batch_dims_saveable``) and the DINO-soft loss,
under ``--shard-opt-state``, on a ``(1, 2)`` mesh; the same flags in one
process give the same per-step losses (1e-5 relative) and an epoch
checkpoint with the same whole tensors (1e-5 relative, 5e-6 absolute; the
attention's packed QKV bias moves by adafactor's rounding noise, as
``tests/test_torch_dist_step.py`` says). Rank 0 alone writes the files, the
log names the mesh; one process refuses a model axis, and ``serve.py``
refuses one too.
"""

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.models import eva, register_model_config

from .torch_dist_utils import run_ranks

MODEL, TRUNK = "tiny-torch-tp-eva01", "eva_tiny_cli_patch8_16"
eva.EVA01_DIMS[TRUNK] = (32, 1, 4, 2.0, 8)  # width, layers, heads, mlp_ratio, patch
register_model_config(MODEL, {
    "custom_text": True, "embed_dim": 32,
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                 "layers": 1},
    "vision_cfg": {"image_size": 16, "timm_model_name": TRUNK, "timm_model_pretrained": False,
                   "timm_pool": "token", "timm_proj": None}})


def _argv(logs, name):
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "1", "--force-cpu", "--precision", "fp32",
            "--workers", "1", "--logs", logs, "--name", name, "--log-every-n-steps", "1",
            "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode", "kl_teacher",
            "--lambda_weighted", "0.3", "--opt", "adafactor", "--adam-mu-dtype", "bfloat16",
            "--grad-checkpointing", "--remat-policy", "dots_with_no_batch_dims_saveable",
            "--lr", "1e-3", "--eps", "1e-3"]


def _cli_worker(rank, world, argv):
    from refining_clip_via_dinov2_representations_torch.train.main import main

    return main(argv)


def test_mesh_model_axis_2_trains_as_one_process(tmp_path):
    import torch

    from refining_clip_via_dinov2_representations_torch.train.main import main

    want = main(_argv(str(tmp_path), "one"))
    argv = _argv(str(tmp_path), "tp") + ["--mesh-model-axis", "2", "--shard-opt-state",
                                         "--fsdp-min-size", "1024"]
    first, second = run_ranks(_cli_worker, 2, argv, init=False)
    assert first == second and [r["step"] for r in first] == [1, 2, 3, 4]
    for got, ref in zip(first, want):
        for k in ("total_loss", "classic_loss", "soft_loss", "weighted_loss"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=f"{got['step']} {k}")
    run = tmp_path / "tp"
    assert "mesh: {'data': 1, 'model': 2}" in (run / "out.log").read_text()
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "epoch_1.pt", "final_torch_state.pt"]
    got = torch.load(run / "checkpoints" / "epoch_1.pt", map_location="cpu", weights_only=True)
    ref = torch.load(tmp_path / "one" / "checkpoints" / "epoch_1.pt", map_location="cpu",
                     weights_only=True)
    for part in ("state_dict", "dino_head"):
        assert set(got[part]) == set(ref[part])
        for k, v in ref[part].items():
            if not k.endswith("attn.in_proj_bias"):
                np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), rtol=1e-5,
                                           atol=5e-6, err_msg=f"{part} {k}")


def test_a_model_axis_needs_a_process_group(tmp_path):
    from refining_clip_via_dinov2_representations_torch.train.main import main

    with pytest.raises(ValueError, match="--mesh-model-axis need a process group"):
        main(_argv(str(tmp_path), "one") + ["--mesh-model-axis", "2"])


def test_serve_refuses_a_model_axis():
    """Without a process group: the split model's ranks come from torchrun
    (``tests/test_torch_tp_serve.py`` serves under two)."""
    from refining_clip_via_dinov2_representations_torch.serve import main

    with pytest.raises(ValueError, match="--mesh-model-axis 2 needs a process group"):
        main(["--model", MODEL, "--mesh-model-axis", "2"])
