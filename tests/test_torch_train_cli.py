"""The port's training CLI: flags against the JAX package's, a two-step CPU
run whose checkpoint loads strictly, and the refusals."""

import json
import math
import os

import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.train import params
from refining_clip_via_dinov2_representations_torch.train.main import main

from .torch_port_utils import TINY_CFG

MODEL = "tiny-torch-cli-test"
register_model_config(MODEL, TINY_CFG)


def _argv(tmp_path, *extra):
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "1", "--workers", "2", "--logs", str(tmp_path),
            "--name", "run", "--precision", "fp32", *extra]


@pytest.mark.parametrize("argv", [["--model", "ViT-B-16"], ["--model", "RN50", "--lr", "1e-4"],
                                  ["--model", "ViT-B-32", "--use_dino_general",
                                   "--lambda_soft", "0.5", "--soft_mode", "kl_teacher"],
                                  ["--model", "ViT-L-14-336", "--attn-impl", "flash",
                                   "--grad-checkpointing", "--force-image-size", "384"]])
def test_flags_and_defaults_match_jax(argv):
    from refining_clip_via_dinov2_representations_tpu.train.params import (
        parse_args as jax_parse,
    )

    got, want = vars(params.parse_args(argv)), vars(jax_parse(argv))
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if v != want[k]} == {}


def test_force_cpu_run_writes_losses_and_a_checkpoint_that_loads_strictly(tmp_path):
    records = main(_argv(tmp_path, "--force-cpu", "--use_dino_general", "--soft_mode",
                         "kl_teacher", "--lambda_soft", "0.5", "--synthetic-dino-dim", "24",
                         "--log-every-n-steps", "1", "--stop-after-steps", "2"))
    run = tmp_path / "run"
    with open(run / "loss_steps.json") as f:
        logged = json.load(f)
    assert logged == records and [r["step"] for r in logged] == [1, 2]
    assert all(math.isfinite(r["total_loss"]) and r["soft_loss"] > 0 for r in logged)
    assert "use_dino_general: True" in (run / "params.txt").read_text()
    ckpt = run / "checkpoints" / "epoch_1.pt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert saved["step"] == 2 and set(saved["dino_head"]) == {
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    model, _ = create_model(MODEL, str(ckpt), device="cpu")  # strict=True inside
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved["state_dict"][k], atol=0, rtol=0)


def test_forced_size_checkpointed_flash_run(tmp_path):
    """``--force-image-size`` (the one-element list collapses, as in the JAX
    CLI), ``--grad-checkpointing`` and ``--attn-impl flash`` on the CPU: the
    data follow the forced size and the checkpoint loads at it."""
    records = main(_argv(tmp_path, "--force-cpu", "--force-image-size", "32",
                         "--grad-checkpointing", "--attn-impl", "flash",
                         "--stop-after-steps", "1", "--log-every-n-steps", "1"))
    assert [r["step"] for r in records] == [1] and math.isfinite(records[0]["total_loss"])
    params_txt = (tmp_path / "run" / "params.txt").read_text()
    assert "force_image_size: 32\n" in params_txt and "grad_checkpointing: True" in params_txt
    ckpt = tmp_path / "run" / "checkpoints" / "epoch_1.pt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    assert tuple(saved["visual.positional_embedding"].shape) == (17, 32)  # (32 / 8)^2 + 1
    model, pp = create_model(MODEL, str(ckpt), device="cpu", force_image_size=32)
    assert pp.size == 32 and model.visual.image_size == (32, 32)


def test_clip_loss_run_without_dino(tmp_path):
    records = main(_argv(tmp_path, "--force-cpu", "--log-every-n-steps", "2"))
    assert [r["step"] for r in records] == [2, 4]
    assert all("contrastive_loss" in r for r in records)
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "epoch_1.pt")


def test_without_force_cpu_the_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        main(_argv(tmp_path))


@pytest.mark.parametrize("extra", [["--val-data", "val.csv"], ["--accum-freq", "2"],
                                   ["--resume", "latest"], ["--siglip"],
                                   ["--dino_model_name", "facebook/dinov2-small"], ["--fsdp"],
                                   ["--opt", "lion"], ["--train-data", "train.csv"],
                                   ["--grad-checkpointing", "--remat-policy", "dots_saveable"]])
def test_unported_flags_raise_at_startup(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="no .* yet"):
        main(_argv(tmp_path, "--force-cpu", *extra))
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("precision", ["amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16",
                                       "pure_bf16", "pure_fp16", "fp32"])
def test_precision_names_map_as_in_jax(precision):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        _precision_to_dtype as jax_map,
    )
    from refining_clip_via_dinov2_representations_tpu.train import precision as jax_precision
    from refining_clip_via_dinov2_representations_torch.models.factory import (
        _precision_to_dtype,
    )
    from refining_clip_via_dinov2_representations_torch.train import precision as port_precision

    def name(d):
        if d is None:
            return None
        return str(d).split(".")[-1] if isinstance(d, torch.dtype) else jnp.dtype(d).name

    assert tuple(map(name, _precision_to_dtype(precision))) == tuple(map(name, jax_map(precision)))
    for fn in ("get_cast_dtype", "get_input_dtype"):
        assert name(getattr(port_precision, fn)(precision)) == name(
            getattr(jax_precision, fn)(precision))
    model, _ = create_model(MODEL, precision=precision, device="cpu")
    compute, params_dtype = _precision_to_dtype(precision)
    assert model.compute_dtype == compute
    assert {p.dtype for p in model.parameters()} == {params_dtype}
