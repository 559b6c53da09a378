"""The port's training CLI: flags against the JAX package's, a two-step CPU
run whose checkpoint loads strictly, a CSV run with evaluation, CLIP-blind
and resume that writes every artifact, a CSV run with the live DINOv2
teacher, a run from pretrained weights with QuickGELU and zero-shot
ImageNet against the JAX CLI's, the transforms the image flags build, and
the refusals."""

import json
import math
import os

import numpy as np
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


# every flag of the CSV, evaluation, CLIP-blind and checkpoint slice, set
EVAL_FLAGS = ["--model", "ViT-B-16", "--train-data", "t.csv", "--val-data", "v.csv",
              "--flickr-val-data", "f.csv", "--mscoco_val", "m.csv", "--val-num-samples", "9",
              "--aug-cfg", "scale=(0.5,1.0)", "use_timm=True", "color_jitter=0.4",
              "--image-mean", "0.5", "0.5", "0.5", "--image-std", "0.2", "0.2", "0.2",
              "--image-interpolation", "bilinear", "--image-resize-mode", "squash",
              "--dino_index_map_path", "m.pt", "--dino_fts_path_val", "fv.pt",
              "--dino_index_map_path_val", "mv.pt", "--run_clip_blind",
              "--clip_blind_dino_feats", "cb.pt", "--clip_blind_dino_index_map", "cbm.pt",
              "--resume", "latest", "--save-most-recent", "--delete-previous-checkpoint",
              "--log-checkpoint", "--log-local"]


def _argv(tmp_path, *extra):
    return ["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "1", "--workers", "2", "--logs", str(tmp_path),
            "--name", "run", "--precision", "fp32", *extra]


@pytest.mark.parametrize("argv", [["--model", "ViT-B-16"], ["--model", "RN50", "--lr", "1e-4"],
                                  ["--model", "ViT-B-32", "--use_dino_general",
                                   "--lambda_soft", "0.5", "--soft_mode", "kl_teacher"],
                                  ["--model", "ViT-L-14-336", "--attn-impl", "flash",
                                   "--grad-checkpointing", "--force-image-size", "384"],
                                  EVAL_FLAGS, ["--model", "ViT-B-16", "--flickr30k_val", "f.csv",
                                               "--mscoco-val-data", "m.csv"]])
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


@pytest.mark.parametrize("extra", [["--report-to", "wandb"], ["--accum-freq", "2"],
                                   ["--imagenet-train", "x"], ["--siglip"],
                                   ["--distill-model", "ViT-B-32"], ["--fsdp"],
                                   ["--opt", "lion"], ["--save-on-preemption"],
                                   ["--grad-checkpointing", "--remat-policy", "dots_saveable"],
                                   ["--force-custom-text"]])
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


def test_csv_run_with_eval_clip_blind_and_resume_writes_every_artifact(tmp_path):
    """The thesis protocol at a tiny size: CSV data with the DINO join,
    pre-train and per-epoch evaluation, best-epoch tracking, checkpoints,
    the CLIP-blind check on both splits; then ``--resume latest`` for one
    more epoch, whose artifacts cover the whole run."""
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    argv = ["--model", MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", "8", "--workers", "2", "--logs",
            str(tmp_path), "--name", "run", "--precision", "fp32", "--force-cpu",
            "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode", "kl_teacher",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--dino_fts_path_val", d["dino_feats"], "--dino_index_map_path_val",
            d["dino_index_map"], "--run_clip_blind", "--clip_blind_val_key", "val",
            "--log-every-n-steps", "2"]
    first = main(argv + ["--epochs", "1"])
    second = main(argv + ["--epochs", "2", "--resume", "latest"])
    run = tmp_path / "run"
    assert [r["step"] for r in first] == [2, 4, 5] and [r["step"] for r in second] == [
        2, 4, 5, 6, 8, 10]
    with open(run / "final_itm_results.json") as f:
        results = json.load(f)
    assert [e["epoch"] for e in results] == [0, 1, 2]
    for entry in results:
        (val,) = entry["results"]
        assert val["val_name"] == "val" and val["metrics"]["num_samples"] == 20
        assert all(math.isfinite(val["metrics"][k]) for k in (
            "text_to_image_R@1", "image_to_text_R@10", "clip_val_loss", "modality_gap"))
    with open(run / "best_metrics.json") as f:
        assert json.load(f)["epoch"] in (1, 2)
    assert (run / "itm_scores.csv").read_text().splitlines()[0].startswith("epoch,txt_r1,")
    assert len((run / "itm_scores.csv").read_text().splitlines()) == 4
    for split, images in (("val", 4), ("train", 8)):
        with open(run / "clip_blind" / f"clip_blind_{split}.json") as f:
            stats = json.load(f)
        assert stats["total_pairs"] == images * (images - 1) // 2
        assert len(stats["results"]) == 3
        assert (run / "clip_blind" / f"clip_blind_{split}_top_pairs.csv").exists()
    assert sorted(os.listdir(run / "checkpoints")) == ["epoch_1.pt", "epoch_2.pt"]
    assert "resuming checkpoint" in (run / "out.log").read_text()


def _tiny_teacher_dir(path) -> str:
    """A seeded tiny DINOv2 saved in the HF layout (28-px native grid)."""
    from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
        Dinov2, Dinov2Cfg, save_hf_checkpoint,
    )

    cfg = Dinov2Cfg(hidden_size=32, layers=2, heads=4, mlp_ratio=2, native_image_size=28)
    return save_hf_checkpoint(Dinov2(cfg).init_weights(seed=0), str(path))


def test_live_teacher_csv_run_writes_soft_loss_and_both_clip_blind_files(tmp_path):
    """The live-teacher protocol (``tests/test_dino_workflow_e2e.py``'s JAX
    case): no ``--dino_fts_path`` anywhere; the teacher from
    ``--dino_model_name`` runs inside the step and feeds the CLIP-blind check
    of both splits, with no store and no index map; the DINO head takes the
    teacher's width and the checkpoint holds no teacher weight."""
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    records = main(["--model", MODEL, "--train-data", d["train_csv"], "--val-data",
                    d["val_csv"], "--dataset-type", "csv", "--batch-size", "8", "--workers",
                    "2", "--logs", str(tmp_path), "--name", "live", "--precision", "fp32",
                    "--force-cpu", "--epochs", "1", "--warmup", "1", "--use_dino_general",
                    "--soft_mode", "kl_teacher", "--lambda_soft", "0.5", "--dino_model_name",
                    _tiny_teacher_dir(tmp_path / "teacher"), "--run_clip_blind",
                    "--log-every-n-steps", "1"])
    base = tmp_path / "live"
    with open(base / "loss_steps.json") as f:
        steps = json.load(f)
    assert steps == records and len(steps) == 5
    assert any(s.get("soft_loss", 0) > 0 for s in steps), "the live teacher gave no soft term"
    for split, images in (("val", 4), ("train", 8)):
        with open(base / "clip_blind" / f"clip_blind_{split}.json") as f:
            stats = json.load(f)
        assert stats["total_pairs"] == images * (images - 1) // 2
        assert stats["results"]
    saved = torch.load(base / "checkpoints" / "epoch_1.pt", map_location="cpu",
                       weights_only=True)
    assert saved["dino_head"]["fc2.weight"].shape[0] == 32  # the teacher's width
    model, _ = create_model(MODEL, str(base / "checkpoints" / "epoch_1.pt"), device="cpu")
    assert set(saved["state_dict"]) == set(model.state_dict())


def test_dino_model_name_without_local_files_raises_naming_the_paths(tmp_path):
    hub = tmp_path / "hub"
    with pytest.raises(FileNotFoundError, match="does not download") as err:
        main(_argv(tmp_path, "--force-cpu", "--use_dino_general", "--dino_model_name",
                   "facebook/dinov2-small", "--cache-dir", str(hub)))
    assert str(hub / "models--facebook--dinov2-small" / "snapshots") in str(err.value)
    assert "'facebook/dinov2-small'" in str(err.value)


def test_live_teacher_without_force_cpu_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        main(_argv(tmp_path, "--use_dino_general", "--dino_model_name",
                   _tiny_teacher_dir(tmp_path / "teacher")))


def _reseed(transform, seed):
    """Seeds, in place, the generators a train transform's closure holds."""
    import random

    for cell in transform._fn.__closure__:
        obj = cell.cell_contents
        if isinstance(obj, random.Random):
            obj.seed(seed)
        elif isinstance(obj, np.random.Generator):
            obj.bit_generator.state = np.random.default_rng(seed).bit_generator.state
    return transform


def test_image_flags_build_the_jax_transforms():
    """``--aug-cfg`` and the ``--image-*`` overrides give the transforms the
    JAX CLI builds (the train ones reseeded alike): pixels within 1e-6."""
    from PIL import Image

    from refining_clip_via_dinov2_representations_tpu.transform import (
        PreprocessCfg as JaxCfg,
        image_transform_v2 as jax_transform,
        merge_preprocess_kwargs,
    )
    from refining_clip_via_dinov2_representations_torch.train.main import build_transforms
    from refining_clip_via_dinov2_representations_torch.transform import PreprocessCfg

    args = params.parse_args(EVAL_FLAGS)
    train, val = build_transforms(args, PreprocessCfg(size=24))
    cfg = JaxCfg(**merge_preprocess_kwargs(
        JaxCfg(size=24), mean=args.image_mean, std=args.image_std,
        interpolation=args.image_interpolation, resize_mode=args.image_resize_mode))
    assert val.mean == tuple(cfg.mean) == (0.5, 0.5, 0.5) and cfg.resize_mode == "squash"
    want_val = jax_transform(cfg, is_train=False)
    want_train = jax_transform(cfg, is_train=True, aug_cfg=args.aug_cfg)
    for t in (train, want_train):
        _reseed(t, 4)
    rng = np.random.default_rng(0)
    for hw in ((40, 30), (24, 24)):
        img = Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8))
        np.testing.assert_allclose(val(img), want_val(img), atol=1e-6, rtol=0)
        np.testing.assert_allclose(train(img), want_train(img), atol=1e-6, rtol=0)


def test_eval_only_run_matches_the_pretrain_evaluation(tmp_path):
    """Without ``--train-data`` the CLI evaluates every val key once, at
    epoch 0, and returns the results: the pre-train evaluation of a
    training run on the same weights."""
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=4, n_val=4, size_px=32, dino_dim=24)
    common = ["--model", MODEL, "--val-data", d["val_csv"], "--dataset-type", "csv",
              "--batch-size", "8", "--workers", "1", "--logs", str(tmp_path), "--precision",
              "fp32", "--force-cpu", "--seed", "7"]
    (got,) = main(common + ["--name", "eval"])
    main(common + ["--name", "train", "--train-data", d["train_csv"], "--epochs", "1"])
    with open(tmp_path / "train" / "final_itm_results.json") as f:
        (want,) = json.load(f)[0]["results"]
    assert got["val_name"] == want["val_name"] == "val"
    assert got["metrics"] == pytest.approx(want["metrics"], abs=1e-6)
    assert not (tmp_path / "eval" / "final_itm_results.json").exists()


def test_debug_and_log_local_log_into_out_log(tmp_path):
    """``--debug``: DEBUG-level logging into ``out.log``, the gradient norm in every
    record and anomaly detection around the run; ``--log-local`` changes
    nothing in one process, as in the JAX package."""
    records = main(_argv(tmp_path, "--force-cpu", "--debug", "--log-local",
                         "--log-every-n-steps", "2"))
    assert [r["step"] for r in records] == [2, 4]
    assert all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in records)
    import logging

    assert logging.getLogger().getEffectiveLevel() == logging.DEBUG
    assert "Train Epoch: 0 [4]" in (tmp_path / "run" / "out.log").read_text()
    assert not torch.is_anomaly_enabled()


def test_pretrained_quickgelu_zero_shot_run_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--pretrained <file> --force-quick-gelu --imagenet-val <folder>
    --zeroshot-frequency 1`` without train data (Config 1): the epoch-0
    evaluation, the 1000-class, 80-template zero-shot ImageNet top-1/top-5
    among it, equals the JAX CLI's on the same weights (retrieval recalls
    and zero-shot counts exactly, losses within 1e-5; the JAX CLI's
    evaluation read by wrapping its ``evaluate``). The pre-train evaluation
    of a training run is the eval-only run's
    (``test_eval_only_run_matches_the_pretrain_evaluation``)."""
    import importlib

    import jax
    from PIL import Image

    from refining_clip_via_dinov2_representations_tpu.models import (
        register_model_config as jax_register,
    )
    from refining_clip_via_dinov2_representations_tpu.train.main import main as jax_main
    from scripts.mini_flickr import generate

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )

    from .torch_port_utils import jax_clip

    jax_register(MODEL, TINY_CFG)
    d = generate(str(tmp_path / "data"), n_train=4, n_val=4, size_px=32, dino_dim=24)
    _, variables = jax_clip({**TINY_CFG, "quick_gelu": True}, seed=41)
    ckpt = str(tmp_path / "pretrained.bin")
    torch.save(jax_params_to_state_dict(variables["params"]), ckpt)
    rng = np.random.default_rng(0)
    for c in ("0", "1", "2", "10"):  # ImageNet-V2 layout: the folder is the class index
        (tmp_path / "v2" / c).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)).save(
                tmp_path / "v2" / c / f"{j}.png")
    common = ["--model", MODEL, "--val-data", d["val_csv"], "--dataset-type", "csv",
              "--workers", "1", "--precision", "fp32", "--seed", "7", "--pretrained", ckpt,
              "--force-quick-gelu", "--imagenet-val", str(tmp_path / "v2"),
              "--zeroshot-frequency", "1", "--logs", str(tmp_path), "--force-cpu"]
    # the JAX CLI's --batch-size is per device (its loaders take it times
    # the CPU devices): the port's one device gets the same batches
    (got,) = main(common + ["--name", "port", "--batch-size", str(4 * jax.device_count())])
    # the module, not the package's attribute of the same name (the function)
    jax_evaluate = importlib.import_module(
        "refining_clip_via_dinov2_representations_tpu.train.evaluate")
    recorded = []
    real = jax_evaluate.evaluate

    def recording(*args, **kwargs):
        recorded.append(real(*args, **kwargs))
        return recorded[-1]

    monkeypatch.setattr(jax_evaluate, "evaluate", recording)
    jax_main(common + ["--name", "jax", "--batch-size", "4"])
    (want,) = recorded
    got = got["metrics"]
    zs = {"imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5"}
    assert zs <= set(got) and set(got) == set(want)
    for k, v in want.items():
        if k in zs or "_R@" in k or k.endswith("_rank") or k in ("epoch", "num_samples"):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, abs=1e-5), k
    assert "force_quick_gelu: True" in (tmp_path / "port" / "params.txt").read_text()
