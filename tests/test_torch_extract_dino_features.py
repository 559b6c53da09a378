"""The port's DINOv2 feature extractor against the JAX package's.

Both CLIs read one mini-Flickr CSV (five caption rows an image) and one
seeded teacher directory in the HF layout (``models/dinov2.py:
save_hf_checkpoint``, which the JAX loader reads through transformers):
the index maps must be identical and the rows within
2e-4 (the fp32 teacher tolerance of ``tests/test_torch_dinov2.py``). The
port's output is then read by ``DinoFeatureStore``, passes
``CsvDataset._validate_dino_map`` and trains through the port's CLI. The
``cuda``-marked test runs the extractor on the card against ``--force-cpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.eval import extract_dino_features
from refining_clip_via_dinov2_representations_torch.models import register_model_config
from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
    Dinov2,
    Dinov2Cfg,
    save_hf_checkpoint,
)
from refining_clip_via_dinov2_representations_torch.train.data import (
    CsvDataset,
    DinoFeatureStore,
    load_dino_index_map,
)
from refining_clip_via_dinov2_representations_torch.train.main import main as train_main

from .torch_port_utils import DINO_TINY, TINY_CFG

MODEL = "tiny-torch-extract-test"
register_model_config(MODEL, TINY_CFG)


@pytest.fixture()
def mini(tmp_path):
    """(dataset paths, teacher directory): 6 train and 3 val images at 32 px,
    a teacher whose 3x3 position table each 28-px call resizes to 2x2."""
    from scripts.mini_flickr import generate

    d = generate(str(tmp_path / "data"), n_train=6, n_val=3, size_px=32, dino_dim=24)
    teacher = save_hf_checkpoint(Dinov2(Dinov2Cfg(**DINO_TINY)).init_weights(seed=5),
                                 str(tmp_path / "teacher"))
    return d, teacher


def _extract(tmp_path, csv, teacher, tag, *extra):
    feats, index = str(tmp_path / f"{tag}.npy"), str(tmp_path / f"{tag}.json")
    return ["--csv", csv, "--dino-model", teacher, "--image-size", "28", "--batch-size", "4",
            "--out-feats", feats, "--out-map", index, *extra], feats, index


def test_port_extractor_matches_jax(tmp_path, mini):
    from refining_clip_via_dinov2_representations_tpu.eval.extract_dino_features import (
        main as jax_main,
    )

    d, teacher = mini
    argv, feats, index = _extract(tmp_path, d["train_csv"], teacher, "port", "--force-cpu")
    assert extract_dino_features.main(argv) == (feats, index)
    jargv, jfeats, jindex = _extract(tmp_path, d["train_csv"], teacher, "jax")
    jax_main(jargv)
    with open(index) as f, open(jindex) as g:
        got_map, want_map = json.load(f), json.load(g)
    assert got_map == want_map and len(got_map["path_to_index"]) == 6
    got, want = np.load(feats), np.load(jfeats)
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_extracted_store_feeds_the_csv_dataset_and_the_cli(tmp_path, mini):
    d, teacher = mini
    argv, feats, index = _extract(tmp_path, d["train_csv"], teacher, "train", "--force-cpu")
    extract_dino_features.main(argv)
    store, mapping = DinoFeatureStore(feats), load_dino_index_map(index)
    assert store.shape == (6, 32) and sorted(mapping.values()) == list(range(6))
    ds = CsvDataset(d["train_csv"], lambda img: np.zeros((16, 16, 3), np.float32), "filepath",
                    "title", dino_index_map=mapping)
    assert len(ds) == 30 and {int(ds[i]["dino_idx"]) for i in range(len(ds))} == set(range(6))
    vargv, vfeats, vindex = _extract(tmp_path, d["val_csv"], teacher, "val", "--force-cpu")
    extract_dino_features.main(vargv)
    records = train_main(["--model", MODEL, "--train-data", d["train_csv"], "--val-data",
                          d["val_csv"], "--dataset-type", "csv", "--batch-size", "10",
                          "--workers", "1", "--logs", str(tmp_path / "logs"), "--name", "run",
                          "--precision", "fp32", "--force-cpu", "--epochs", "1",
                          "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode",
                          "kl_teacher", "--dino_fts_path", feats, "--dino_index_map_path", index,
                          "--dino_fts_path_val", vfeats, "--dino_index_map_path_val", vindex,
                          "--run_clip_blind", "--log-every-n-steps", "1"])
    assert len(records) == 3 and all(r["soft_loss"] > 0 for r in records)
    for split, n in (("val", 3), ("train", 6)):
        with open(tmp_path / "logs" / "run" / "clip_blind" / f"clip_blind_{split}.json") as f:
            assert json.load(f)["total_pairs"] == n * (n - 1) // 2


def test_extractor_without_force_cpu_needs_a_card(tmp_path, mini):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    d, teacher = mini
    argv, feats, _ = _extract(tmp_path, d["val_csv"], teacher, "nocard")
    with pytest.raises(RuntimeError, match="cuda"):
        extract_dino_features.main(argv)
    assert not os.path.exists(feats)


@pytest.mark.cuda
def test_cuda_extractor_matches_force_cpu(tmp_path, mini):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    d, teacher = mini
    argv, feats, index = _extract(tmp_path, d["train_csv"], teacher, "cuda")
    before = fused_attention_fwd.launches
    extract_dino_features.main(argv)
    assert fused_attention_fwd.launches == before + 2 * 2  # two batches of 4, two layers
    cargv, cfeats, cindex = _extract(tmp_path, d["train_csv"], teacher, "cpu", "--force-cpu")
    extract_dino_features.main(cargv)
    with open(index) as f, open(cindex) as g:
        assert json.load(f) == json.load(g)
    np.testing.assert_allclose(np.load(feats), np.load(cfeats), atol=2e-4, rtol=2e-4)
