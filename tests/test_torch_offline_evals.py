"""The offline acceptance tools in the port against the JAX package, on a
mini-Flickr set and one seeded tiny CLIP carried across by the exporter:
``extract_features`` within 1e-5 in fp32 (QuickGELU forced in both, the
checkpoint loaded with ``strict=False``), ``knn_top1``, ``eval_geometry`` and
``align_label_spaces`` exactly, ``linear_probe``'s best top-1 exactly and
each epoch's mean train loss within 1e-5, ``run_all_evals``' JSON within
1e-5, ``clip_blinds_cli``'s ``summary.json`` equal, and the feature files
read across the two packages."""

import json

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.eval import offline
from refining_clip_via_dinov2_representations_torch.eval.clip_blinds_cli import (
    main as blinds_main,
)
from refining_clip_via_dinov2_representations_torch.eval.run_all_evals import (
    main as all_evals_main,
)
from refining_clip_via_dinov2_representations_torch.models import register_model_config
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_params_to_state_dict,
)

from .torch_port_utils import TINY_CFG, jax_clip

TOL = 1e-5
MODEL = "tiny-torch-offline-test"
register_model_config(MODEL, TINY_CFG)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """mini-Flickr (8 + 4 images at 32 px, labels = the shape's class), a
    seeded tiny checkpoint, and the fp32 features of both CSVs extracted by
    the JAX package."""
    from scripts.mini_flickr import generate

    from refining_clip_via_dinov2_representations_tpu.eval import offline as jax_offline
    from refining_clip_via_dinov2_representations_tpu.models import (
        register_model_config as jax_register,
    )

    jax_register(MODEL, TINY_CFG)
    root = tmp_path_factory.mktemp("offline")
    d = generate(str(root / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    _, variables = jax_clip({**TINY_CFG, "quick_gelu": True}, seed=31)
    ckpt = str(root / "tiny.bin")
    torch.save(jax_params_to_state_dict(variables["params"]), ckpt)
    feats = {}
    for split in ("train", "val"):
        feats[split] = str(root / f"jax_{split}.npz")
        jax_offline.extract_features(d[f"{split}_csv"], feats[split], MODEL, checkpoint=ckpt,
                                     batch_size=16, precision="fp32")
    return {"root": root, "data": d, "ckpt": ckpt, "feats": feats}


def test_extract_features_matches_jax(setup):
    for split in ("train", "val"):
        out = str(setup["root"] / f"port_{split}.npz")
        offline.extract_features(setup["data"][f"{split}_csv"], out, MODEL,
                                 checkpoint=setup["ckpt"], batch_size=16, precision="fp32",
                                 device="cpu")
        got, want = offline.load_feats(out), offline.load_feats(setup["feats"][split])
        assert got[0].shape == want[0].shape == ({"train": 40, "val": 20}[split], 32)
        np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_bf16_extract_runs_close_to_fp32(setup):
    """The default precision: bf16 compute, features within bf16 rounding
    of fp32's (cosine >= 0.99)."""
    out = str(setup["root"] / "port_val_bf16.npz")
    offline.extract_features(setup["data"]["val_csv"], out, MODEL, checkpoint=setup["ckpt"],
                             batch_size=16, device="cpu")
    got, want = offline.load_feats(out)[0], offline.load_feats(setup["feats"]["val"])[0]
    assert (got * want).sum(-1).min() >= 0.99


@pytest.mark.parametrize("k", [3, 20])
def test_knn_and_geometry_equal_jax(setup, k):
    from refining_clip_via_dinov2_representations_tpu.eval import offline as jax_offline

    tr, va = setup["feats"]["train"], setup["feats"]["val"]
    assert offline.knn_top1(tr, va, k=k) == jax_offline.knn_top1(tr, va, k=k)
    assert offline.eval_geometry(va, n_pairs=500) == jax_offline.eval_geometry(va, n_pairs=500)


def test_align_label_spaces_equals_jax():
    from refining_clip_via_dinov2_representations_tpu.eval import offline as jax_offline

    ytr, yva = np.array([0, 1, 2, 1]), np.array([0, 1, 1])
    for ctr, cva in ((["a", "b", "c"], ["b", "d"]), (["a", "b"], ["a", "b"]), (None, ["a"])):
        got = offline.align_label_spaces(ytr, ctr, yva, cva)
        want = jax_offline.align_label_spaces(ytr, ctr, yva, cva)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, dtype=object),
                                          np.asarray(w, dtype=object))


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_linear_probe_matches_jax(setup, monkeypatch, wd):
    """Best top-1 equal; each epoch's mean train loss within 1e-5 (the JAX
    step's losses are read by wrapping ``jax.jit``)."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.eval import offline as jax_offline

    real_jit, jax_losses = jax.jit, []

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if fn.__name__ != "step":
            return jitted

        def step(*a):
            out = jitted(*a)
            jax_losses.append(float(out[2]))
            return out
        return step

    monkeypatch.setattr(jax, "jit", recording_jit)
    tr, va = setup["feats"]["train"], setup["feats"]["val"]
    kw = dict(epochs=5, lr=0.5, wd=wd, batch_size=16, seed=3)
    want = jax_offline.linear_probe(tr, va, **kw)
    history = []
    got = offline.linear_probe(tr, va, device="cpu", history=history, **kw)
    assert got == want
    per_epoch = np.asarray(jax_losses).reshape(5, 3).mean(axis=1)  # 40 rows, batches of 16
    np.testing.assert_allclose([h["loss"] for h in history], per_epoch, atol=TOL, rtol=0)
    assert max(h["top1"] for h in history) == got


def test_run_all_evals_json_matches_jax(setup, tmp_path):
    """Both orchestrators over the same fp32 features (``--skip-extract``):
    the same keys, values within 1e-5; then the port's full run, extraction
    included, writes the same keys."""
    import shutil

    from refining_clip_via_dinov2_representations_tpu.eval.run_all_evals import (
        main as jax_all_evals,
    )

    results = {}
    for name, fn, extra in (("port", all_evals_main, ["--force-cpu"]),
                            ("jax", jax_all_evals, [])):
        out = tmp_path / name
        out.mkdir()
        for split in ("train", "val"):
            shutil.copy(setup["feats"][split], out / f"{split}_feats.npz")
        fn(["--train-csv", setup["data"]["train_csv"], "--val-csv", setup["data"]["val_csv"],
            "--model", MODEL, "--out-dir", str(out), "--knn-k", "5", "--probe-epochs", "3",
            "--skip-extract", *extra])
        with open(out / "all_evals.json") as f:
            results[name] = json.load(f)
    assert set(results["port"]) == set(results["jax"]) == {
        "knn_top1", "linear_probe_top1", "uniformity", "pc1", "pc10", "pc100"}
    for k, v in results["jax"].items():
        assert results["port"][k] == pytest.approx(v, abs=TOL), k
    full = all_evals_main(["--train-csv", setup["data"]["train_csv"], "--val-csv",
                           setup["data"]["val_csv"], "--model", MODEL, "--checkpoint",
                           setup["ckpt"], "--out-dir", str(tmp_path / "full"), "--batch-size",
                           "16", "--probe-epochs", "2", "--force-cpu"])
    assert set(full) == set(results["jax"])
    assert (tmp_path / "full" / "train_feats.npz").exists()


@pytest.mark.parametrize("index_map", [True, False], ids=["index-map", "csv-order"])
def test_clip_blinds_cli_summary_equals_jax(setup, tmp_path, index_map):
    from refining_clip_via_dinov2_representations_tpu.eval.clip_blinds_cli import (
        main as jax_blinds,
    )

    d = setup["data"]
    if index_map:
        feats = ["--dino-feats", d["dino_feats"], "--dino-index-map", d["dino_index_map"]]
    else:  # the val rows of the store, in the CSV's order, as .npy
        rows = torch.load(d["dino_feats"], weights_only=True).numpy()[8:]
        np.save(tmp_path / "val_dino.npy", rows)
        feats = ["--dino-feats", str(tmp_path / "val_dino.npy")]
    summaries = {}
    for name, fn, extra in (("port", blinds_main, ["--force-cpu"]), ("jax", jax_blinds, [])):
        for thr in (("0.8", "0.3"), ("0.0", "0.9")):
            out = tmp_path / f"{name}_{thr[0]}"
            fn(["--csv", d["val_csv"], "--model", MODEL, "--checkpoint", setup["ckpt"],
                *feats, "--clip-thr", thr[0], "--dino-thr", thr[1], "--batch-size", "3",
                "--out-dir", str(out), "--save-pairs", *extra])
            with open(out / "summary.json") as f:
                summaries[name, thr] = json.load(f)
            summaries[name, thr, "txt"] = (out / "summary.txt").read_text()
            summaries[name, thr, "pairs"] = (out / "pairs.csv").read_text().splitlines()[0]
    for key in [k for k in summaries if k[0] == "jax"]:
        assert summaries[("port",) + key[1:]] == summaries[key], key
    assert summaries["port", ("0.0", "0.9")]["clip≥0.0_dino≤0.9"]["count"] > 0


def test_feature_files_cross_between_packages(tmp_path):
    from refining_clip_via_dinov2_representations_tpu.eval import offline as jax_offline

    rng = np.random.default_rng(0)
    feats, labels = rng.normal(size=(5, 4)).astype(np.float32), np.arange(5) % 2
    for suffix in (".pt", ".npz"):
        a, b = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
        offline.save_feats(a, feats, labels, ["x", "y"])
        jax_offline.save_feats(b, feats, labels, ["x", "y"])
        for path in (a, b):
            for load in (offline.load_feats, jax_offline.load_feats):
                f, y, c = load(path)
                np.testing.assert_array_equal(f, feats)
                np.testing.assert_array_equal(y, labels)
                assert list(c) == ["x", "y"]


def test_offline_cli_subcommands(setup, capsys):
    tr, va = setup["feats"]["train"], setup["feats"]["val"]
    offline.main(["knn", "--train", tr, "--val", va, "--k", "5"])
    assert "[done] kNN top1=" in capsys.readouterr().out
    offline.main(["geometry", "--feats", va, "--n-pairs", "100"])
    assert "[anisotropy]" in capsys.readouterr().out
    offline.main(["linear-probe", "--train", tr, "--val", va, "--epochs", "2", "--force-cpu"])
    assert "Linear probe best top1=" in capsys.readouterr().out
    out = str(setup["root"] / "cli_val.npz")
    offline.main(["extract", "--csv", setup["data"]["val_csv"], "--out", out, "--model", MODEL,
                  "--checkpoint", setup["ckpt"], "--precision", "fp32", "--force-cpu"])
    np.testing.assert_allclose(offline.load_feats(out)[0], offline.load_feats(va)[0],
                               atol=TOL, rtol=0)


def test_without_a_card_the_offline_clis_raise(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    d = setup["data"]
    with pytest.raises(RuntimeError, match="cuda"):
        all_evals_main(["--train-csv", d["train_csv"], "--val-csv", d["val_csv"], "--model",
                        MODEL, "--out-dir", str(tmp_path / "evals")])
    with pytest.raises(RuntimeError, match="cuda"):
        blinds_main(["--csv", d["val_csv"], "--model", MODEL, "--dino-feats", d["dino_feats"],
                     "--out-dir", str(tmp_path / "blind")])
    with pytest.raises(RuntimeError, match="cuda"):
        offline.linear_probe(setup["feats"]["train"], setup["feats"]["val"], epochs=1)


@pytest.mark.cuda
def test_cuda_extract_matches_force_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from scripts.mini_flickr import generate

    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    d = generate(str(tmp_path / "data"), n_train=8, n_val=4, size_px=32, dino_dim=24)
    ckpt = str(tmp_path / "seeded.bin")
    torch.save(build_model(parse_model_cfg(TINY_CFG), seed=5).state_dict(), ckpt)
    feats = {}
    for device in ("cuda", "cpu"):
        for split in ("train", "val"):
            feats[device, split] = str(tmp_path / f"{device}_{split}.npz")
            before = fused_attention_fwd.launches
            offline.extract_features(d[f"{split}_csv"], feats[device, split], MODEL,
                                     checkpoint=ckpt, batch_size=16, precision="fp32",
                                     device=device)
            if device == "cuda":
                torch.cuda.synchronize()
                batches = {"train": 3, "val": 2}[split]  # 40 and 20 rows
                assert fused_attention_fwd.launches == before + 2 * batches
    for split in ("train", "val"):
        np.testing.assert_allclose(offline.load_feats(feats["cuda", split])[0],
                                   offline.load_feats(feats["cpu", split])[0], atol=1e-4,
                                   rtol=0)
    probe = {device: offline.linear_probe(feats["cpu", "train"], feats["cpu", "val"], epochs=3,
                                          lr=0.5, batch_size=16, device=device)
             for device in ("cuda", "cpu")}
    assert probe["cuda"] == probe["cpu"]
