"""The port's evaluation against the JAX package's: the metric functions on
seeded features (recalls and ranks exact, scalars 1e-6), ``evaluate`` of a
tiny CLIP carried across with ``models/convert.py`` on a mini-Flickr val CSV
(recalls and ranks equal, ``clip_val_loss`` and the modality gap within
1e-5), its ``--val-frequency`` gate, and the end-of-run recall table. The loaders
run one worker, as ``tests/test_torch_csv_data.py`` says why."""

from types import SimpleNamespace

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.eval import my_metrics
from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
from refining_clip_via_dinov2_representations_torch.train import helpers, metrics
from refining_clip_via_dinov2_representations_torch.train.data import get_csv_dataset
from refining_clip_via_dinov2_representations_torch.train.evaluate import evaluate
from refining_clip_via_dinov2_representations_torch.transform import image_transform

from .torch_port_utils import TINY_CFG, jax_clip, port_clip

SCALAR_TOL = 1e-6
EVAL_TOL = 1e-5
RECALLS = [f"{d}_R@{k}" for d in ("text_to_image", "image_to_text") for k in (1, 5, 10)]
RANKS = [f"{d}_{r}_rank" for d in ("text_to_image", "image_to_text") for r in ("mean", "median")]


def _features(n_img=12, caps=5, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n_img, dim)).astype(np.float32)
    cap2img = np.repeat(np.arange(n_img), caps)
    txt = (img[cap2img] + 1.5 * rng.normal(size=(n_img * caps, dim))).astype(np.float32)
    return img, txt, cap2img


def _assert_metrics_equal(got, want, scalar_tol=SCALAR_TOL):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in RECALLS or k in RANKS:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, abs=scalar_tol), k


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_functions_equal_jax(seed):
    from refining_clip_via_dinov2_representations_tpu.eval import my_metrics as j_my
    from refining_clip_via_dinov2_representations_tpu.train import helpers as j_helpers
    from refining_clip_via_dinov2_representations_tpu.train import metrics as j_metrics

    img, txt, cap2img = _features(seed=seed)
    per_cap = img[cap2img] + np.float32(0.01) * np.arange(len(cap2img), dtype=np.float32)[:, None]
    np.testing.assert_array_equal(metrics.build_unique_image_features(per_cap, cap2img),
                                  j_metrics.build_unique_image_features(per_cap, cap2img))
    _assert_metrics_equal(metrics.clip_retrieval_metrics(img, txt, cap2img),
                          j_metrics.clip_retrieval_metrics(img, txt, cap2img))
    _assert_metrics_equal(metrics.get_clip_metrics(per_cap, txt, 14.3),
                          j_metrics.get_clip_metrics(per_cap, txt, 14.3))
    got, want = my_metrics.flickr_retrieval_eval_(txt, per_cap), j_my.flickr_retrieval_eval_(
        txt, per_cap)
    assert {k: v for k, v in got.items() if k != "average_similarity"} == {
        k: v for k, v in want.items() if k != "average_similarity"}
    assert got["average_similarity"] == pytest.approx(want["average_similarity"], abs=SCALAR_TOL)

    m = metrics.clip_retrieval_metrics(img, txt, cap2img)
    noisy = {**m, "val/text to image R@1": 0.25, "image-to-text_r@5": 7.0, "other": "x"}
    assert helpers.extract_recalls_0_100(noisy) == j_helpers.extract_recalls_0_100(noisy)
    assert helpers.dataset_retrieval_score(m) == j_helpers.dataset_retrieval_score(m)
    results = [{"metrics": m}, {"metrics": {"image_to_text_R@1": 0.5}}, {"metrics": {}}]
    assert helpers.epoch_retrieval_score(results) == j_helpers.epoch_retrieval_score(results)
    assert repr(helpers.epoch_retrieval_score([])) == repr(j_helpers.epoch_retrieval_score([]))
    for name in ("val/text_to_image_R@1", "a b:c-d.e(f)"):
        assert helpers.sanitize_metric_name(name) == j_helpers.sanitize_metric_name(name)
    got_m, want_m = helpers.AverageMeter(), j_helpers.AverageMeter()
    for val, n in ((1.0, 2), (4.0, 1), (0.5, 5)):
        got_m.update(val, n)
        want_m.update(val, n)
    assert vars(got_m) == vars(want_m)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    from scripts.mini_flickr import generate

    return generate(str(tmp_path_factory.mktemp("mini_flickr_eval")), n_train=4, n_val=12,
                    size_px=32, dino_dim=24)


def _eval_args(mini, **kw):
    base = dict(val_data=mini["val_csv"], train_data=None, csv_img_key="filepath",
                csv_caption_key="title", csv_separator=",", batch_size=16, workers=1, seed=0,
                val_frequency=1, epochs=2)
    base.update(kw)
    return SimpleNamespace(**base)


def test_evaluate_matches_jax_on_a_csv_val_set(mini):
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata
    from refining_clip_via_dinov2_representations_tpu.train.evaluate import (
        evaluate as jax_evaluate,
    )
    from refining_clip_via_dinov2_representations_tpu.transform import (
        image_transform as jax_transform,
    )

    ctx = TINY_CFG["text_cfg"]["context_length"]
    size = TINY_CFG["vision_cfg"]["image_size"]
    jmodel, variables = jax_clip(TINY_CFG)
    model = port_clip(TINY_CFG, variables["params"])
    args = _eval_args(mini)
    got = evaluate(model, {"val": get_csv_dataset(args, image_transform(size, False), False,
                                                  tokenizer=SimpleTokenizer(ctx))}, 1, args)
    want = jax_evaluate(jmodel, variables,
                        {"val": jdata.get_csv_dataset(args, jax_transform(size, False), False,
                                                      tokenizer=JaxTokenizer(context_length=ctx))},
                        1, args, include_zero_shot=False)
    assert got["num_samples"] == want["num_samples"] == 60
    assert got["epoch"] == want["epoch"] == 1
    _assert_metrics_equal(got, want, scalar_tol=EVAL_TOL)


def test_evaluate_follows_the_val_frequency_gate(mini):
    model = port_clip(TINY_CFG, jax_clip(TINY_CFG)[1]["params"])
    ctx, size = TINY_CFG["text_cfg"]["context_length"], TINY_CFG["vision_cfg"]["image_size"]
    args = _eval_args(mini, val_frequency=2, epochs=3, batch_size=64)
    data = {"val": get_csv_dataset(args, image_transform(size, False), False,
                                   tokenizer=SimpleTokenizer(ctx))}
    assert evaluate(model, data, 1, args) == {}
    assert evaluate(model, data, 2, args)["epoch"] == 2
    assert evaluate(model, data, 3, args)["epoch"] == 3  # the last epoch
    assert evaluate(model, data, 2, args, val_key="mscoco-val") == {}
    assert evaluate(model, data, 2, _eval_args(mini, val_frequency=0)) == {}


def test_itm_scores_table_equals_jax(tmp_path):
    import json

    from refining_clip_via_dinov2_representations_tpu.eval import my_metrics as j_my

    img, txt, cap2img = _features()
    rows = []
    for epoch in range(3):
        m = metrics.clip_retrieval_metrics(img, txt + epoch * img[cap2img], cap2img)
        rows.append({"epoch": epoch, "results": [{"val_name": "val", "metrics": m},
                                                 {"val_name": "mscoco-val", "metrics": {}}]})
    rows.append({"epoch": 3, "results": []})
    path = tmp_path / "final_itm_results.json"
    path.write_text(json.dumps(rows))
    out = {}
    for name, fn in (("port", my_metrics.extract_and_plot_itm_scores),
                     ("jax", j_my.extract_and_plot_itm_scores)):
        out[name] = fn(str(path), str(tmp_path / f"{name}_r.png"), str(tmp_path / f"{name}_s.png"),
                       save_csv_path=str(tmp_path / f"{name}.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert out["port"] == out["jax"]
    assert (tmp_path / "port_r.png").exists() and (tmp_path / "modality_gap_plot.png").exists()
