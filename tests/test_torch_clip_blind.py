"""The port's CLIP-blind check against the JAX package's: the path maps, the
dedup, the alignment and the pair statistics on seeded arrays (equal), and
``run_clip_blind_on_split`` of a tiny CLIP carried across with
``models/convert.py`` on a mini-Flickr val CSV, with the precomputed
teacher rows and with a live tiny DINOv2 teacher: the same JSON (1e-6) and
the same top-pairs CSV."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.eval import clip_blind
from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
from refining_clip_via_dinov2_representations_torch.train.data import (
    get_csv_dataset,
    load_dino_index_map,
)
from refining_clip_via_dinov2_representations_torch.transform import image_transform

from .torch_port_utils import TINY_CFG, jax_clip, jax_dinov2, port_clip, port_dinov2

JSON_TOL = 1e-6


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_path_maps_dedup_and_alignment_equal_jax(tmp_path):
    from refining_clip_via_dinov2_representations_tpu.eval import clip_blind as jcb

    paths = [str(tmp_path / "d" / f"img_{i}.PNG") for i in range(6)]
    obj = {"path_to_index": {p: 5 - i for i, p in enumerate(paths[:4])}}
    with_base = {**obj, "basename_to_index": {"x/img_4.png": 1, "img_5.png": 99}}
    flat = {p: i for i, p in enumerate(paths[:3])} | {"meta": "not an index"}
    for o in (obj, with_base, flat):
        assert clip_blind.build_dino_path_maps(o) == jcb.build_dino_path_maps(o)
    with pytest.raises(RuntimeError):
        clip_blind.build_dino_path_maps([1, 2])

    rng = np.random.default_rng(0)
    z = rng.normal(size=(8, 4)).astype(np.float32)
    canon = [clip_blind._canon_path(p) for p in paths]
    dup = [canon[0], canon[1], canon[0], canon[2], canon[1], canon[3], canon[4], canon[5]]
    for plist in (canon[:4], dup):
        g, w = clip_blind.dedup_by_path(z[:len(plist)], plist), jcb.dedup_by_path(
            z[:len(plist)], plist)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]

    feats = rng.normal(size=(6, 5)).astype(np.float32)
    path2idx, base2idx = clip_blind.build_dino_path_maps(with_base)
    got = clip_blind.align_dino_feats_to_paths(feats, path2idx, base2idx, canon + ["/no/such"])
    want = jcb.align_dino_feats_to_paths(feats, path2idx, base2idx, canon + ["/no/such"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2:] == (4, 1, 2)  # img_5 points past the store
    assert clip_blind.align_dino_feats_to_paths(feats, {}, {}, canon)[0] is None


@pytest.mark.parametrize("n", [2, 30, 40])
def test_pair_stats_equal_jax(n):
    from refining_clip_via_dinov2_representations_tpu.eval import clip_blind as jcb

    rng = np.random.default_rng(n)
    base = rng.normal(size=(3, 8))
    clip_z = _unit(base[rng.integers(0, 3, n)] + 0.2 * rng.normal(size=(n, 8)))
    dino_z = _unit(rng.normal(size=(n, 6)))
    assert clip_blind.pair_stats(clip_z, dino_z) == jcb.pair_stats(clip_z, dino_z)
    assert clip_blind.pair_stats(clip_z, dino_z, [(0.5, 0.1)], top_k=7) == jcb.pair_stats(
        clip_z, dino_z, [(0.5, 0.1)], top_k=7)
    assert clip_blind.DEFAULT_THRESHOLDS == jcb.DEFAULT_THRESHOLDS


def _assert_close_json(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=JSON_TOL), path
    else:
        assert got == want, path


def test_run_clip_blind_on_split_writes_what_jax_writes(tmp_path):
    from scripts.mini_flickr import generate

    from refining_clip_via_dinov2_representations_tpu.eval import clip_blind as jcb
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata
    from refining_clip_via_dinov2_representations_tpu.transform import (
        image_transform as jax_transform,
    )

    mini = generate(str(tmp_path / "data"), n_train=4, n_val=16, size_px=32, dino_dim=24)
    args = SimpleNamespace(val_data=mini["val_csv"], train_data=None, csv_img_key="filepath",
                           csv_caption_key="title", csv_separator=",", batch_size=8,
                           workers=1, seed=0)
    ctx, size = TINY_CFG["text_cfg"]["context_length"], TINY_CFG["vision_cfg"]["image_size"]
    jmodel, variables = jax_clip(TINY_CFG)
    model = port_clip(TINY_CFG, variables["params"])
    feats = np.asarray(jdata.DinoFeatureStore(mini["dino_feats"]).features)
    mapping = {"path_to_index": load_dino_index_map(mini["dino_index_map"])}
    # max_images 7: the encode stops at the batch of 8 rows that reaches 14,
    # so 16 rows, 4 of the 16 images, stay after the dedup
    got = clip_blind.run_clip_blind_on_split(
        "val", {"val": get_csv_dataset(args, image_transform(size, False), False,
                                       tokenizer=SimpleTokenizer(ctx))},
        model, feats, mapping, str(tmp_path / "port"), max_images=7)
    full = clip_blind.run_clip_blind_on_split(
        "val", {"val": get_csv_dataset(args, image_transform(size, False), False,
                                       tokenizer=SimpleTokenizer(ctx))},
        model, feats, mapping, str(tmp_path / "port_full"))
    assert full["total_pairs"] == 16 * 15 // 2
    want = jcb.run_clip_blind_on_split(
        "val", {"val": jdata.get_csv_dataset(args, jax_transform(size, False), False,
                                             tokenizer=JaxTokenizer(context_length=ctx))},
        jmodel, variables, feats, mapping, str(tmp_path / "jax"), max_images=7)
    assert got["total_pairs"] == want["total_pairs"] == 6
    for name in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / name)) == ["clip_blind_val.json",
                                                       "clip_blind_val_top_pairs.csv"]
    with open(tmp_path / "port" / "clip_blind_val.json") as f, \
            open(tmp_path / "jax" / "clip_blind_val.json") as g:
        _assert_close_json(json.load(f), json.load(g))
    assert (tmp_path / "port" / "clip_blind_val_top_pairs.csv").read_text() == (
        tmp_path / "jax" / "clip_blind_val_top_pairs.csv").read_text()

    assert clip_blind.run_clip_blind_on_split("train", {}, model, feats, mapping,
                                              str(tmp_path / "none")) is None

    # the live-teacher branch: the tiny teacher encodes the same val pixels,
    # no store and no map; max_images 7 as above
    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import (
        LiveDinoTeacher as JaxTeacher,
    )
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )

    jteacher, tvars = jax_dinov2()
    live = clip_blind.run_clip_blind_on_split(
        "val", {"val": get_csv_dataset(args, image_transform(size, False), False,
                                       tokenizer=SimpleTokenizer(ctx))},
        model, None, None, str(tmp_path / "port_live"), max_images=7,
        dino_teacher=LiveDinoTeacher(port_dinov2(tvars["params"])))
    want_live = jcb.run_clip_blind_on_split(
        "val", {"val": jdata.get_csv_dataset(args, jax_transform(size, False), False,
                                             tokenizer=JaxTokenizer(context_length=ctx))},
        jmodel, variables, None, None, str(tmp_path / "jax_live"), max_images=7,
        dino_teacher=JaxTeacher(jteacher, tvars))
    assert live["total_pairs"] == want_live["total_pairs"] == 6
    with open(tmp_path / "port_live" / "clip_blind_val.json") as f, \
            open(tmp_path / "jax_live" / "clip_blind_val.json") as g:
        _assert_close_json(json.load(f), json.load(g))
    assert (tmp_path / "port_live" / "clip_blind_val_top_pairs.csv").read_text() == (
        tmp_path / "jax_live" / "clip_blind_val_top_pairs.csv").read_text()
