"""The port's CSV data path against the JAX package's on a procedural
mini-Flickr set (``scripts/mini_flickr.py``, 8 train and 4 val images of
32 px, five captions each): rows, the DINO join and its errors, the ``.pt``
feature store and index map, the loader's teacher rows, and the eval and
train pixels (atol 1e-6; the train transform under the same seed and call
order, plain and timm-style). The loaders run one worker: the JAX package's
native BPE shares one output buffer between threads
(``tpu/native/__init__.py:105-113``), so its captions can take another
word's ids under several workers."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
from refining_clip_via_dinov2_representations_torch.train import data
from refining_clip_via_dinov2_representations_torch.transform import image_transform

PIXEL_ATOL = 1e-6


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    from scripts.mini_flickr import generate

    return generate(str(tmp_path_factory.mktemp("mini_flickr")), n_train=8, n_val=4,
                    size_px=32, dino_dim=24)


def _args(mini, **kw):
    base = dict(train_data=mini["train_csv"], val_data=mini["val_csv"], dataset_type="csv",
                csv_img_key="filepath", csv_caption_key="title", csv_separator=",",
                batch_size=5, workers=1, seed=3, use_dino_general=True,
                dino_fts_path=mini["dino_feats"], train_num_samples=None,
                val_num_samples=None, flickr_val_data=None, mscoco_val_data=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _jax_tokenizer():
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )

    return JaxTokenizer(context_length=16)


def test_rows_dino_idx_and_image_paths_match_jax(mini):
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    for is_train in (True, False):
        kw = dict(img_key="filepath", caption_key="title", return_image_id=not is_train)
        got = data.CsvDataset(mini["train_csv"], image_transform(16, False),
                              tokenizer=SimpleTokenizer(context_length=16),
                              dino_index_map=data.load_dino_index_map(mini["dino_index_map"])
                              if is_train else None, **kw)
        want = jdata.CsvDataset(mini["train_csv"], image_transform(16, False),
                                tokenizer=_jax_tokenizer(),
                                dino_index_map=jdata.load_dino_index_map(mini["dino_index_map"])
                                if is_train else None, **kw)
        assert len(got) == len(want) == 40
        assert got.images == want.images and got.captions == want.captions
        assert got.dino_index_map == want.dino_index_map
        for i in (0, 7, 39):
            g, w = got[i], want[i]
            assert set(g) == set(w) == ({"images", "texts", "dino_idx"} if is_train
                                        else {"images", "texts", "image_path"})
            np.testing.assert_array_equal(g["texts"], w["texts"])
            key = "dino_idx" if is_train else "image_path"
            assert g[key] == w[key]


@pytest.mark.parametrize("fault", ["missing", "negative"])
def test_validate_dino_map_raises_the_jax_error(mini, fault):
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    mapping = data.load_dino_index_map(mini["dino_index_map"])
    first = sorted(mapping)[0]
    if fault == "missing":
        del mapping[first]
    else:
        mapping[first] = -1
    kw = dict(img_key="filepath", caption_key="title", dino_index_map=mapping)
    with pytest.raises(RuntimeError) as g_err:
        data.CsvDataset(mini["train_csv"], None, **kw)
    with pytest.raises(RuntimeError) as w_err:
        jdata.CsvDataset(mini["train_csv"], None, **kw)
    assert str(g_err.value) == str(w_err.value)
    assert ("Missing in map" if fault == "missing" else "-1 index") in str(g_err.value)


def test_pt_store_and_index_map_load_as_in_jax(mini, tmp_path):
    import shutil

    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    for name in ("port", "jax"):  # each package writes its own .npy sidecar
        shutil.copy(mini["dino_feats"], tmp_path / f"{name}.pt")
    got = data.DinoFeatureStore(str(tmp_path / "port.pt"))
    want = jdata.DinoFeatureStore(str(tmp_path / "jax.pt"))
    assert got.shape == want.shape == (12, 24)
    assert (tmp_path / "port.pt.npy").exists()
    np.testing.assert_array_equal(np.asarray(got.features), np.asarray(want.features))
    np.testing.assert_array_equal(data.DinoFeatureStore(str(tmp_path / "port.pt")).take([3, 0]),
                                  want.take([3, 0]))
    assert data.load_dino_index_map(mini["dino_index_map"]) == jdata.load_dino_index_map(
        mini["dino_index_map"])


def test_safetensors_store_names_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(NotImplementedError, match="safetensors package"):
        data.DinoFeatureStore(str(tmp_path / "feats.safetensors"))


def test_train_loader_joins_teacher_rows_as_in_jax(mini):
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    args = _args(mini)
    got = data.get_csv_dataset(args, image_transform(16, False), True,
                               tokenizer=SimpleTokenizer(context_length=16),
                               dino_index_map=data.load_dino_index_map(mini["dino_index_map"]))
    want = jdata.get_csv_dataset(args, image_transform(16, False), True,
                                 tokenizer=_jax_tokenizer(),
                                 dino_index_map=jdata.load_dino_index_map(mini["dino_index_map"]))
    g_loader, w_loader = got.dataloader, want.dataloader
    assert g_loader.num_batches == w_loader.num_batches == 8
    for epoch in (0, 1):
        g_loader.set_epoch(epoch)
        w_loader.set_epoch(epoch)
        for g, w in zip(g_loader, w_loader):
            assert set(g) == set(w) == {"images", "texts", "dino_features"}
            np.testing.assert_array_equal(g["texts"], w["texts"])
            np.testing.assert_array_equal(g["dino_features"], w["dino_features"])
            np.testing.assert_allclose(g["images"], w["images"], atol=PIXEL_ATOL, rtol=0)


def test_val_pixels_equal_jax(mini):
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata
    from refining_clip_via_dinov2_representations_tpu.transform import (
        image_transform as jax_transform,
    )

    kw = dict(img_key="filepath", caption_key="title", return_image_id=True)
    got = data.CsvDataset(mini["val_csv"], image_transform(24, False), **kw)
    want = jdata.CsvDataset(mini["val_csv"], jax_transform(24, False), **kw)
    for i in range(len(got)):
        np.testing.assert_allclose(got[i]["images"], want[i]["images"], atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("aug_cfg", [
    {},
    {"scale": (0.3, 1.0), "color_jitter": (0.4, 0.4, 0.4, 0.1), "color_jitter_prob": 0.8,
     "gray_scale_prob": 0.3},
    {"use_timm": True, "scale": (0.2, 1.0), "ratio": (0.5, 2.0), "color_jitter": 0.4,
     "re_prob": 0.9, "re_count": 3},
], ids=["plain", "plain-jitter-gray", "timm-jitter-erasing"])
@pytest.mark.parametrize("interpolation", ["bicubic", "random"])
def test_train_pixels_equal_jax_under_the_same_seed(mini, aug_cfg, interpolation):
    from PIL import Image

    from refining_clip_via_dinov2_representations_tpu.transform import (
        image_transform as jax_transform,
    )

    kw = dict(aug_cfg=aug_cfg, interpolation=interpolation, seed=11)
    got, want = image_transform(24, True, **kw), jax_transform(24, True, **kw)
    images = data.CsvDataset(mini["train_csv"], None, "filepath", "title").images
    for path in images[::3] * 2:  # the same call order in both
        with Image.open(path) as img:
            img = img.convert("RGB")
            np.testing.assert_allclose(got(img), want(img), atol=PIXEL_ATOL, rtol=0)


def test_get_data_keys_match_jax(mini):
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    args = _args(mini, flickr_val_data=mini["val_csv"], mscoco_val_data=mini["val_csv"],
                 use_dino_general=False)
    t = image_transform(16, False)
    got = data.get_data(args, (t, t), tokenizer=SimpleTokenizer(context_length=16))
    want = jdata.get_data(args, (t, t), tokenizer=_jax_tokenizer())
    assert list(got) == list(want) == ["train", "val", "flickr30k-val", "mscoco-val"]
    for key in got:
        g, w = got[key].dataloader, want[key].dataloader
        assert (g.num_samples, g.num_batches) == (w.num_samples, w.num_batches)


def test_synthetic_val_takes_val_num_samples_as_in_jax():
    from refining_clip_via_dinov2_representations_tpu.train import data as jdata

    args = SimpleNamespace(train_data=None, val_data="val", dataset_type="synthetic",
                           train_num_samples=12, val_num_samples=7, batch_size=4, workers=1,
                           seed=0, flickr_val_data=None, mscoco_val_data=None)
    t = image_transform(16, False)
    got, want = data.get_data(args, (t, t)), jdata.get_data(args, (t, t))
    assert list(got) == list(want) == ["train", "val"]
    assert got["val"].dataloader.num_samples == want["val"].dataloader.num_samples == 7
    assert got["val"].dataloader.num_batches == want["val"].dataloader.num_batches == 2
