"""The port's training data path against the JAX package: the synthetic
sample, the DINO feature store and index maps, and the loader's order."""

import json

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
from refining_clip_via_dinov2_representations_torch.train import data
from refining_clip_via_dinov2_representations_torch.transform import (
    PreprocessCfg,
    image_transform_v2,
)


@pytest.mark.parametrize("jax_train_transform", [False, True])
@pytest.mark.parametrize("size", [16, 224])
def test_synthetic_sample_equals_jax(size, jax_train_transform):
    """The port builds the blank image with numpy; the JAX package runs a
    black PIL image through its transform (the train transform in its CLI)."""
    from refining_clip_via_dinov2_representations_tpu.models import (
        get_tokenizer as jax_get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train.data import (
        SyntheticDataset as JaxSynthetic,
    )
    from refining_clip_via_dinov2_representations_tpu.transform import (
        PreprocessCfg as JaxPreprocessCfg,
        image_transform_v2 as jax_transform,
    )

    jt = jax_transform(JaxPreprocessCfg(size=size), is_train=jax_train_transform)
    want = JaxSynthetic(transform=jt, image_size=(size, size), dataset_size=5,
                        tokenizer=jax_get_tokenizer("ViT-B-16"), dino_dim=24)
    got = data.SyntheticDataset(transform=image_transform_v2(PreprocessCfg(size=size)),
                                image_size=(size, size), dataset_size=5,
                                tokenizer=get_tokenizer("ViT-B-16"), dino_dim=24)
    assert len(got) == len(want) == 5
    for i in (0, 3):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        assert g["images"].dtype == np.float32 and g["images"].shape == (size, size, 3)
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["texts"], w["texts"])
        np.testing.assert_array_equal(g["dino_features"], w["dino_features"])


@pytest.mark.parametrize("suffix", [".npy", ".npz"])
def test_feature_store_take_and_range_error_match_jax(tmp_path, suffix):
    from refining_clip_via_dinov2_representations_tpu.train.data import (
        DinoFeatureStore as JaxStore,
    )

    feats = np.random.default_rng(0).normal(size=(10, 6)).astype(np.float32)
    path = str(tmp_path / f"feats{suffix}")
    if suffix == ".npy":
        np.save(path, feats)
    else:
        np.savez(path, feats=feats)
    got, want = data.DinoFeatureStore(path), JaxStore(path)
    assert got.shape == want.shape == (10, 6)
    idx = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(got.take(idx), want.take(idx))
    for bad in ([1, -1], [10], [2, 11, -3]):
        with pytest.raises(ValueError) as g_err:
            got.take(bad)
        with pytest.raises(ValueError) as w_err:
            want.take(bad)
        assert str(g_err.value) == str(w_err.value)
    import torch

    torch.save(torch.from_numpy(feats), str(tmp_path / "feats.pt"))
    np.testing.assert_array_equal(data.DinoFeatureStore(str(tmp_path / "feats.pt")).take(idx),
                                  want.take(idx))


@pytest.mark.parametrize("kind", ["json", "json_wrapped", "npz"])
def test_index_map_matches_jax(tmp_path, kind):
    from refining_clip_via_dinov2_representations_tpu.train.data import (
        load_dino_index_map as jax_load,
    )

    mapping = {"/data/a.jpg": 0, "/data/b.jpg": 7, "/data/c.png": 3}
    if kind == "npz":
        path = str(tmp_path / "map.npz")
        np.savez(path, map=np.array(mapping, dtype=object))
    else:
        path = str(tmp_path / "map.json")
        with open(path, "w") as f:
            json.dump({"path_to_index": mapping} if kind == "json_wrapped" else mapping, f)
    assert data.load_dino_index_map(path) == jax_load(path) == mapping


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int64(i), "images": np.full((2, 2, 3), i, np.float32)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_matches_jax_for_a_seed_and_epoch(shuffle, drop_last):
    from refining_clip_via_dinov2_representations_tpu.train.data import Loader as JaxLoader

    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=17, num_workers=2)
    got, want = data.Loader(_Indexed(23), **kw), JaxLoader(_Indexed(23), **kw)
    assert len(got) == len(want)
    for epoch in (0, 1, 5):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g_batches, w_batches = list(got), list(want)
        assert len(g_batches) == len(w_batches) == len(got)
        for g, w in zip(g_batches, w_batches):
            np.testing.assert_array_equal(g["idx"], w["idx"])
            np.testing.assert_array_equal(g["images"], w["images"])


def test_loader_surfaces_dataset_errors():
    class Broken(_Indexed):
        def __getitem__(self, i):
            raise KeyError(f"sample {i}")

    with pytest.raises(KeyError):
        list(data.Loader(Broken(8), batch_size=4, num_workers=2))


def test_unported_dataset_types_raise(tmp_path):
    """Every dataset type is ported now (tar shards: tests/test_torch_webdataset.py):
    an unknown type or extension raises the JAX package's ValueError, a
    webdataset train set without --train-num-samples its RuntimeError; CSV
    train data and a val set load (the two cases that raised before the
    CSV data path was ported)."""
    from types import SimpleNamespace

    for kw, err, match in ((dict(dataset_type="parquet", train_data="rows.parquet"),
                            ValueError, "Unsupported dataset type"),
                           (dict(dataset_type="auto", train_data="rows.parquet"),
                            ValueError, "extension parquet"),
                           (dict(dataset_type="webdataset", train_data="shards.tar",
                                 train_num_samples=None), RuntimeError, "train-num-samples"),
                           (dict(dataset_type="auto", train_data="shards.tar",
                                 train_num_samples=None), RuntimeError, "train-num-samples")):
        args = SimpleNamespace(**{"train_num_samples": 8, "batch_size": 4, "val_data": None,
                                  **kw})
        with pytest.raises(err, match=match):
            data.get_data(args, (None, None))

    from PIL import Image

    rows = []
    for i in range(3):
        path = str(tmp_path / f"img_{i}.png")
        Image.new("RGB", (20, 12), (40 * i, 10, 200)).save(path, format="PNG")
        rows += [f"{path},caption {i} a", f"{path},caption {i} b"]
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("filepath,title\n" + "\n".join(rows) + "\n")
    t = image_transform_v2(PreprocessCfg(size=16))
    common = dict(csv_img_key="filepath", csv_caption_key="title", csv_separator=",",
                  batch_size=4, workers=1, seed=0, flickr_val_data=None, mscoco_val_data=None)
    args = SimpleNamespace(dataset_type="csv", train_data=str(csv_path), val_data=None,
                           **common)
    (batch,) = list(data.get_data(args, (t, t))["train"].dataloader)
    assert batch["images"].shape == (4, 16, 16, 3) and len(batch["texts"]) == 4
    args = SimpleNamespace(dataset_type="synthetic", train_data=None, val_data=str(csv_path),
                           train_num_samples=8, **common)
    got = data.get_data(args, (t, t))
    assert list(got) == ["train", "val"] and got["val"].dataloader.num_samples == 8
