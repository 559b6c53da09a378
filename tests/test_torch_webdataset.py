"""The port's tar-shard loader (``train/webdataset.py``) against the JAX
package's on the same tar files: the cases of
``tests/test_webdataset_semantics.py`` and the webdataset cases of
``tests/test_train_e2e.py``, each held to the JAX loader's batches in the
same order (texts exactly, images exactly: one preprocess callable serves
both), then the CLI's wiring (``--dataset-type webdataset``, ``auto`` on
``.tar``, ``--dataset-resampled`` per data rank, validation unsharded)."""

import io
import json
import tarfile
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from refining_clip_via_dinov2_representations_tpu.train import webdataset as jwds
from refining_clip_via_dinov2_representations_torch.train import data as tdata
from refining_clip_via_dinov2_representations_torch.train import webdataset as twds


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _jpeg_bytes(rng, size=20):
    img = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def _pixels(img):  # one deterministic preprocess for both loaders
    return np.asarray(img.resize((16, 16)), np.float32) / 255.0


def _both(urls, **kw):
    """(port loader, JAX loader) over the same shards and settings."""
    kw = {"preprocess_img": _pixels, "tokenizer": None, **kw}
    return twds.WdsLoader(urls, **kw), jwds.WdsLoader(urls, **kw)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if isinstance(g["texts"], list):
            assert g["texts"] == w["texts"]
        else:
            np.testing.assert_array_equal(g["texts"], w["texts"])
        np.testing.assert_array_equal(g["images"], w["images"])


def _numbered_shard(path, n, seed):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{i:04d}.jpg", _jpeg_bytes(rng))
            _add(tf, f"{i:04d}.txt", f"caption {i}".encode())


def _write_shards(tmp_path, n_shards=2, per_shard=6):
    rng = np.random.default_rng(0)
    for shard in range(n_shards):
        with tarfile.open(tmp_path / f"shard-{shard}.tar", "w") as tf:
            for i in range(per_shard):
                key = f"{shard}_{i}"
                _add(tf, f"{key}.jpg", _jpeg_bytes(rng))
                _add(tf, f"{key}.txt", f"caption {key}".encode())


@pytest.mark.parametrize("pattern", ["s-{00..01}/{000..001}.tar", "{a,b}-{0..1}.tar",
                                     "x.tar::y-{08..10}.tar", "weird-{notarange}.tar",
                                     "s-{000..002}.tar"])
def test_expand_urls_as_jax(pattern):
    assert twds.expand_urls(pattern) == jwds.expand_urls(pattern)
    assert twds.expand_urls(pattern.split("::")) == jwds.expand_urls(pattern.split("::"))


def test_group_tar_samples_webdataset_convention(tmp_path):
    """Key = the path up to the first dot of the base name; directories keep
    samples apart; a bad shard yields nothing."""
    rng = np.random.default_rng(0)
    shard = tmp_path / "s.tar"
    with tarfile.open(shard, "w") as tf:
        _add(tf, "a/0001.jpg", _jpeg_bytes(rng))
        _add(tf, "a/0001.en.txt", b"caption a1")
        _add(tf, "b/0001.jpg", _jpeg_bytes(rng))
        _add(tf, "b/0001.txt", b"caption b1")
        _add(tf, "noext", b"skipped")
    got = list(twds._group_tar_samples(str(shard)))
    assert got == list(jwds._group_tar_samples(str(shard)))
    assert sorted(s["__key__"] for s in got) == [b"a/0001", b"b/0001"] and "en.txt" in got[0]
    (tmp_path / "bad.tar").write_bytes(b"not a tar")
    assert list(twds._group_tar_samples(str(tmp_path / "bad.tar"))) == []


def test_multi_extension_caption_and_json_rule(tmp_path):
    """``0001.en.txt`` is a caption; a ``.json`` caption where there is no
    text member, a json without the key skipped, an empty caption kept."""
    rng = np.random.default_rng(1)
    shard = tmp_path / "s.tar"
    with tarfile.open(shard, "w") as tf:
        for i in range(4):
            _add(tf, f"{i:04d}.jpg", _jpeg_bytes(rng))
            _add(tf, f"{i:04d}.en.txt", f"caption {i}".encode())
        for i, meta in enumerate(({"caption": "real caption"}, {"other": "none"},
                                  {"caption": ""}, {"txt": "by caption_key"})):
            _add(tf, f"j{i:03d}.jpg", _jpeg_bytes(rng))
            _add(tf, f"j{i:03d}.json", json.dumps(meta).encode())
    got, want = _both(str(shard), batch_size=3, num_samples=7, is_train=False,
                      shuffle_buffer=0)
    got, want = list(got), list(want)
    _same_batches(got, want)
    caps = sorted(c for b in got for c in b["texts"])
    assert caps == ["", "by caption_key"] + [f"caption {i}" for i in range(4)] + ["real caption"]
    assert [len(b["texts"]) for b in got] == [3, 3, 1]  # eval keeps the partial batch


def test_shuffle_buffer_order_matches_jax(tmp_path):
    """The reservoir buffer with train-mode wraparound: the JAX loader's
    batches in its order, at most twice each sample, shuffled."""
    n = 60
    _numbered_shard(tmp_path / "s.tar", n, seed=3)
    got, want = _both(str(tmp_path / "s.tar"), batch_size=6, num_samples=n, is_train=True,
                      shuffle_buffer=8, seed=5)
    got, want = list(got), list(want)
    _same_batches(got, want)
    caps = [c for b in got for c in b["texts"]]
    counts = Counter(caps)
    assert len(got) == n // 6 and len(counts) >= n - 8 and max(counts.values()) <= 2
    assert caps != [f"caption {i}" for i in range(len(caps))]


@pytest.mark.parametrize("epoch", [0, 3])
def test_skip_next_batches_resumes_as_jax(tmp_path, epoch):
    """A mid-epoch resume skips k batches of raw records and emits the rest
    of the epoch, as the JAX loader does; one-shot."""
    n = 60
    _numbered_shard(tmp_path / "s.tar", n, seed=7)
    got, want = _both(str(tmp_path / "s.tar"), batch_size=6, num_samples=n, is_train=True,
                      shuffle_buffer=8, seed=5)
    for loader in (got, want):
        loader.set_epoch(epoch)
    full = [list(b["texts"]) for b in got]
    for loader in (got, want):
        loader.skip_next_batches(2)
    resumed, resumed_jax = list(got), list(want)
    _same_batches(resumed, resumed_jax)
    assert [list(b["texts"]) for b in resumed] == full[2:]
    assert [list(b["texts"]) for b in got] == full


def test_reader_with_tokenizers_as_jax(tmp_path):
    """Two shards by a brace pattern, each package's CLIP tokenizer: three
    batches of int32 ids and 16-px images, the JAX loader's."""
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer

    _write_shards(tmp_path)
    url = str(tmp_path / "shard-{0..1}.tar")
    # one decode thread: the JAX tokenizer's native BPE shares its output
    # buffer between threads (ROADMAP Queue 3, JAX list)
    common = dict(preprocess_img=_pixels, batch_size=4, num_samples=12, is_train=True,
                  shuffle_buffer=4, num_workers=1)
    got = list(twds.WdsLoader(url, tokenizer=SimpleTokenizer(context_length=12), **common))
    want = list(jwds.WdsLoader(url, tokenizer=JaxTokenizer(context_length=12), **common))
    _same_batches(got, want)
    assert got[0]["images"].shape == (4, 16, 16, 3) and got[0]["texts"].dtype == np.int32


def test_eval_exhausts_without_num_samples(tmp_path):
    _write_shards(tmp_path)
    got, want = _both(str(tmp_path / "shard-{0..1}.tar"), batch_size=5, num_samples=0,
                      is_train=False)
    got = list(got)
    _same_batches(got, list(want))
    assert sum(b["images"].shape[0] for b in got) == 12


def test_resampled_streams_per_rank_as_jax(tmp_path):
    """``--dataset-resampled``: each rank draws its own shard sequence from
    ``(seed + epoch) * 1000 + rank``, the JAX draws; evaluation never
    resamples."""
    _write_shards(tmp_path, n_shards=8, per_shard=1)
    url = str(tmp_path / "shard-{0..7}.tar")
    streams = []
    for rank in (0, 1):
        got, want = _both(url, batch_size=2, num_samples=8, is_train=True, resampled=True,
                          process_index=rank, process_count=2, seed=3)
        for loader in (got, want):
            loader.set_epoch(2)
        assert got._epoch_shards() == want._epoch_shards()
        _same_batches(list(got), list(want))
        streams.append(got._epoch_shards())
    assert streams[0] != streams[1]
    got.is_train = False
    assert len(got._epoch_shards()) == len(set(got._epoch_shards()))


def test_dead_shards_fail_fast(tmp_path):
    for loader in _both(str(tmp_path / "missing-{0..1}.tar"), batch_size=2, num_samples=4,
                        is_train=True):
        with pytest.raises(RuntimeError, match="yielded no samples"):
            list(loader)


def _wds_args(tmp_path, **kw):
    return SimpleNamespace(**{"train_data": str(tmp_path / "shard-{0..3}.tar"),
                              "val_data": None, "dataset_type": "webdataset",
                              "train_num_samples": 8, "val_num_samples": None,
                              "batch_size": 2, "workers": 2, "seed": 0,
                              "dataset_resampled": False, **kw})


@pytest.mark.parametrize("dataset_type, train_data", [("webdataset", "shard-{0..3}.tar"),
                                                       ("auto", "shard-{0..3}.tar")])
def test_get_data_reads_tar_shards_by_data_rank(tmp_path, dataset_type, train_data):
    """``get_data`` builds the loader for ``webdataset`` and for ``auto`` on
    ``.tar``: the train loader on this data rank's shards (``data_rank`` of
    ``data_world_size``, as ``train/main.py`` sets them from the data
    axis), resampled where asked, validation on every shard."""
    _write_shards(tmp_path, n_shards=4, per_shard=2)
    args = _wds_args(tmp_path, dataset_type=dataset_type,
                     train_data=str(tmp_path / train_data), data_rank=1, data_world_size=2,
                     dataset_resampled=True, val_data=str(tmp_path / "shard-{0..3}.tar"))
    d = tdata.get_data(args, (_pixels, _pixels))
    train, val = d["train"].dataloader, d["val"].dataloader
    assert isinstance(train, twds.WdsLoader)
    assert (train.process_index, train.process_count) == (1, 2)
    assert train.resampled and train.num_batches == 2 and not val.resampled
    assert (val.process_index, val.process_count) == (0, 1)
    assert sum(len(b["texts"]) for b in val) == 8
    with pytest.raises(RuntimeError, match="train-num-samples"):
        tdata.get_data(_wds_args(tmp_path, train_num_samples=None), (_pixels, _pixels))
