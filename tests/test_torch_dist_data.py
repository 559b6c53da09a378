"""Data and evaluation across ranks.

* The train loader's rank shards (``train/data.py:Loader``): every rank
  seeds alike and takes a contiguous ``n // W`` of the epoch's permutation,
  the tail dropped: the shards are disjoint, their union is the
  one-process epoch's first ``W (n // W)`` rows in order, and each equals
  the JAX package's ``Loader._indices`` for the same rank.
* Evaluation and CLIP-blind loaders are not sharded.
* ``train/evaluate.py:evaluate`` and the CLIP-blind encoder on two gloo
  ranks (each encodes its share of every batch, padded to a multiple of
  the world size) equal the one-process results: the metrics at 1e-6
  relative, the features at 1e-5 (fp32 products over another number of
  rows round differently).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.train.data import Loader, _loader

from .torch_dist_utils import run_ranks
from .torch_port_utils import TINY_CFG, images, token_ids

N, BS, SEED, EPOCH = 23, 3, 5, 2


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


def _rank_indices(loader):
    return np.concatenate(loader.batches()) if loader.batches() else np.zeros(0, np.int64)


@pytest.mark.parametrize("world", [2, 3])
def test_rank_shards_are_disjoint_and_cover_the_epoch_in_order(world):
    from refining_clip_via_dinov2_representations_tpu.train.data import Loader as JaxLoader

    whole = Loader(_Rows(N), batch_size=N, shuffle=True, seed=SEED)
    whole.set_epoch(EPOCH)
    perm = whole.batches()[0]
    shards = []
    for r in range(world):
        loader = Loader(_Rows(N), batch_size=BS, shuffle=True, seed=SEED, process_index=r,
                        process_count=world)
        loader.set_epoch(EPOCH)
        shards.append(_rank_indices(loader))
        jax_loader = JaxLoader(_Rows(N), batch_size=BS, shuffle=True, seed=SEED,
                               process_index=r, process_count=world)
        jax_loader.set_epoch(EPOCH)
        np.testing.assert_array_equal(shards[-1], jax_loader._indices())
        dropped = Loader(_Rows(N), batch_size=BS, shuffle=True, drop_last=True, seed=SEED,
                         process_index=r, process_count=world)
        assert len(dropped) == len(dropped.batches()) == (N // world) // BS
    assert len(set(np.concatenate(shards))) == world * (N // world)
    np.testing.assert_array_equal(np.concatenate(shards), perm[:world * (N // world)])


def test_only_the_train_loader_is_sharded():
    args = SimpleNamespace(batch_size=4, seed=0, workers=1, rank=1, world_size=2)
    train = _loader(_Rows(10), args, is_train=True).dataloader
    val = _loader(_Rows(10), args, is_train=False).dataloader
    assert (train.process_index, train.process_count, train.num_samples) == (1, 2, 5)
    assert (val.process_index, val.process_count, val.num_samples) == (0, 1, 10)


def _val_batches():
    """Seven rows in batches of five and two (five pads to six on two ranks),
    two captions of one image among them."""
    size, ctx = TINY_CFG["vision_cfg"]["image_size"], TINY_CFG["text_cfg"]["context_length"]
    imgs, txts = images(7, size, seed=40), token_ids(7, ctx, seed=41)
    imgs[3] = imgs[2]
    paths = ["a.jpg", "b.jpg", "c.jpg", "c.jpg", "d.jpg", "e.jpg", "f.jpg"]
    return [{"images": imgs[s], "texts": txts[s], "image_path": paths[s]}
            for s in (slice(0, 5), slice(5, 7))]


def _evaluate():
    from refining_clip_via_dinov2_representations_torch.eval.clip_blind import (
        encode_clip_images_and_paths,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.train.data import DataInfo
    from refining_clip_via_dinov2_representations_torch.train.evaluate import evaluate

    model = build_model(parse_model_cfg(TINY_CFG), seed=3).eval()
    batches = _val_batches()
    args = SimpleNamespace(val_frequency=1, epochs=1)
    metrics = evaluate(model, {"val": DataInfo(batches)}, 1, args, include_zero_shot=False)
    feats, paths = encode_clip_images_and_paths(model, batches)
    return metrics, feats, paths


def _eval_worker(rank, world):
    return _evaluate()


def test_two_rank_evaluation_equals_the_one_process_evaluation():
    want, want_feats, want_paths = _evaluate()
    assert want["num_samples"] == 7
    for metrics, feats, paths in run_ranks(_eval_worker, 2):
        assert set(metrics) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
        assert paths == want_paths
        # fp32 products over 3 rows and over 5 round differently
        np.testing.assert_allclose(feats, want_feats, rtol=1e-5, atol=1e-6)
