"""The host data path of the training slice: the DINO feature store, the
synthetic dataset and the prefetching loader.

The port of the JAX package's ``train/data.py`` for ``--dataset-type
synthetic`` and precomputed DINO features. The loader yields numpy batch
dicts (the train loop moves them to the device); it shuffles with
``np.random.default_rng(seed + epoch)``, so a seed and an epoch give the
JAX loader's order. CSV, webdataset and ImageFolder datasets are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


class DinoFeatureStore:
    """Precomputed DINOv2 features, ``[N, D]``, from ``.npy`` (memory-mapped)
    or ``.npz`` (key ``feats`` or the first array)."""

    def __init__(self, path: str, mmap: bool = True):
        self.path = str(path)
        if self.path.endswith(".npy"):
            arr = np.load(self.path, mmap_mode="r" if mmap else None)
        elif self.path.endswith(".npz"):
            z = np.load(self.path)
            arr = np.asarray(z["feats" if "feats" in z else list(z.keys())[0]], np.float32)
        else:
            raise NotImplementedError(
                f"{self.path}: the port reads .npy and .npz feature files (convert a "
                ".pt or .safetensors file with the JAX package's DinoFeatureStore)")
        if arr.ndim != 2:
            raise ValueError(f"DINO features must be [N, D], got {arr.shape}")
        self.features = arr

    @property
    def shape(self):
        return self.features.shape

    def take(self, indices) -> np.ndarray:
        """The rows of one batch, after checking every index is in range."""
        indices = np.asarray(indices, np.int64)
        n = self.features.shape[0]
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            bad = indices[(indices < 0) | (indices >= n)][:10].tolist()
            raise ValueError(
                f"[DINO] Out-of-range indices: min={indices.min()}, max={indices.max()}, "
                f"feats_rows={n}. Examples of bad indices: {bad}. This usually means "
                "your dino_index_map does not align with the training CSV order OR "
                "contains placeholder -1 entries."
            )
        return np.asarray(self.features[indices], np.float32)


def load_dino_index_map(path: str) -> Dict[str, int]:
    """A path -> row-index map from ``.json`` or ``.npz`` (key ``map`` or the
    first array), unwrapping a ``path_to_index`` entry."""
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    elif path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        raw = z["map"].item() if "map" in z else z[list(z.keys())[0]].item()
    else:
        raise NotImplementedError(f"{path}: the port reads .json and .npz index maps")
    if isinstance(raw, dict) and "path_to_index" in raw:
        raw = raw["path_to_index"]
    return {str(k): int(v) for k, v in raw.items()}


class SyntheticDataset:
    """A blank image and a constant caption: the fake-data backend of smoke
    runs. The blank (black) image is built with numpy and normalised with
    the transform's mean and std, which is what the JAX package's PIL
    pipeline makes of a black image."""

    def __init__(self, transform=None, image_size=(224, 224), caption: str = "Dummy caption",
                 dataset_size: int = 100, tokenizer=None, dino_dim: Optional[int] = None):
        self.dataset_size = dataset_size
        self.tokenize = tokenizer
        self.caption = caption
        self.dino_dim = dino_dim
        if transform is not None:
            mean = np.asarray(getattr(transform, "mean", OPENAI_DATASET_MEAN), np.float32)
            std = np.asarray(getattr(transform, "std", OPENAI_DATASET_STD), np.float32)
            pixel = (np.zeros(3, np.float32) - mean) / std
            size = getattr(transform, "image_size", image_size)
            self._image = np.ascontiguousarray(np.broadcast_to(pixel, (*size, 3)))
        else:
            self._image = np.zeros((*image_size, 3), np.float32)
        self._text = self.tokenize([caption])[0] if self.tokenize else caption

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = {"images": self._image, "texts": self._text}
        if self.dino_dim:
            rng = np.random.default_rng(idx)
            sample["dino_features"] = rng.normal(size=(self.dino_dim,)).astype(np.float32)
        return sample


def _collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = vals if isinstance(vals[0], str) else np.stack([np.asarray(v) for v in vals])
    return out


class Loader:
    """Epoch-seeded shuffling, threaded sample fetch and background
    prefetch, for one process; yields numpy batch dicts."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batches(self):
        """This epoch's index batches, in order."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        bs = self.batch_size
        out = [indices[i:i + bs] for i in range(0, len(indices), bs)]
        if out and self.drop_last and len(out[-1]) < bs:
            out.pop()
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self.batches()
        pool = ThreadPoolExecutor(self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def fetch(batch_idx):
            return _collate(list(pool.map(self.dataset.__getitem__, batch_idx)))

        def put(item) -> bool:
            # gives up once the consumer stopped iterating, so an abandoned
            # producer never blocks on a full queue
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if not put(fetch(b)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            abandoned.set()
            pool.shutdown(wait=False)
            thread.join(timeout=5)


@dataclasses.dataclass
class DataInfo:
    dataloader: Any

    def set_epoch(self, epoch: int):
        if hasattr(self.dataloader, "set_epoch"):
            self.dataloader.set_epoch(epoch)


def get_synthetic_dataset(args, preprocess_fn, is_train: bool, tokenizer=None) -> DataInfo:
    dataset = SyntheticDataset(
        transform=preprocess_fn,
        image_size=getattr(preprocess_fn, "image_size", (224, 224)),
        dataset_size=args.train_num_samples or 256,
        tokenizer=tokenizer,
        dino_dim=getattr(args, "synthetic_dino_dim", None)
        if (is_train and getattr(args, "use_dino_general", False)) else None,
    )
    loader = Loader(dataset, batch_size=args.batch_size, shuffle=is_train, drop_last=is_train,
                    seed=getattr(args, "seed", 0), num_workers=getattr(args, "workers", 8))
    loader.num_samples = len(dataset)
    loader.num_batches = len(loader)
    return DataInfo(loader)


def get_data(args, preprocess_fns, tokenizer=None) -> Dict[str, DataInfo]:
    """The dataset dict: ``"train"`` for ``--dataset-type synthetic``.
    Other dataset types and every validation set raise."""
    preprocess_train, _ = preprocess_fns
    if args.dataset_type != "synthetic" or args.train_data:
        raise NotImplementedError(
            f"--dataset-type {args.dataset_type} / --train-data: the port reads "
            "synthetic data so far (CSV, webdataset and ImageFolder: ROADMAP Queue 1 item 6)")
    if getattr(args, "val_data", None):
        raise NotImplementedError("validation data: evaluation is not ported (ROADMAP Queue 1 item 7)")
    return {"train": get_synthetic_dataset(args, preprocess_train, True, tokenizer)}
