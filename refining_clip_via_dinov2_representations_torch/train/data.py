"""The host data path of the training slice: the DINO feature store, the CSV
and synthetic datasets and the prefetching loader.

The port of the JAX package's ``train/data.py`` for one process. The loader
yields numpy batch dicts (the train loop moves them to the device); it
shuffles with ``np.random.default_rng(seed + epoch)``, so a seed and an
epoch give the JAX loader's order, and it gathers a CSV batch's teacher rows
from the feature store by the samples' ``dino_idx``. CSV rows are read with
the ``csv`` module (the JAX package uses pandas, which the card's machine
lacks): a header row, then one row per caption; an empty caption reads as
"nan", as pandas gives it. Image paths are joined to the DINO index map
through ``_canon_path``, and a map that misses a row, or gives it -1,
raises the JAX package's error. ImageNet folders (``--imagenet-val``,
``--imagenet-v2``: one directory per class) feed the zero-shot evaluation;
folders named only with digits are class indices, sorted as numbers (the
ImageNet-V2 layout). Tar shards (``--dataset-type webdataset``) are read
by ``train/webdataset.py``; the ImageNet train subset raises.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


def _canon_path(p: str) -> str:
    """Real, normalised path with a lower-case extension: the key of the
    DINO join."""
    p = os.path.normpath(os.path.realpath(str(p)))
    root, ext = os.path.splitext(p)
    return root + ext.lower()


class DinoFeatureStore:
    """Precomputed DINOv2 features, ``[N, D]``, from ``.npy`` (memory-mapped),
    ``.npz`` (key ``feats`` or the first array), ``.safetensors`` (needs the
    ``safetensors`` package) or a torch ``.pt`` file (a tensor, or a dict
    holding ``feats`` or one tensor), converted once to a ``<path>.npy``
    sidecar that is memory-mapped from then on."""

    def __init__(self, path: str, mmap: bool = True):
        self.path = str(path)
        arr = self._load(self.path, mmap)
        if arr.ndim != 2:
            raise ValueError(f"DINO features must be [N, D], got {arr.shape}")
        self.features = arr

    @staticmethod
    def _load(path: str, mmap: bool) -> np.ndarray:
        mode = "r" if mmap else None
        if path.endswith(".npy"):
            return np.load(path, mmap_mode=mode)
        if path.endswith(".npz"):
            z = np.load(path)
            return np.asarray(z["feats" if "feats" in z else list(z.keys())[0]], np.float32)
        if path.endswith(".safetensors"):
            try:
                from safetensors.numpy import load_file
            except ImportError as e:
                raise NotImplementedError(
                    f"{path}: reading .safetensors needs the safetensors package, which this "
                    "environment lacks; save the features as .npy or .pt") from e
            d = load_file(path)
            return np.asarray(d["feats" if "feats" in d else list(d.keys())[0]], np.float32)
        cache = path + ".npy"
        if not os.path.exists(cache):
            import torch

            t = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(t, dict):
                t = t.get("feats", next(iter(t.values())))
            arr = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
            np.save(cache, arr.astype(np.float32))
            logging.info("[DINO] converted %s -> %s %s", path, cache, arr.shape)
        return np.load(cache, mmap_mode=mode)

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
    """A path -> row-index map from ``.json``, ``.npz`` (key ``map`` or the
    first array) or a torch ``.pt`` dict, unwrapping a ``path_to_index``
    entry."""
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    elif path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        raw = z["map"].item() if "map" in z else z[list(z.keys())[0]].item()
    else:
        import torch

        raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "path_to_index" in raw:
        raw = raw["path_to_index"]
    return {str(k): int(v) for k, v in raw.items()}


def _read_csv(path: str, sep: str, columns: Sequence[str]) -> Dict[str, List[str]]:
    """The named columns of a CSV with a header row; blank lines skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header = rows[0]
    missing = [c for c in columns if c not in header]
    if missing:
        raise KeyError(f"{path}: no column {missing} in {header}")
    out = {}
    for c in columns:
        i = header.index(c)
        out[c] = [r[i] if i < len(r) else "" for r in rows[1:]]
    return out


class CsvDataset:
    """CSV of (image path, caption) rows. Train samples with a DINO index map
    carry ``dino_idx``; eval samples (``return_image_id``) carry
    ``image_path``."""

    def __init__(self, input_filename: str, transforms: Callable, img_key: str,
                 caption_key: str, sep: str = ",", tokenizer=None,
                 return_image_id: bool = False,
                 dino_index_map: Optional[Dict[str, int]] = None):
        logging.debug("Loading csv data from %s.", input_filename)
        cols = _read_csv(input_filename, sep, (img_key, caption_key))
        self.images: List[str] = [_canon_path(p) for p in cols[img_key]]
        self.captions: List[str] = [c if c != "" else "nan" for c in cols[caption_key]]
        self.transforms = transforms
        self.tokenize = tokenizer
        self.return_image_id = bool(return_image_id)

        self.dino_index_map = None
        if dino_index_map:
            base = dino_index_map.get("path_to_index", dino_index_map)
            self.dino_index_map = {_canon_path(k): int(v) for k, v in base.items()}
            self._validate_dino_map()
        if self.return_image_id:
            _, ids = np.unique(np.asarray(self.images, dtype=object), return_inverse=True)
            self._debug_consecutive_ordering(ids.astype(int).tolist())

    def _validate_dino_map(self):
        """An actionable error for CSV rows the map misses or sets to -1."""
        csv_set = set(self.images)
        map_set = set(self.dino_index_map.keys())
        missing = [p for p in self.images if p not in self.dino_index_map]
        negvals = [p for p in self.images if self.dino_index_map.get(p, -1) < 0]
        if missing or negvals:
            msg = ["[DINO] CSV ↔ DINO map mismatch/invalid values."]
            msg.append(f"  CSV rows: {len(self.images)} | Unique CSV paths: {len(csv_set)} | "
                       f"Map keys: {len(map_set)}")
            if missing:
                msg.append("  Missing in map (first 10):")
                msg += [f"    {s}" for s in missing[:10]]
            if negvals:
                msg.append("  Keys with -1 index (first 10):")
                msg += [f"    {s}" for s in negvals[:10]]
            csv_b = {os.path.basename(p) for p in csv_set}
            map_b = {os.path.basename(p) for p in map_set}
            msg.append("  Basename-only diff (hints):")
            msg.append(f"    Only in CSV (first 10): {sorted(csv_b - map_b)[:10]}")
            msg.append(f"    Only in MAP (first 10): {sorted(map_b - csv_b)[:10]}")
            msg.append("Tip: Rebuild the DINO map from the SAME CSV, using the SAME _canon_path().")
            raise RuntimeError("\n".join(msg))

    def _debug_consecutive_ordering(self, image_ids):
        """Logs how many of the first 100 rows fall in groups of five
        consecutive captions of one image."""
        ok = broken = 0
        for idx in range(0, min(100, len(image_ids)), 5):
            if idx + 4 >= len(image_ids):
                break
            group = image_ids[idx:idx + 5]
            if len(set(group)) == 1:
                ok += 1
            else:
                broken += 1
                if broken <= 3:
                    logging.warning("Broken group at index %d: %s", idx, group)
        logging.info("Consecutive ordering: %d OK groups, %d broken groups", ok, broken)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image

        path = self.images[idx]
        if getattr(self.transforms, "decode_min_dim", None) is not None:
            # the raw uint8 path (``--device-preprocess``): the native
            # DCT-scaled JPEG decode, PIL for what it refuses
            image = self.transforms.load_and_apply(path)
        else:
            with Image.open(path) as img:
                image = self.transforms(img.convert("RGB"))
        sample: Dict[str, Any] = {
            "images": image,
            "texts": self.tokenize([self.captions[idx]])[0] if self.tokenize
            else self.captions[idx],
        }
        if self.dino_index_map is not None and not self.return_image_id:
            sample["dino_idx"] = np.int64(self.dino_index_map.get(path, -1))
        if self.return_image_id:
            sample["image_path"] = path
        return sample


class SyntheticDataset:
    """A blank image and a constant caption: the fake-data backend of smoke
    runs. The blank (black) image is built with numpy and normalised with
    the transform's mean and std, which is what the JAX package's PIL
    pipeline makes of a black image; under ``raw_uint8_transform``
    (``--device-preprocess``) it is uint8 zeros at the raw size."""

    def __init__(self, transform=None, image_size=(224, 224), caption: str = "Dummy caption",
                 dataset_size: int = 100, tokenizer=None, dino_dim: Optional[int] = None):
        self.dataset_size = dataset_size
        self.tokenize = tokenizer
        self.caption = caption
        self.dino_dim = dino_dim
        if getattr(transform, "is_raw_uint8", False):
            self._image = np.zeros((*transform.image_size, 3), np.uint8)
        elif transform is not None:
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


class ImageFolderDataset:
    """One subdirectory per class, image files inside (``.jpg``, ``.jpeg``,
    ``.png``, ``.bmp``, ``.webp``), in sorted order; samples are
    ``{"images", "labels"}``. Classes sort by name, or as numbers where
    every folder name is digits, each then being its own class index."""

    EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = [d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))]
        if classes and all(c.isdigit() for c in classes):
            classes = sorted(classes, key=int)
            self.class_to_idx = {c: int(c) for c in classes}
        else:
            classes = sorted(classes)
            self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[tuple] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as img:
            image = self.transform(img.convert("RGB")) if self.transform else np.asarray(img)
        return {"images": image, "labels": np.int64(label)}


def _collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = vals if isinstance(vals[0], str) else np.stack([np.asarray(v) for v in vals])
    return out


class Loader:
    """Epoch-seeded shuffling, rank sharding, threaded sample fetch and
    background prefetch; yields numpy batch dicts. With a ``dino_store``, a
    batch's ``dino_idx`` become its ``dino_features``.

    Rank ``process_index`` of ``process_count`` takes a contiguous shard of
    the epoch's permutation, ``n // process_count`` rows, the tail dropped so
    that every rank takes as many steps. Every rank seeds alike (no rank
    offset), so the shards of one epoch are disjoint."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2, dino_store: Optional[DinoFeatureStore] = None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.dino_store = dino_store
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def skip_next_batches(self, n: int):
        """The next iteration starts at batch ``n`` of its epoch's order (a
        mid-epoch resume). The skip is on indices: no skipped row is read."""
        self._skip_batches = int(n)

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batches(self):
        """This epoch's index batches of this rank's shard, in order."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        per_rank = len(indices) // self.process_count
        indices = indices[self.process_index * per_rank:(self.process_index + 1) * per_rank]
        bs = self.batch_size
        out = [indices[i:i + bs] for i in range(0, len(indices), bs)]
        if out and self.drop_last and len(out[-1]) < bs:
            out.pop()
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        skip, self._skip_batches = self._skip_batches, 0
        batches = self.batches()[skip:]
        pool = ThreadPoolExecutor(self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def fetch(batch_idx):
            batch = _collate(list(pool.map(self.dataset.__getitem__, batch_idx)))
            if self.dino_store is not None and "dino_idx" in batch:
                batch["dino_features"] = self.dino_store.take(batch.pop("dino_idx"))
            return batch

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


def _loader(dataset, args, is_train: bool, dino_store=None) -> DataInfo:
    """A loader over the dataset (train: shuffled, last partial batch
    dropped, this data rank's shard of the data axis, ``args.data_rank`` of
    ``args.data_world_size``: the model ranks of one data rank read the same
    rows; without a mesh, ``args.rank`` of ``args.world_size``), with its
    sample and batch counts. Evaluation loaders are not sharded: every rank
    reads the whole set, so the metrics are global."""
    ranks = (0, 1)
    if is_train:
        ranks = (getattr(args, "data_rank", getattr(args, "rank", 0)),
                 getattr(args, "data_world_size", getattr(args, "world_size", 1)))
    loader = Loader(dataset, batch_size=args.batch_size, shuffle=is_train, drop_last=is_train,
                    seed=getattr(args, "seed", 0), num_workers=getattr(args, "workers", 8),
                    dino_store=dino_store, process_index=ranks[0], process_count=ranks[1])
    loader.num_samples = len(dataset) // ranks[1]
    loader.num_batches = len(loader)
    return DataInfo(loader)


def get_imagenet(args, preprocess_fns, split: str) -> DataInfo:
    """The ``val`` (``--imagenet-val``) or ``v2`` (``--imagenet-v2``) ImageNet
    folder, in order, through the eval transform. The ``train`` split's
    50-shot subset raises: it is not ported."""
    if split == "train":
        raise NotImplementedError("the ImageNet train subset (--imagenet-train) is not ported "
                                  "(ROADMAP Queue 1 item 15)")
    if split not in ("val", "v2"):
        raise ValueError(f"unknown imagenet split {split!r}")
    root = args.imagenet_val if split == "val" else args.imagenet_v2
    if not root:
        raise ValueError(f"no path configured for imagenet split {split}")
    dataset = ImageFolderDataset(root, transform=preprocess_fns[1])
    loader = Loader(dataset, batch_size=args.batch_size, num_workers=getattr(args, "workers", 8))
    loader.num_samples = len(dataset)
    loader.num_batches = len(loader)
    return DataInfo(loader)


def get_csv_dataset(args, preprocess_fn, is_train: bool, tokenizer=None,
                    dino_index_map=None) -> DataInfo:
    """``--train-data`` (train) or ``--val-data`` (eval) as a CSV loader; the
    train loader joins ``--dino_fts_path`` rows under ``--use_dino_general``."""
    input_filename = args.train_data if is_train else args.val_data
    if not input_filename:
        raise ValueError("a CSV dataset needs --train-data or --val-data")
    fts = getattr(args, "dino_fts_path", None) if getattr(args, "use_dino_general", False) else None
    dino_store = DinoFeatureStore(fts) if is_train and fts else None
    dataset = CsvDataset(input_filename, preprocess_fn, img_key=args.csv_img_key,
                         caption_key=args.csv_caption_key, sep=args.csv_separator,
                         tokenizer=tokenizer, return_image_id=not is_train,
                         dino_index_map=dino_index_map if is_train else None)
    return _loader(dataset, args, is_train, dino_store)


def get_synthetic_dataset(args, preprocess_fn, is_train: bool, tokenizer=None,
                          dino_index_map=None) -> DataInfo:
    n = args.train_num_samples if is_train else (
        getattr(args, "val_num_samples", None) or args.train_num_samples or 256)
    dataset = SyntheticDataset(
        transform=preprocess_fn,
        image_size=getattr(preprocess_fn, "image_size", (224, 224)),
        dataset_size=n or 256,
        tokenizer=tokenizer,
        dino_dim=getattr(args, "synthetic_dino_dim", None)
        if (is_train and getattr(args, "use_dino_general", False)) else None,
    )
    return _loader(dataset, args, is_train)


def get_dataset_fn(data_path: Optional[str], dataset_type: str):
    """The dataset function of ``--dataset-type`` (``auto``: by the file's
    extension; ``.tar`` shards are webdataset's, ``train/webdataset.py``)."""
    if dataset_type == "auto":
        ext = (data_path or "").split(".")[-1]
        if ext in ("csv", "tsv"):
            return get_csv_dataset
        if ext != "tar":
            raise ValueError(f"Tried to figure out dataset type, but failed for extension {ext}.")
        dataset_type = "webdataset"
    if dataset_type == "csv":
        return get_csv_dataset
    if dataset_type == "synthetic":
        return get_synthetic_dataset
    if dataset_type == "webdataset":
        from .webdataset import get_wds_dataset

        return get_wds_dataset
    raise ValueError(f"Unsupported dataset type: {dataset_type}")


def get_data(args, preprocess_fns, epoch: int = 0, tokenizer=None,
             dino_index_map=None) -> Dict[str, DataInfo]:
    """The dataset dict: ``"train"`` (``--train-data``, or synthetic data),
    ``"val"`` (``--val-data``), the CSV retrieval sets ``"flickr30k-val"``
    and ``"mscoco-val"``, and the ImageNet folders ``"imagenet-val"`` and
    ``"imagenet-v2"``."""
    preprocess_train, preprocess_val = preprocess_fns
    data: Dict[str, DataInfo] = {}
    if args.train_data or args.dataset_type == "synthetic":
        data["train"] = get_dataset_fn(args.train_data, args.dataset_type)(
            args, preprocess_train, is_train=True, tokenizer=tokenizer,
            dino_index_map=dino_index_map)
    if getattr(args, "val_data", None):
        data["val"] = get_dataset_fn(args.val_data, args.dataset_type)(
            args, preprocess_val, is_train=False, tokenizer=tokenizer)
    for key, attr in (("flickr30k-val", "flickr_val_data"), ("mscoco-val", "mscoco_val_data")):
        path = getattr(args, attr, None)
        if path:
            data[key] = get_csv_dataset(_clone_args(args, val_data=path), preprocess_val,
                                        is_train=False, tokenizer=tokenizer)
    for key, split in (("imagenet-val", "val"), ("imagenet-v2", "v2")):
        if getattr(args, f"imagenet_{split}", None):
            data[key] = get_imagenet(args, preprocess_fns, split)
    return data


def _clone_args(args, **overrides):
    return SimpleNamespace(**{**vars(args), **overrides})
