"""Tar-shard reader in the webdataset layout (no ``webdataset`` package).

The port of the JAX package's ``train/webdataset.py``: ``.tar`` shards of
``key.jpg`` + ``key.txt`` (or ``key.json``) members are read with

* brace expansion of shard patterns (``{00000..00099}.tar``, ``{a,b}``,
  every group, ``::``-joined lists);
* an epoch-seeded shard shuffle (``random.Random(seed + epoch)``), then this
  data rank's shards (``shards[rank::world]``);
* with ``--dataset-resampled`` (training only), per-rank draws of shards
  with replacement from ``random.Random((seed + epoch) * 1000 + rank)``;
* samples grouped by webdataset's key (the member path up to the first dot
  of its base name); an image or caption member matched on the last
  dot-segment of its extension (``0001.en.txt`` is a caption); a ``.json``
  member's ``caption_key`` (else ``"caption"``) where there is no text
  member, a sample without either skipped; unreadable shards and members
  logged and skipped;
* a bounded reservoir shuffle buffer of raw bytes (training), drained at
  the end of the stream;
* training wraps the stream around (a fresh shard order) until exactly
  ``num_batches`` batches, a full pass that yields nothing fails fast;
  evaluation reads the stream once, the last batch partial;
* ``skip_next_batches(n)``: the next pass consumes the first
  ``n * batch_size`` raw samples undecoded (a mid-epoch resume);
* decode, the transform and the tokenizer in a thread pool; a transform
  with ``decode_min_dim`` (``--device-preprocess``) takes the tar bytes
  through ``apply_bytes``, the native JPEG decoder first.

The same seed, epoch, rank and shards give the JAX loader's batches in the
same order. Ranks and world size come from the data axis of the port's
process group (``args.data_rank`` / ``args.data_world_size``, which
``train/main.py`` reads off ``train/distributed.py:data_group``'s mesh);
validation reads every shard on every rank. The batches carry no DINO
features (no index joins a tar sample to a feature row, in the JAX package
either): with ``--use_dino_general`` and precomputed features the step
takes the losses that need none, and the live teacher encodes the batch.
"""

from __future__ import annotations

import collections
import io
import json
import logging
import random
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from .data import DataInfo, _collate

_BRACE = re.compile(r"\{([^{}]+)\}")


def _expand_braces(url: str) -> List[str]:
    """braceexpand for shard patterns: numeric ranges ``{000..099}``
    (zero-padded to the first bound's width) and comma lists ``{a,b}``, in
    every group (the cartesian product); another brace body is kept
    literally."""
    m = _BRACE.search(url)
    if not m:
        return [url]
    body = m.group(1)
    if re.fullmatch(r"\d+\.\.\d+", body):
        lo, hi = body.split("..")
        parts = [str(i).zfill(len(lo)) for i in range(int(lo), int(hi) + 1)]
    elif "," in body:
        parts = body.split(",")
    else:
        return [url[: m.start()] + body + url[m.end():]]
    out: List[str] = []
    for p in parts:
        out.extend(_expand_braces(url[: m.start()] + p + url[m.end():]))
    return out


def expand_urls(urls) -> List[str]:
    """A pattern, a ``::``-joined list of patterns or a list -> shard paths."""
    url_list = urls.split("::") if isinstance(urls, str) else list(urls)
    out: List[str] = []
    for url in url_list:
        out.extend(_expand_braces(url))
    return out


_IMG_EXT = {"jpg", "jpeg", "png", "webp", "bmp"}
_TXT_EXT = {"txt", "text", "caption"}
_JSON_EXT = {"json"}
# webdataset's base_plus_ext: the key is the member path up to the first dot
# of the base name (directories included), the extension the rest
_KEY_EXT = re.compile(r"^((?:.*/|)[^.]+)\.(.+)$")


def _group_tar_samples(tar_path: str) -> Iterator[Dict[str, bytes]]:
    """A shard's members grouped by key, in order; never raises on a bad
    shard or member (logged and skipped)."""
    try:
        tf = tarfile.open(tar_path)
    except (OSError, tarfile.TarError) as e:
        logging.warning("Skipping unreadable shard %s (%r)", tar_path, e)
        return
    current_key, sample = None, {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            m = _KEY_EXT.match(member.name)
            if not m:
                continue
            key, ext = m.group(1), m.group(2)
            if key != current_key:
                if sample and current_key is not None:
                    yield sample
                current_key = key
                sample = {"__key__": current_key.encode()}
            try:
                sample[ext.lower()] = tf.extractfile(member).read()
            except (OSError, tarfile.TarError) as e:
                logging.warning("Error reading %s from %s (%r)", member.name, tar_path, e)
        if sample and current_key is not None:
            yield sample
    finally:
        tf.close()


def _find(raw: Dict[str, bytes], exts) -> Optional[bytes]:
    """The first member whose extension's last dot-segment is in ``exts``."""
    for k, v in raw.items():
        if k != "__key__" and k.rsplit(".", 1)[-1] in exts:
            return v
    return None


class WdsLoader:
    """Iterable over numpy batch dicts (``images``, ``texts``) read from tar
    shards; ``num_batches`` per epoch in training (``num_samples //
    (batch_size * process_count)``, at least 1)."""

    def __init__(self, urls, preprocess_img: Callable, tokenizer, batch_size: int,
                 num_samples: int, is_train: bool = True, seed: int = 0,
                 resampled: bool = False, shuffle_buffer: int = 5000, process_index: int = 0,
                 process_count: int = 1, caption_key: str = "txt", num_workers: int = 8):
        self.shards = expand_urls(urls)
        if not self.shards:
            raise ValueError(f"no shards resolved from {urls!r}")
        self.preprocess_img = preprocess_img
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.is_train = is_train
        self.seed = seed
        self.resampled = resampled
        self.shuffle_buffer = shuffle_buffer if is_train else 0
        self.process_index = process_index
        self.process_count = process_count
        self.caption_key = caption_key
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.num_samples = num_samples
        self.num_batches = max(1, num_samples // (batch_size * process_count))
        self._skip_batches = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def skip_next_batches(self, n: int):
        """The next pass consumes the first ``n * batch_size`` raw samples of
        its order without decoding them and emits the rest of the epoch's
        batches (a sample a run dropped at decode counts as consumed, as in
        the JAX loader). One-shot."""
        self._skip_batches = int(n)

    def _epoch_shards(self, epoch: Optional[int] = None) -> List[str]:
        e = self.epoch if epoch is None else epoch
        if self.resampled and self.is_train:
            rng = random.Random((self.seed + e) * 1000 + self.process_index)
            return [rng.choice(self.shards) for _ in range(len(self.shards))]
        rng = random.Random(self.seed + e)
        shards = list(self.shards)
        if self.is_train:
            rng.shuffle(shards)
        return shards[self.process_index:: self.process_count] or shards[:1]

    def _samples(self, epoch: Optional[int] = None) -> Iterator[tuple]:
        """Raw (image bytes, caption) pairs of the epoch's shards."""
        for shard in self._epoch_shards(epoch):
            for raw in _group_tar_samples(shard):
                try:
                    img_bytes = _find(raw, _IMG_EXT)
                    if img_bytes is None:
                        continue
                    txt_bytes = _find(raw, _TXT_EXT)
                    caption = txt_bytes.decode("utf-8") if txt_bytes is not None else None
                    if caption is None:
                        json_bytes = _find(raw, _JSON_EXT)
                        if json_bytes is not None:
                            meta = json.loads(json_bytes)
                            caption = meta.get(self.caption_key)
                            if caption is None:
                                caption = meta.get("caption")
                    if caption is None:
                        continue
                    yield img_bytes, caption
                except Exception as e:  # one bad sample never ends the run
                    logging.warning("Skipping sample (%r)", e)

    def _decode(self, raw: tuple) -> Dict[str, Any]:
        from PIL import Image

        img_bytes, caption = raw
        if getattr(self.preprocess_img, "decode_min_dim", None) is not None:
            # the raw uint8 path: native DCT-scaled JPEG decode of the tar
            # bytes (PIL for what it refuses; ``transform.py:apply_bytes``)
            image = self.preprocess_img.apply_bytes(img_bytes)
        else:
            with Image.open(io.BytesIO(img_bytes)) as img:
                image = self.preprocess_img(img.convert("RGB"))
        text = self.tokenizer([caption])[0] if self.tokenizer else caption
        return {"images": image, "texts": text}

    def __len__(self):
        return self.num_batches

    def _shuffled_raw(self) -> Iterator[tuple]:
        """The raw stream through the reservoir buffer, wrapped around in
        training."""
        rng = random.Random(self.seed * 1000 + self.epoch)
        buf: List[tuple] = []
        wrap = since_wrap = 0
        samples = self._samples()
        while True:
            try:
                s = next(samples)
                since_wrap += 1
            except StopIteration:
                if not self.is_train:
                    break
                if since_wrap == 0:
                    raise RuntimeError(
                        f"webdataset shard list yielded no samples: "
                        f"{self.shards[:3]}{'...' if len(self.shards) > 3 else ''}")
                wrap += 1
                since_wrap = 0
                samples = self._samples(self.epoch + 1000000 * wrap)
                continue
            if self.shuffle_buffer:
                if len(buf) < self.shuffle_buffer:
                    buf.append(s)
                    continue
                idx = rng.randrange(len(buf))
                buf[idx], s = s, buf[idx]
            yield s
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        raw_stream = self._shuffled_raw()
        limit = self.num_batches if self.is_train else None
        emitted = 0
        skip, self._skip_batches = self._skip_batches, 0
        if skip:
            for _ in range(skip * self.batch_size):
                if next(raw_stream, None) is None:
                    break
            emitted = skip
        pool = ThreadPoolExecutor(self.num_workers)
        pending: "collections.deque" = collections.deque()
        window = max(self.batch_size * 2, 2 * self.num_workers)
        batch: List[Dict[str, Any]] = []
        try:
            exhausted = False
            while limit is None or emitted < limit:
                while not exhausted and len(pending) < window:
                    try:
                        pending.append(pool.submit(self._decode, next(raw_stream)))
                    except StopIteration:
                        exhausted = True
                if not pending:
                    break
                try:
                    sample = pending.popleft().result()
                except Exception as e:  # a sample that fails to decode is skipped
                    logging.warning("Skipping sample (%r)", e)
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size:
                    out = _collate(batch)
                    batch = []
                    emitted += 1
                    yield out
            if not self.is_train and batch:
                yield _collate(batch)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def get_wds_dataset(args, preprocess_fn, is_train: bool, tokenizer=None,
                    dino_index_map=None) -> DataInfo:
    """``--train-data`` (train: this data rank's shards, ``--dataset-resampled``
    honoured) or ``--val-data`` (eval: every shard on every rank) as a
    ``WdsLoader``. Training needs ``--train-num-samples``."""
    urls = args.train_data if is_train else args.val_data
    num_samples = args.train_num_samples if is_train else (
        getattr(args, "val_num_samples", None) or 0)
    if is_train and not num_samples:
        raise RuntimeError(
            "Currently, the number of dataset samples must be specified for the training "
            "dataset. Please specify it via `--train-num-samples`.")
    rank, world = 0, 1
    if is_train:
        rank = getattr(args, "data_rank", getattr(args, "rank", 0))
        world = getattr(args, "data_world_size", getattr(args, "world_size", 1))
    loader = WdsLoader(urls, preprocess_img=preprocess_fn, tokenizer=tokenizer,
                       batch_size=args.batch_size, num_samples=num_samples, is_train=is_train,
                       seed=getattr(args, "seed", 0),
                       resampled=getattr(args, "dataset_resampled", False) and is_train,
                       process_index=rank, process_count=world,
                       num_workers=getattr(args, "workers", 8))
    return DataInfo(loader)
