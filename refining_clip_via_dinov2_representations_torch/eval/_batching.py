"""Fixed-size batch encoding for the offline eval tools.

The port of the JAX package's ``eval/_batching.py``: image paths are
PIL-loaded, preprocessed and pushed through an encode function in batches of
one size, the trailing batch zero-padded (so every call has the same shape,
as in the JAX tools) and its padding rows sliced off.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np


def encode_images_padded(
    encode_fn: Callable[[np.ndarray], np.ndarray],
    paths: Sequence[str],
    preprocess: Callable,
    batch_size: int,
    log_tag: Optional[str] = None,
) -> np.ndarray:
    """``encode_fn`` (a [batch_size, H, W, 3] float32 batch -> [batch_size,
    D] rows) over ``paths``; returns the rows of every path, fp32, in order."""
    from PIL import Image

    out = []
    for i in range(0, len(paths), batch_size):
        chunk = paths[i:i + batch_size]
        images = []
        for p in chunk:
            with Image.open(p) as img:
                images.append(preprocess(img.convert("RGB")))
        imgs = np.stack(images)
        n = imgs.shape[0]
        if n < batch_size:
            imgs = np.concatenate([imgs, np.zeros((batch_size - n, *imgs.shape[1:]), imgs.dtype)])
        out.append(np.asarray(encode_fn(imgs), np.float32)[:n])
        if log_tag:
            logging.info("[%s] %d / %d", log_tag, min(i + batch_size, len(paths)), len(paths))
    if not out:
        return np.empty((0, 0), np.float32)
    return np.concatenate(out)
