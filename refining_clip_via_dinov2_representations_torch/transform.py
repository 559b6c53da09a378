"""Image preprocessing for serving: the validation path.

The port's own copy of the JAX package's ``transform.py`` eval pipeline
(``image_transform_v2(cfg, is_train=False)``): PIL resize (shortest edge,
longest edge with pad, or squash), centre crop, scale to [0, 1] and
normalise, returning an HWC float32 numpy array. PIL is imported only inside
the functions that decode or resize. Training augmentation comes with the
training slice.
"""

from __future__ import annotations

import numbers
from dataclasses import asdict, dataclass
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    def __post_init__(self):
        if self.mode != "RGB":
            raise ValueError(f"only RGB preprocessing is supported, got {self.mode!r}")


_PREPROCESS_KEYS = set(asdict(PreprocessCfg()).keys())


def merge_preprocess_dict(base, overlay: Dict) -> Dict:
    base_clean = asdict(base) if isinstance(base, PreprocessCfg) else {
        k: v for k, v in base.items() if k in _PREPROCESS_KEYS}
    if overlay:
        base_clean.update({k: v for k, v in overlay.items()
                           if k in _PREPROCESS_KEYS and v is not None})
    return base_clean


def _to_2tuple(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    if isinstance(size, Sequence) and len(size) == 1:
        return int(size[0]), int(size[0])
    return tuple(int(s) for s in size)


def _interp(name: str):
    from PIL import Image

    return Image.BILINEAR if name == "bilinear" else Image.BICUBIC


def resize_shortest(img, size: int, interp):
    """torchvision ``Resize(int)``: shortest edge -> size."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return img.resize((size, max(1, int(round(size * h / w)))), interp)
    return img.resize((max(1, int(round(size * w / h))), size), interp)


def resize_keep_ratio(img, size: Tuple[int, int], interp, longest: float = 0.0):
    w, h = img.size
    th, tw = size
    ratio_h, ratio_w = h / th, w / tw
    ratio = max(ratio_h, ratio_w) * longest + min(ratio_h, ratio_w) * (1.0 - longest)
    return img.resize((max(1, int(round(w / ratio))), max(1, int(round(h / ratio)))), interp)


def center_crop_or_pad(img, size: Tuple[int, int], fill: int = 0):
    """Centre crop, padding with ``fill`` where the image is smaller
    (torchvision ``CenterCrop`` semantics for ``fill=0``)."""
    from PIL import ImageOps

    th, tw = size
    w, h = img.size
    pl, pt = max(0, (tw - w) // 2), max(0, (th - h) // 2)
    pr, pb = max(0, tw - w - pl), max(0, th - h - pt)
    if pl or pt or pr or pb:
        img = ImageOps.expand(img, border=(pl, pt, pr, pb), fill=fill)
        w, h = img.size
    left, top = int(round((w - tw) / 2.0)), int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


class ImageTransform:
    """PIL image or uint8 HWC array -> normalised HWC float32 array."""

    def __init__(self, cfg: PreprocessCfg):
        if cfg.resize_mode not in ("shortest", "longest", "squash"):
            raise ValueError(f"unknown resize_mode {cfg.resize_mode!r}")
        if cfg.interpolation not in ("bicubic", "bilinear"):
            raise ValueError(f"unknown interpolation {cfg.interpolation!r}")
        self.cfg = cfg
        self.image_size = _to_2tuple(cfg.size)
        self.mean = np.asarray(cfg.mean or OPENAI_DATASET_MEAN, np.float32)
        self.std = np.asarray(cfg.std or OPENAI_DATASET_STD, np.float32)

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        size, interp, mode = self.image_size, _interp(self.cfg.interpolation), self.cfg.resize_mode
        if mode == "longest":
            img = resize_keep_ratio(img, size, interp, longest=1.0)
            img = center_crop_or_pad(img, size, fill=self.cfg.fill_color)
        elif mode == "squash":
            img = img.resize(size[::-1], interp)
        else:
            if size[0] == size[1]:
                img = resize_shortest(img, size[0], interp)
            else:
                img = resize_keep_ratio(img, size, interp, longest=0.0)
            img = center_crop_or_pad(img, size, fill=0)
        arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return (arr - self.mean) / self.std


def image_transform_v2(cfg: PreprocessCfg, is_train: bool = False) -> ImageTransform:
    """The validation transform of a preprocess config."""
    if is_train:
        raise NotImplementedError("training augmentation comes with the training slice")
    return ImageTransform(cfg)
