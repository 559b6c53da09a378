"""Image preprocessing: the validation and the training pipelines.

The port's own copy of the JAX package's ``transform.py`` host pipelines,
PIL-based, with torchvision's PIL-backend semantics (torchvision on PIL
images delegates to ``Image.resize``, so PIL alone is exact and torchvision
is not needed):

* eval (``image_transform_v2(cfg, is_train=False)``): resize (shortest
  edge, longest edge with pad, or squash), centre crop, scale to [0, 1] and
  normalise;
* train (``is_train=True``, with an ``AugmentationCfg``): RandomResizedCrop
  (bicubic, ``scale``), optional colour jitter and grayscale by probability;
  or, with ``use_timm``, the timm-style branch: RRC honouring ``ratio`` and
  ``interpolation="random"``, unconditional colour jitter and pixel-mode
  random erasing on the normalised array.

Randomness comes from ``random.Random(seed)`` and, for the erasing noise,
``np.random.default_rng(seed)``, called in the JAX package's order: the same
seed and the same sequence of calls give the same pixels. Every transform
returns an HWC float32 numpy array. PIL is imported only inside the
functions that decode or resize.
"""

from __future__ import annotations

import math
import numbers
import random
import warnings
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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


@dataclass
class AugmentationCfg:
    """``--aug-cfg`` keys."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Any] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


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


def random_resized_crop(img, size: Tuple[int, int], scale: Tuple[float, float],
                        ratio: Tuple[float, float], interp, rng: random.Random):
    """torchvision ``RandomResizedCrop.get_params``: ten attempts of
    (area scale, log-uniform aspect), then the largest centre crop within the
    ratio bounds."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.resize(size[::-1], interp, box=(left, top, left + cw, top + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.resize(size[::-1], interp, box=(left, top, left + cw, top + ch))


def _finalize(img, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return (arr - mean) / std


def _apply_color_jitter(img, cj, rng: random.Random):
    """Brightness, contrast, saturation (in a shuffled order) and hue."""
    from PIL import Image, ImageEnhance

    if isinstance(cj, (int, float)):
        cj = (cj, cj, cj, 0.0)
    b, c, s, h = (list(cj) + [0.0] * 4)[:4]
    ops = []
    if b:
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(rng.uniform(max(0, 1 - b), 1 + b)))
    if c:
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(rng.uniform(max(0, 1 - c), 1 + c)))
    if s:
        ops.append(lambda im: ImageEnhance.Color(im).enhance(rng.uniform(max(0, 1 - s), 1 + s)))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    if h:
        hsv = np.asarray(img.convert("HSV"), dtype=np.int16)
        shift = int(rng.uniform(-h, h) * 255)
        hsv[..., 0] = (hsv[..., 0] + shift) % 256
        img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def _random_erasing(arr: np.ndarray, prob: float, max_count: int, rng: random.Random,
                    np_rng: np.random.Generator) -> np.ndarray:
    """timm ``RandomErasing`` (mode 'pixel') on a normalised HWC array: with
    probability ``prob``, 1..``max_count`` rectangles of uniform(0.02, 1/3) /
    count of the area at a log-uniform aspect in [0.3, 1/0.3], filled with
    standard-normal noise."""
    if rng.random() > prob:
        return arr
    h_img, w_img = arr.shape[:2]
    area = float(h_img * w_img)
    count = max_count if max_count <= 1 else rng.randint(1, max_count)
    log_aspect = (math.log(0.3), math.log(1.0 / 0.3))
    out = arr.copy()
    for _ in range(count):
        for _attempt in range(10):
            target_area = rng.uniform(0.02, 1.0 / 3.0) * area / count
            aspect = math.exp(rng.uniform(*log_aspect))
            eh = int(round(math.sqrt(target_area * aspect)))
            ew = int(round(math.sqrt(target_area / aspect)))
            if 0 < ew < w_img and 0 < eh < h_img:
                top = rng.randint(0, h_img - eh)
                left = rng.randint(0, w_img - ew)
                out[top:top + eh, left:left + ew, :] = np_rng.normal(
                    size=(eh, ew, out.shape[2])).astype(out.dtype)
                break
    return out


class ImageTransform:
    """PIL image or uint8 HWC array -> normalised HWC float32 array (uint8
    HWC for ``raw_uint8_transform``).

    A transform that tolerates a DCT-downscaled decode sets
    ``decode_min_dim`` to its staging size: the loaders then hand it file
    or tar bytes through ``apply_bytes``, which decodes JPEGs with the
    native libjpeg core (``native/__init__.py:decode_jpeg``) at the
    smallest M/8 scale that covers that size, and everything else (or a
    JPEG the core refuses, or all JPEGs where it did not build) with PIL
    (``tpu/transform.py:205-255``)."""

    def __init__(self, fn: Callable, image_size: Tuple[int, int], is_train: bool,
                 mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
                 std: Tuple[float, ...] = OPENAI_DATASET_STD):
        self._fn = fn
        self.image_size = image_size
        self.is_train = is_train
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.decode_min_dim: Optional[int] = None
        self.is_raw_uint8 = False

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        return self._fn(img)

    def apply_bytes(self, data: bytes) -> np.ndarray:
        """Encoded image bytes, decoded (the native JPEG path where
        ``decode_min_dim`` is set) and transformed."""
        import io

        from PIL import Image

        if self.decode_min_dim is not None:
            from .native import decode_jpeg

            arr = decode_jpeg(data, self.decode_min_dim)
            if arr is not None:
                return self._fn(Image.fromarray(arr))
        with Image.open(io.BytesIO(data)) as img:
            return self._fn(img.convert("RGB"))

    def load_and_apply(self, path: str) -> np.ndarray:
        """The image file at ``path``, transformed (through ``apply_bytes``
        where ``decode_min_dim`` is set)."""
        from PIL import Image

        if self.decode_min_dim is not None:
            with open(path, "rb") as f:
                return self.apply_bytes(f.read())
        with Image.open(path) as img:
            return self._fn(img.convert("RGB"))


def raw_uint8_transform(raw_size: int = 256) -> ImageTransform:
    """The host side of ``--device-preprocess`` (``tpu/transform.py:374-397``):
    shortest-edge bicubic resize to ``raw_size``, centre crop, uint8 HWC. The
    crop, resampling and normalisation run in the train step on the device
    (``ops/preprocess.py``); ``raw_size`` above the model's input leaves
    room for its crops. JPEGs may decode at a DCT scale covering
    ``raw_size`` (``decode_min_dim``) before the resize."""
    size = (raw_size, raw_size)
    interp = _interp("bicubic")

    def raw(img) -> np.ndarray:
        img = resize_shortest(img.convert("RGB"), raw_size, interp)
        return np.asarray(center_crop_or_pad(img, size), dtype=np.uint8)

    t = ImageTransform(raw, size, is_train=True)
    t.is_raw_uint8 = True
    t.decode_min_dim = raw_size
    return t


def image_transform(image_size, is_train: bool, mean=None, std=None,
                    resize_mode: Optional[str] = None, interpolation: Optional[str] = None,
                    fill_color: int = 0,
                    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
                    seed: Optional[int] = None) -> ImageTransform:
    """The train or eval pipeline. ``seed`` seeds the train branch's
    ``random.Random`` and ``np.random.default_rng`` (None: fresh entropy,
    as in the JAX package's CLI)."""
    mean = tuple(mean or OPENAI_DATASET_MEAN)
    std = tuple(std or OPENAI_DATASET_STD)
    mean_a, std_a = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    interpolation = interpolation or "bicubic"
    if interpolation not in ("bicubic", "bilinear", "random"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    resize_mode = resize_mode or "shortest"
    if resize_mode not in ("shortest", "longest", "squash"):
        raise ValueError(f"unknown resize_mode {resize_mode!r}")
    aug_cfg = AugmentationCfg(**aug_cfg) if isinstance(aug_cfg, dict) else (
        aug_cfg or AugmentationCfg())
    size = _to_2tuple(image_size)

    def make(fn):
        return ImageTransform(fn, size, is_train, mean, std)

    if is_train:
        rng = random.Random(seed)
        scale = tuple(aug_cfg.scale)
        ratio = tuple(aug_cfg.ratio) if aug_cfg.ratio else (3.0 / 4.0, 4.0 / 3.0)
        cj = aug_cfg.color_jitter
        if aug_cfg.use_timm:
            np_rng = np.random.default_rng(seed)
            re_prob = float(aug_cfg.re_prob or 0.0)
            re_count = int(aug_cfg.re_count or 1)
            if cj is not None and isinstance(cj, (int, float)):
                cj = (float(cj),) * 3  # timm: a scalar jitters b, c and s, not hue

            def train_timm(img):
                itp = _interp(rng.choice(("bilinear", "bicubic")) if interpolation == "random"
                              else interpolation)
                img = random_resized_crop(img, size, scale, ratio, itp, rng).convert("RGB")
                if cj is not None:
                    img = _apply_color_jitter(img, cj, rng)
                arr = _finalize(img, mean_a, std_a)
                if re_prob:
                    arr = _random_erasing(arr, re_prob, re_count, rng, np_rng)
                return arr

            return make(train_timm)

        # the plain branch: bicubic RRC at the default ratio; ratio, re_prob
        # and re_count are ignored with a warning
        unused = [k for k in ("ratio", "re_prob", "re_count") if getattr(aug_cfg, k) is not None]
        if unused:
            warnings.warn("Unused augmentation cfg items, specify `use_timm` to use "
                          f"({unused}).")
        ratio = (3.0 / 4.0, 4.0 / 3.0)
        cj_prob, gs_prob = aug_cfg.color_jitter_prob, aug_cfg.gray_scale_prob

        def train(img):
            img = random_resized_crop(img, size, scale, ratio, _interp("bicubic"), rng)
            img = img.convert("RGB")
            if cj_prob and cj is not None and rng.random() < cj_prob:
                img = _apply_color_jitter(img, cj, rng)
            if gs_prob and rng.random() < gs_prob:
                img = img.convert("L").convert("RGB")
            return _finalize(img, mean_a, std_a)

        return make(train)

    interp = _interp("bilinear" if interpolation == "bilinear" else "bicubic")

    def evaluate(img):
        if resize_mode == "longest":
            img = resize_keep_ratio(img, size, interp, longest=1.0)
            img = center_crop_or_pad(img, size, fill=fill_color)
        elif resize_mode == "squash":
            img = img.resize(size[::-1], interp)
        else:
            if size[0] == size[1]:
                img = resize_shortest(img, size[0], interp)
            else:
                img = resize_keep_ratio(img, size, interp, longest=0.0)
            img = center_crop_or_pad(img, size, fill=0)
        return _finalize(img, mean_a, std_a)

    return make(evaluate)


def image_transform_v2(cfg: PreprocessCfg, is_train: bool = False,
                       aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None
                       ) -> ImageTransform:
    """The pipeline of a preprocess config (the train one unseeded)."""
    return image_transform(cfg.size, is_train, mean=cfg.mean, std=cfg.std,
                           interpolation=cfg.interpolation, resize_mode=cfg.resize_mode,
                           fill_color=cfg.fill_color, aug_cfg=aug_cfg)
