"""Image preprocessing on the device: resize, centre crop, per-example
RandomResizedCrop and normalisation of uint8 batches.

The port of the JAX package's ``ops/preprocess.py``, the device side of
``--device-preprocess``: the host ships uint8 NHWC batches at a staging size
(``transform.py:raw_uint8_transform``) and the train step crops, resamples
and normalises them on the card (``train/step.py``). Plain PyTorch, as the
JAX module is plain ``jnp``; no kernel of its own.

The resampler is ``jax.image.scale_and_translate`` with ``antialias=True``
(what ``jax.image.resize`` runs too), separable and per example: for each
spatial axis a weight matrix ``[B, out, in]`` on the images' device (the
sample coordinates exact, see ``weight_matrix``), then two batched products
in the images' dtype. Its semantics, kept to the letter:

* output pixel ``i`` samples input coordinate
  ``(i + 0.5) / scale - translation / scale - 0.5``;
* Keys' cubic kernel (a = -0.5: ``method="cubic"``, the JAX default and
  the only method the JAX callers use, so the only one here), widened by
  ``max(1 / scale, 1)`` when downsampling;
* weights normalised per output pixel (a sum under ``1000 * eps(fp32)``
  gives zeros);
* outputs whose sample falls outside ``[-0.5, in - 0.5]`` are zero.

``jax.image.resize`` leaves an axis whose size does not change untouched,
and so does ``batched_resize``. RandomResizedCrop draws its boxes as the JAX
function does (area scale uniform, log-uniform aspect, uniform position;
out-of-range widths and heights clamped to ``[1, W]`` and ``[1, H]``, not
redrawn) from an explicit ``torch.Generator`` (``sample_crop_boxes``), and
``resized_crop`` resamples given boxes, so a caller can hand in another
draw's boxes. Images are NHWC in and out, as the port's towers take them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

RATIO = (3.0 / 4.0, 4.0 / 3.0)
_EPS32 = float(np.finfo(np.float32).eps)


def normalize_images(x: torch.Tensor, mean: Sequence[float] = OPENAI_DATASET_MEAN,
                     std: Sequence[float] = OPENAI_DATASET_STD,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 or float NHWC images -> ``(x - mean) / std`` in ``dtype``;
    integer input is scaled by 1/255 first."""
    x = x.to(dtype) / 255.0 if not x.is_floating_point() else x.to(dtype)
    mean_t = torch.tensor(mean, dtype=dtype, device=x.device)
    std_t = torch.tensor(std, dtype=dtype, device=x.device)
    return (x - mean_t) / std_t


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for a batch: ``scale`` and
    ``translation`` of shape [B] (or []) -> weights [B, out, in] (or [out,
    in]) in ``dtype`` (the images'), on their device.

    The sample coordinates (``[B, out]``) are computed in float64 and split
    into an integer and a fraction, so the fp32 distances to the input
    pixels keep them to 1e-7 of a pixel. JAX computes them in fp32, which
    near 256 px holds 1.5e-5 of a pixel and moves [0, 1] pixels of noise by
    up to 4e-5 from the exact result (by as much between jitted and
    op-by-op JAX); the port keeps the exact one."""
    device = scale.device
    scale, translation = scale.double(), translation.double()
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)[..., None, None].to(dtype)
    sample_f = ((torch.arange(out_size, dtype=torch.float64, device=device) + 0.5) * inv[..., None]
                - (translation * inv)[..., None] - 0.5)  # [..., out]
    base = torch.floor(sample_f)
    frac = (sample_f - base).to(dtype)
    x = ((base.to(dtype)[..., :, None] - torch.arange(in_size, dtype=dtype, device=device))
         + frac[..., :, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(-1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None], weights, torch.zeros_like(weights))


def _resample(x: torch.Tensor, wy: Optional[torch.Tensor], wx: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """NHWC ``x`` through the row weights ``wy`` [(B,) th, H] and the column
    weights ``wx`` [(B,) tw, W]; None leaves an axis as it is."""
    if wy is not None:
        x = torch.einsum("...oh,...hwc->...owc" if wy.dim() == 3 else "oh,bhwc->bowc", wy, x)
    if wx is not None:
        x = torch.einsum("...pw,...owc->...opc" if wx.dim() == 3 else "pw,bowc->bopc", wx, x)
    return x


def batched_resize(images: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Resize an NHWC batch to ``[B, th, tw, C]`` (squash), fp32, as
    ``jax.image.resize``: an axis of unchanged size is not resampled."""
    x = images.to(torch.float32) if not images.is_floating_point() else images
    _, h, w, _ = x.shape
    th, tw = out_size

    def axis(n_in: int, n_out: int) -> Optional[torch.Tensor]:
        if n_in == n_out:
            return None
        s = torch.tensor(n_out / n_in, dtype=torch.float64, device=x.device)
        return weight_matrix(n_in, n_out, s, torch.zeros_like(s), x.dtype)

    return _resample(x, axis(h, th), axis(w, tw))


def center_crop_resize(images: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Shortest-edge resize so that the crop fits, then the centre crop, as
    the JAX function does for a batch of one input size."""
    _, h, w, _ = images.shape
    th, tw = out_size
    scale = max(th / h, tw / w)
    rh, rw = int(round(h * scale)), int(round(w * scale))
    resized = batched_resize(images, (rh, rw))
    top, left = (rh - th) // 2, (rw - tw) // 2
    return resized[:, top:top + th, left:left + tw]


def sample_crop_boxes(generator: Optional[torch.Generator], b: int, h: int, w: int,
                      scale: Tuple[float, float] = (0.9, 1.0),
                      ratio: Tuple[float, float] = RATIO) -> torch.Tensor:
    """``b`` RandomResizedCrop boxes over an ``h`` x ``w`` image as
    ``[b, 4]`` fp32 ``(top, left, height, width)`` on the generator's device:
    the area a uniform fraction in ``scale`` of ``h * w``, the aspect
    log-uniform in ``ratio``, width and height clamped to the image (not
    redrawn), the corner uniform over the room left. Draws area, aspect,
    then the two position fractions, as the JAX function splits its key."""
    device = generator.device if generator is not None else torch.device("cpu")

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=device, dtype=torch.float32)

    area = (uniform(b) * (scale[1] - scale[0]) + scale[0]) * float(h * w)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(uniform(b) * (hi - lo) + lo)
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, float(h))
    pos = uniform(b, 2)
    return torch.stack([pos[:, 0] * (h - ch), pos[:, 1] * (w - cw), ch, cw], dim=1)


def resized_crop(images: torch.Tensor, boxes: torch.Tensor, out_size: Tuple[int, int]
                 ) -> torch.Tensor:
    """Each image's box (``[B, 4]`` ``(top, left, height, width)``, fractional)
    resampled to ``out_size``: ``scale_and_translate`` with scale
    ``out / box`` and translation ``-corner * scale`` per example (both in
    float64), the weights and products in the images' float dtype."""
    x = images.to(torch.float32) if not images.is_floating_point() else images
    _, h, w, _ = x.shape
    th, tw = out_size
    top, left, ch, cw = boxes.to(device=x.device, dtype=torch.float64).unbind(1)
    sy, sx = th / ch, tw / cw
    return _resample(x, weight_matrix(h, th, sy, -top * sy, x.dtype),
                     weight_matrix(w, tw, sx, -left * sx, x.dtype))


def batched_random_resized_crop(generator: Optional[torch.Generator], images: torch.Tensor,
                                out_size: Tuple[int, int],
                                scale: Tuple[float, float] = (0.9, 1.0),
                                ratio: Tuple[float, float] = RATIO) -> torch.Tensor:
    """Per-example RandomResizedCrop: ``sample_crop_boxes`` then
    ``resized_crop``."""
    b, h, w, _ = images.shape
    return resized_crop(images, sample_crop_boxes(generator, b, h, w, scale, ratio), out_size)


def preprocess_train_batch(generator: Optional[torch.Generator], images_u8: torch.Tensor,
                           out_size: Tuple[int, int] = (224, 224),
                           mean: Sequence[float] = OPENAI_DATASET_MEAN,
                           std: Sequence[float] = OPENAI_DATASET_STD,
                           scale: Tuple[float, float] = (0.9, 1.0),
                           dtype: torch.dtype = torch.float32,
                           boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> cropped, resampled, normalised
    ``[B, th, tw, 3]`` on the images' device. ``boxes`` (``[B, 4]``) replaces
    the draw from ``generator``."""
    x = images_u8.to(torch.float32) / 255.0
    if boxes is None:
        b, h, w, _ = x.shape
        boxes = sample_crop_boxes(generator, b, h, w, scale)
    x = resized_crop(x, boxes, out_size)
    return normalize_images(x, mean, std).to(dtype)


def preprocess_eval_batch(images_u8: torch.Tensor, out_size: Tuple[int, int] = (224, 224),
                          mean: Sequence[float] = OPENAI_DATASET_MEAN,
                          std: Sequence[float] = OPENAI_DATASET_STD,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> centre-cropped, normalised ``[B, th, tw, 3]``."""
    x = center_crop_resize(images_u8.to(torch.float32) / 255.0, out_size)
    return normalize_images(x, mean, std).to(dtype)
