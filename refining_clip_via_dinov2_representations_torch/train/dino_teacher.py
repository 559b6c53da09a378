"""The live DINOv2 teacher and the soft-label helpers.

The port of the JAX package's ``train/dino_teacher.py``. Teacher features
come either from the precomputed store (``train/data.DinoFeatureStore``) or
from ``LiveDinoTeacher``: a frozen DINOv2 (``models/dinov2.py``) that runs
inside the train step and the CLIP-blind check on the same pixels the
student sees. ``renormalize_clip_to_imagenet`` turns the student's
normalisation into the teacher's ImageNet one on the device, and
``resize_for_teacher`` brings an image whose side is not a multiple of the
patch down to the nearest one.

The teacher is frozen: ``requires_grad_(False)``, ``eval()``, and its
forward runs under ``torch.no_grad()``, so no graph is kept and the fused
attention kernel runs forward only (12 launches a dinov2-small call on a
CUDA tensor, no backward). Its parameters are not the student's: the
train step holds it beside the model, so it is in no optimizer group, no
gradient norm and no checkpoint.

Under a model axis the main CLI splits the teacher over the model group
by the student's rules (``parallel/tensor.py:shard_module``: query, key
and value on heads, ``output.dense`` on columns, ``fc1``/``fc2`` or the
SwiGLU pair), so each rank runs its heads: the JAX package's TP-sharded
teacher of Config 5.

Images are NCHW here; ``LiveDinoTeacher.extract`` also takes the NHWC
batches of the port's loaders and transposes them once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)
from ..losses.dino import _soft_kl
from ..models.dinov2 import Dinov2, load_dinov2_model


def _channels(values, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)


def renormalize_clip_to_imagenet(
    images: torch.Tensor,
    input_mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
    input_std: Tuple[float, ...] = OPENAI_DATASET_STD,
) -> torch.Tensor:
    """Student-normalised NCHW pixels -> ImageNet-normalised (the teacher's
    input). ``input_mean``/``input_std`` are the student pipeline's constants
    (OpenAI CLIP statistics by default; 0.5/0.5 for SigLIP towers)."""
    raw = images * _channels(input_std, images) + _channels(input_mean, images)
    return (raw - _channels(IMAGENET_DEFAULT_MEAN, images)) / _channels(
        IMAGENET_DEFAULT_STD, images)


def resize_for_teacher(images: torch.Tensor, patch_size: int = 14) -> torch.Tensor:
    """NCHW batch -> the nearest patch-multiple size at or below it (224 ->
    224 for the standard pipeline, 256 -> 252, 384 -> 378), bicubic with
    antialias as ``jax.image.resize(..., "cubic")``."""
    h, w = images.shape[-2:]
    th, tw = (h // patch_size) * patch_size, (w // patch_size) * patch_size
    if (th, tw) == (h, w):
        return images
    return F.interpolate(images, size=(th, tw), mode="bicubic", align_corners=False,
                         antialias=True)


class LiveDinoTeacher:
    """A frozen DINOv2 that runs on the device beside the student."""

    def __init__(self, model: Dinov2, input_mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
                 input_std: Tuple[float, ...] = OPENAI_DATASET_STD):
        self.model = model.requires_grad_(False).eval()
        self.input_mean = tuple(input_mean)
        self.input_std = tuple(input_std)

    @classmethod
    def from_pretrained(cls, model_name: str = "facebook/dinov2-small",
                        dtype: torch.dtype = torch.float32, cache_dir: Optional[str] = None,
                        input_mean: Tuple[float, ...] = OPENAI_DATASET_MEAN,
                        input_std: Tuple[float, ...] = OPENAI_DATASET_STD,
                        device="cuda", attn_impl: str = "auto") -> "LiveDinoTeacher":
        model = load_dinov2_model(model_name, dtype=dtype, cache_dir=cache_dir, device=device,
                                  attn_impl=attn_impl)
        return cls(model, input_mean=input_mean, input_std=input_std)

    @property
    def hidden_size(self) -> int:
        return self.model.cfg.hidden_size

    def extract(self, images: torch.Tensor) -> torch.Tensor:
        """CLS features [B, D] in the teacher's compute dtype, without
        gradient. ``images``: a batch normalised with the student's
        ``input_mean``/``input_std``, NCHW or NHWC, on the teacher's device."""
        with torch.no_grad():
            x = images
            if x.shape[-1] == 3 and x.shape[1] != 3:
                x = x.permute(0, 3, 1, 2)
            x = renormalize_clip_to_imagenet(x, self.input_mean, self.input_std)
            return self.model(resize_for_teacher(x, self.model.cfg.patch_size))


def compute_pairwise_similarities(features: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarities."""
    normed = features / torch.clamp(torch.linalg.vector_norm(features, dim=1, keepdim=True),
                                    min=1e-12)
    return normed @ normed.T


def create_soft_labels(similarities: torch.Tensor, temperature: float = 0.02) -> torch.Tensor:
    return torch.softmax(similarities / temperature, dim=1)


def compute_soft_label_loss(predicted_similarities: torch.Tensor,
                            soft_labels: torch.Tensor) -> torch.Tensor:
    """KL(q || softmax(pred)), batch mean (``losses/dino.py:_soft_kl``)."""
    return _soft_kl(predicted_similarities, soft_labels.float())
