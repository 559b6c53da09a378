"""Contrastive CLIP objective as plain PyTorch functions.

The port of the JAX package's ``losses/contrastive.py`` for one process:
``cross_entropy`` (an fp32 log-softmax), ``clip_logits`` and ``clip_loss``.
Across processes the JAX package all-gathers features over a named mesh
axis; here ``group`` stands for a ``torch.distributed`` process group, and
gathering is not ported yet (multi-GPU training is a later slice): without
a group the features are used as they are, with one the functions raise.

Dtypes follow JAX's promotion: the exponentiated ``logit_scale`` is fp32, so
``logit_scale * features`` promotes bf16 features to fp32 before the logits
matmul, as ``jnp`` does for two non-weak arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows with integer labels, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def gather_features(image_features: torch.Tensor, text_features: torch.Tensor,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The features of every process, in rank order. One process: as given."""
    if group is None:
        return image_features, text_features
    raise NotImplementedError(
        "gathering features across processes comes with multi-GPU training "
        "(ROADMAP Queue 1 item 10)"
    )


def clip_logits(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, group=None, local_loss: bool = True):
    """(logits_per_image, logits_per_text, labels) for one process."""
    image_features, text_features = gather_features(image_features, text_features, group)
    dtype = torch.promote_types(logit_scale.dtype, image_features.dtype)
    img, txt = image_features.to(dtype), text_features.to(dtype)
    logits_per_image = (logit_scale.to(dtype) * img) @ txt.T
    logits_per_text = (logit_scale.to(dtype) * txt) @ img.T
    labels = torch.arange(img.shape[0], device=img.device)
    return logits_per_image, logits_per_text, labels


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, group=None,
              local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE."""
    logits_i, logits_t, labels = clip_logits(image_features, text_features, logit_scale,
                                             group, local_loss)
    return 0.5 * (cross_entropy(logits_i, labels) + cross_entropy(logits_t, labels))
