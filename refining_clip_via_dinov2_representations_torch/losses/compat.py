"""open_clip's loss classes and ``create_loss`` over the functional losses.

The port of the JAX package's ``losses/compat.py``: reference users import
loss classes (``open_clip.ClipLoss(...)``) and a ``create_loss(args)``
factory (``src/open_clip/factory.py:506-588``). Here they are
``nn.Module``s with open_clip's constructor and ``forward`` signatures,
thin adapters over ``losses/contrastive.py`` and ``losses/dino.py``.

Distribution: where the JAX classes take an ``axis_name``, these take a
``torch.distributed`` process group (``group=``, the data axis). With
``world_size`` > 1 and no group, the default group is used where
``torch.distributed`` is initialised and its size is ``world_size``; with
none initialised the constructor raises, as the JAX ``_check_dist_args``
does without an ``axis_name``. ``use_horovod`` raises. ``gather_with_grad``
and ``cache_labels`` are accepted and change nothing: the gather always
carries gradients. With ``world_size`` 1 every loss is the one-process one.

Return conventions are the JAX classes' (a dict under ``output_dict``, else
a scalar or a tuple), ``ClipLossWithDINOEnhancements``' fall-off-the-end
``None`` without ``output_dict`` included (``loss.py:597-607``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist
from torch import nn

from .contrastive import clip_loss, coca_loss, cyclip_loss, distill_clip_loss, siglip_loss
from .dino import DinoLossCfg, dino_enhanced_loss


def _resolve_group(world_size: int, use_horovod: bool, group):
    """The group the loss gathers over: None in one process, ``group`` or
    the default group under ``world_size`` > 1 (``_check_dist_args``)."""
    if use_horovod:
        raise ValueError("use_horovod has no torch.distributed analogue here: launch one "
                         "process a GPU and pass the process group")
    if world_size == 1:
        return None
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        raise ValueError("world_size>1 without a process group: initialise torch.distributed "
                         "(or pass group=) so the loss can gather the other ranks' rows")
    if dist.get_world_size(group) != world_size:
        raise ValueError(f"world_size {world_size} != the process group's "
                         f"{dist.get_world_size(group)}")
    return group


class ClipLoss(nn.Module):
    """``open_clip.ClipLoss`` (``loss.py:84-159``)."""

    def __init__(self, local_loss=False, gather_with_grad=False, cache_labels=False, rank=0,
                 world_size=1, use_horovod=False, group=None):
        super().__init__()
        self.local_loss = local_loss
        self.world_size = world_size
        self.group = _resolve_group(world_size, use_horovod, group)

    def forward(self, image_features, text_features, logit_scale, output_dict: bool = False):
        loss = clip_loss(image_features, text_features, logit_scale, self.group,
                         self.local_loss)
        return {"contrastive_loss": loss} if output_dict else loss


class CoCaLoss(ClipLoss):
    """``open_clip.CoCaLoss`` (``loss.py:761-811``)."""

    def __init__(self, caption_loss_weight, clip_loss_weight, pad_id=0, local_loss=False,
                 gather_with_grad=False, cache_labels=False, rank=0, world_size=1,
                 use_horovod=False, group=None):
        super().__init__(local_loss=local_loss, world_size=world_size,
                         use_horovod=use_horovod, group=group)
        self.caption_loss_weight = caption_loss_weight
        self.clip_loss_weight = clip_loss_weight
        self.pad_id = pad_id

    def forward(self, image_features, text_features, logits, labels, logit_scale,
                output_dict: bool = False):
        out = coca_loss(image_features, text_features, logits, labels, logit_scale,
                        caption_loss_weight=self.caption_loss_weight,
                        clip_loss_weight=self.clip_loss_weight, pad_id=self.pad_id,
                        group=self.group, local_loss=self.local_loss)
        if output_dict:
            return out
        return out["contrastive_loss"], out["caption_loss"]


class DistillClipLoss(ClipLoss):
    """``open_clip.DistillClipLoss`` (``loss.py:907-949``)."""

    def forward(self, image_features, text_features, logit_scale, dist_image_features,
                dist_text_features, dist_logit_scale, output_dict: bool = False):
        out = distill_clip_loss(image_features, text_features, logit_scale,
                                dist_image_features, dist_text_features, dist_logit_scale,
                                self.group, self.local_loss)
        if output_dict:
            return out
        return out["contrastive_loss"], out["distill_loss"]


class SigLipLoss(nn.Module):
    """``open_clip.SigLipLoss`` (``loss.py:610-756``): ``bidir`` picks the
    two-way ring unless ``dist_impl`` names one."""

    def __init__(self, cache_labels=False, rank=0, world_size=1, bidir=True,
                 dist_impl: Optional[str] = None, group=None):
        super().__init__()
        self.group = _resolve_group(world_size, False, group)
        self.dist_impl = dist_impl or ("bidir" if bidir else "shift")
        self.world_size = world_size

    def forward(self, image_features, text_features, logit_scale, logit_bias,
                output_dict: bool = False):
        loss = siglip_loss(image_features, text_features, logit_scale, logit_bias, self.group,
                           self.dist_impl)
        return {"contrastive_loss": loss} if output_dict else loss


class CyCLIPLoss(ClipLoss):
    """The fork's ``CyCLIPLoss`` (``loss.py:814-905``)."""

    def __init__(self, lambda_inmodal=0.25, lambda_crossmodal=0.25, **kw):
        super().__init__(**kw)
        self.lambda_inmodal = lambda_inmodal
        self.lambda_crossmodal = lambda_crossmodal

    def forward(self, image_features, text_features, logit_scale, output_dict: bool = False):
        out = cyclip_loss(image_features, text_features, logit_scale,
                          lambda_inmodal=self.lambda_inmodal,
                          lambda_crossmodal=self.lambda_crossmodal, group=self.group,
                          local_loss=self.local_loss)
        if output_dict:
            return {**out, "lambda_inmodal": self.lambda_inmodal,
                    "lambda_crossmodal": self.lambda_crossmodal}
        return out["total_loss"]


class ClipLossWithDINOEnhancements(ClipLoss):
    """The fork's thesis loss (``loss.py:190-607``) over
    ``dino_enhanced_loss``. The projection head is a trained module here
    (``DinoProjectionHead``), so with ``cfg.use_projection`` the caller
    passes its output as ``image_proj``."""

    def __init__(self, cfg: Optional[DinoLossCfg] = None, local_loss=False,
                 gather_with_grad=False, cache_labels=False, rank=0, world_size=1,
                 use_horovod=False, group=None):
        super().__init__(local_loss=local_loss, world_size=world_size,
                         use_horovod=use_horovod, group=group)
        self.cfg = cfg or DinoLossCfg()

    def forward(self, image_features, text_features, logit_scale, dino_features=None,
                image_proj=None, args=None, output_dict: bool = False):
        cfg = self.cfg
        if args is not None:  # the reference passes per-step knobs in ``args``
            cfg = dataclasses.replace(cfg, **{f.name: getattr(args, f.name)
                                              for f in dataclasses.fields(cfg)
                                              if hasattr(args, f.name)})
        if cfg.use_projection and image_proj is None:
            raise ValueError("use_projection: apply DinoProjectionHead to image_features and "
                             "pass the result as image_proj")
        out = dino_enhanced_loss(image_features, text_features, logit_scale, dino_features, cfg,
                                 image_proj=image_proj, group=self.group)
        if output_dict:
            return out
        # the reference's quirk: without output_dict the forward falls off
        # the end and returns None
        return None


def create_loss(args: Any) -> nn.Module:
    """``open_clip.create_loss`` (``factory.py:506-588``): the flags'
    dispatch to the classes above, in the JAX ``create_loss``'s order
    (distill, CoCa, SigLIP, CyCLIP, DINO, CLIP)."""
    def get(key, default=None):
        return getattr(args, key, default)

    common = dict(local_loss=bool(get("local_loss", False)),
                  world_size=int(get("world_size", 1)), group=get("group"))
    if get("distill"):
        return DistillClipLoss(**common)
    if "coca" in str(get("model", "")).lower() or get("use_coca"):
        return CoCaLoss(caption_loss_weight=get("coca_caption_loss_weight", 2.0),
                        clip_loss_weight=get("coca_contrastive_loss_weight", 1.0), **common)
    if get("siglip"):
        return SigLipLoss(world_size=common["world_size"], group=common["group"],
                          dist_impl=get("loss_dist_impl") or "bidir")
    if get("use_CyClip") or get("use_cyclip"):
        return CyCLIPLoss(lambda_inmodal=get("lambda_cyc_inmodal", 0.25),
                          lambda_crossmodal=get("lambda_cyc_crossmodal", 0.25), **common)
    if get("use_dino_general"):
        cfg = DinoLossCfg(**{f.name: getattr(args, f.name) for f in dataclasses.fields(DinoLossCfg)
                             if hasattr(args, f.name)})
        return ClipLossWithDINOEnhancements(cfg=cfg, **common)
    return ClipLoss(**common)
