"""The training step: forward both towers, the loss, backward, the
param-group optimizer (``train/optim.py``), the logit-scale clamp.

The port of the JAX package's ``train/step.py`` for every loss it
dispatches to (``LOSS_TYPES``: ``"clip"``, ``"dino"``, ``"siglip"``,
``"cyclip"``, ``"distill"`` and ``"coca"``), in one process or in one
process a rank. PyTorch runs eagerly, so there is no compiled function:
``make_train_step`` returns a closure over the model, the DINO head and
the optimizer that updates them in place. On a CUDA model
every attention call of both towers runs the fused kernels, forward and
backward (``ops/attention.py``, ``"auto"`` or ``"fused"``); with
``"flash"``, attention over 512 or more queries runs the flash forward
kernel and the shorter calls the plain path. CoCa (``"coca"``) adds the
caption logits and labels to the rows; its decoder's self- and
cross-attention run the fused kernels too (its text tower, under its CLS
mask, and its poolers take the plain attention, as in JAX).

Kept from the JAX step: the lambda_soft warm-up from the step counter (only
lambda_soft warms; ``enable_warmup_dino_hyperparams``); the DINO head on the
image features; clipping by the global norm of every gradient (frozen ones
included) before the update; the ln logit scale clamped to [0, ln 100] after
it; ``grad_norm`` of the raw gradients when ``log_grad_norm`` is set; with
a live DINOv2 teacher (``train/dino_teacher.py:LiveDinoTeacher``) and a
batch without ``dino_features``, the teacher encodes the same normalised
pixels the student saw, forward only (on a CUDA batch 12 more fused-forward
launches a step at dinov2-small). The teacher is not in the state: its
parameters take no gradient, no optimizer group and no checkpoint.

Distillation (``"distill"``) runs the frozen CLIP teacher (``dist_model``)
under ``torch.no_grad()`` on the same images and tokens as the student
(``tpu/train/step.py:317-345``); its features and exponentiated logit
scale are detached rows and scalars of the loss, and the total is the
contrastive plus the distillation term. A batch that carries
``dist_image_features`` and ``dist_text_features`` skips the teacher and
takes the logit scale from its parameter. CyCLIP (``"cyclip"``) adds the
cyclic penalties at ``lambda_cyc_inmodal`` and ``lambda_cyc_crossmodal``.

``accum_freq`` > 1 is the JAX step's cached-feature gradient accumulation:
the batch holds ``accum`` microbatches stacked on a leading axis; phase 1
encodes each under ``no_grad`` and caches its rows; phase 2 encodes each
again with grad, puts its live rows in its slot of the cached full batch,
takes the loss over all ``accum * B`` rows and backpropagates, so the
gradients add up in ``.grad`` to the single big batch's. The loss is not
scaled by ``1 / accum``, and the logit scale is live in every pass, so its
gradient is ``accum`` times the big batch's (as in torch and the JAX step).
The teachers' rows (DINOv2's, the distillation teacher's) come from phase 1
and are reused in phase 2: a teacher runs once a microbatch. The metrics
are the mean over the passes.

Patch dropout (``use_patch_dropout``, on a model whose vision config has a
probability) is the step's one random draw. Each step takes a seed from
the state's generator (saved in checkpoints, so a resume draws on) and
gives microbatch ``j`` a generator on the model's device seeded from it
with ``j`` folded in (``patch_dropout_generator``), as the JAX step folds
the microbatch index into its rng: both phases of ``accumulate_grads`` see
the same kept tokens for the same rows. Forwards without a generator (the
evaluations, CLIP-blind) keep every token.

Across ranks (``group``, the data axis of ``parallel/mesh.py``; one
process a GPU): every loss takes the group, so the classic CLIP term uses
the local rows against the gathered columns, the DINO soft and text KL
stay on the local block, the weighted CE modulates this rank's block of
the gathered logits, and SigLIP runs ``siglip_dist_impl``'s ring
(``bidir`` by default, as the JAX CLI) with ``logit_bias`` from the
model's output (0.0 where it has none). Each rank backpropagates its own
loss; the forward runs through ``towers`` (``Towers`` under DDP, whose
backward averages the gradients, or with FSDP's modules inside, whose
reduce-scatter does; the replicated tensors FSDP ignores are averaged
after the backward), so the gradient is the rank mean, as ``jax.grad`` of
the JAX step's ``pmean``. The returned metrics are the rank mean. Under
accumulation each pass's full batch is this rank's cached rows with the
live slot, gathered over the ranks inside the loss; the gradients are not
reduced until the last pass (``parallel/mesh.py:grad_sync_paused``).
Patch dropout folds the rank into the microbatch index, so that two ranks
never draw the same masks. Under a model axis (``parallel/tensor.py``) the
model ranks of one data rank take the same rows, draw the same masks (the
rank folded in is the data rank) and compute the same loss; their
gradients of replicated tensors come out equal, and each holds its part of
the split ones (``train_splits``).

Device preprocessing (``device_preprocess = (out_h, out_w, mean, std)``,
``--device-preprocess``): the batch's images arrive uint8 ``[B, raw, raw,
3]`` (``[accum, B, raw, raw, 3]`` under accumulation) and the step crops,
resamples and normalises them on their device first
(``ops/preprocess.py:preprocess_train_batch``; ``tpu/train/step.py:251-257``),
handing the towers NHWC fp32 at ``(out_h, out_w)``. Each step takes a crop
seed from the state's generator (after patch dropout's); microbatch ``j``
draws its boxes from a generator on the images' device with ``j`` folded
in. The boxes are drawn for the whole data axis's batch (the rows of every
data rank, in rank order) and each rank takes its rows' boxes, so a rank's
rows are cropped as the one process crops them. Each microbatch is
preprocessed once, before both phases of ``accumulate_grads``: the cached
and the live pass see the same pixels, and so do the live DINOv2 teacher
and the distillation teacher.

BatchNorm towers (``models/resnet.py``: OpenAI's ModifiedResNet) train as
the JAX step trains them (``tpu/train/step.py:259-283``): every forward of
the loss runs under ``batch_norm_mode``, so BatchNorm normalises with the
batch's statistics and updates its running ones, unless
``freeze_bn_stats`` (``--lock-image --lock-image-freeze-bn-stats``) keeps
the running ones, which then normalise and never change. ``--lock-image``
alone still updates them, as in JAX. Under accumulation they update once in
every encode pass: ``accum`` times in phase 1, then ``accum`` more in phase
2, continuing from phase 1's. Under a group they are the statistics of the
global batch (the per-channel moments averaged over the data ranks, forward
and backward), as GSPMD reduces them over every row of the JAX step. Patch
dropout is off for them (``train/main.py`` warns, as the JAX CLI does).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..losses import (DinoLossCfg, clip_loss, coca_loss, cyclip_loss, dino_enhanced_loss,
                      distill_clip_loss)
from ..losses.contrastive import SIGLIP_DIST_IMPLS, group_rank_size, siglip_loss
from ..losses.dino import DinoProjectionHead
from ..models.resnet import batch_norm_mode, has_batch_norm
from .optim import HEAD_PREFIX, GroupOptimizer, global_norm

LN100 = math.log(100.0)
LOSS_TYPES = ("clip", "dino", "siglip", "cyclip", "distill", "coca")
# rows a frozen teacher gives: computed once a microbatch under accumulation
TEACHER_ROWS = ("dino_features", "dist_image_features", "dist_text_features")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    head: Optional[DinoProjectionHead]
    optimizer: GroupOptimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class StepCfg:
    loss_type: str = "clip"  # clip | dino | siglip | cyclip | distill | coca
    dino: DinoLossCfg = DinoLossCfg()
    accum_freq: int = 1
    enable_warmup_dino_hyperparams: bool = False
    warmup: int = 10000
    use_patch_dropout: bool = False
    freeze_bn_stats: bool = False  # BatchNorm normalises with, and keeps, its running stats
    device_preprocess: Optional[Tuple] = None
    log_grad_norm: bool = False
    siglip_dist_impl: str = "bidir"  # bidir | shift | gather | reduce
    coca_caption_loss_weight: float = 2.0
    coca_contrastive_loss_weight: float = 1.0
    lambda_cyc_inmodal: float = 0.25
    lambda_cyc_crossmodal: float = 0.25

    def __post_init__(self):
        if self.siglip_dist_impl not in SIGLIP_DIST_IMPLS:
            raise ValueError(f"unknown siglip_dist_impl {self.siglip_dist_impl!r}: "
                             f"one of {SIGLIP_DIST_IMPLS}")
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type {self.loss_type!r}: one of {LOSS_TYPES}")
        if self.device_preprocess is not None and len(self.device_preprocess) != 4:
            raise ValueError("device_preprocess is (out_h, out_w, mean, std), not "
                             f"{self.device_preprocess!r}")


# an odd 63-bit constant (the golden ratio's): folds a microbatch index
# into the step's seed
_FOLD = 0x1E3779B97F4A7C15


def patch_dropout_generator(seed: int, index: int, device) -> torch.Generator:
    """Microbatch ``index``'s generator on ``device``: ``seed`` with the
    index folded in. The same (seed, index) gives the same draws."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + _FOLD * (index + 1)) % (1 << 63))
    return g


def device_preprocess_images(cfg: StepCfg, images: torch.Tensor, seed: int, rank: int = 0,
                             world: int = 1) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` (or ``[accum, B, H, W, 3]``) -> the towers' NHWC
    fp32 at ``cfg.device_preprocess``'s size: microbatch ``j`` cropped by
    the boxes of data rank ``rank``'s rows among the ``world * B`` that a
    generator of ``(seed, j)`` draws."""
    from ..ops import preprocess

    out_h, out_w, mean, std = cfg.device_preprocess
    micros = images if cfg.accum_freq > 1 else images[None]
    out = []
    for j, micro in enumerate(micros):
        b, h, w, _ = micro.shape
        gen = patch_dropout_generator(seed, j, micro.device)
        boxes = preprocess.sample_crop_boxes(gen, world * b, h, w)[rank * b:(rank + 1) * b]
        out.append(preprocess.preprocess_train_batch(None, micro, (out_h, out_w), mean, std,
                                                     boxes=boxes))
    return torch.stack(out) if cfg.accum_freq > 1 else out[0]


def train_parameters(model: torch.nn.Module, head: Optional[torch.nn.Module]
                     ) -> Dict[str, torch.nn.Parameter]:
    """Every trained tensor by name: the model's, then the head's under
    ``dino_head.`` (the JAX train tree's ``{"model", "dino_head"}``)."""
    params = dict(model.named_parameters())
    if head is not None:
        params.update({HEAD_PREFIX + n: p for n, p in head.named_parameters()})
    return params


def train_splits(model: torch.nn.Module, head: Optional[torch.nn.Module]) -> Dict[str, Any]:
    """The model-axis splits (``parallel/tensor.py:shard_module``) by the
    names of ``train_parameters``."""
    splits = dict(getattr(model, "tp_splits", {}))
    if head is not None:
        splits.update({HEAD_PREFIX + n: s for n, s in getattr(head, "tp_splits", {}).items()})
    return splits


def _lambda_overrides(cfg: StepCfg, step: int) -> Dict[str, float]:
    """lambda_soft grows linearly over ``warmup`` steps; the other lambdas
    stay at full strength from step 0."""
    if not cfg.enable_warmup_dino_hyperparams:
        return {}
    frac = min(1.0, float(step) / max(1, cfg.warmup))
    return {"lambda_soft": frac * cfg.dino.lambda_soft}


class Towers(nn.Module):
    """The model and the DINO head as one module, the unit DDP wraps: the
    forward of both towers, then the head on the image features where
    ``project`` asks for it."""

    def __init__(self, model: nn.Module, head: Optional[nn.Module] = None):
        super().__init__()
        self.model = model
        self.head = head

    def forward(self, images, texts, generator=None, project: bool = False):
        out = self.model(images, texts, patch_dropout_generator=generator)
        if project:
            out = {**out, "raw_proj": self.head(out["image_features"])}
        return out


def rank_mean(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each scalar metric, detached and averaged over ``group``'s ranks in
    one collective (the JAX step's ``pmean``); as they are without one."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    _, world = group_rank_size(group)
    if world == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= world
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def make_loss_fn(model: torch.nn.Module, cfg: StepCfg,
                 head: Optional[DinoProjectionHead] = None,
                 dino_teacher: Any = None, group=None,
                 towers: Optional[nn.Module] = None,
                 dist_model: Optional[nn.Module] = None) -> Callable:
    """``loss_fn(batch, step) -> (loss, metrics)``: this rank's loss and
    metrics. ``batch`` holds tensors on the model's device: images
    [B,H,W,3] float, texts [B,L] int, optional dino_features [B,Dd];
    without them, ``dino_teacher`` (a ``LiveDinoTeacher``) encodes the
    images. ``dist_model`` is the frozen CLIP teacher of ``"distill"``.
    ``towers`` runs the forward (``Towers(model, head)`` by default; its
    DDP wrapper under a group). ``loss_fn.encode_fn`` gives the
    per-sample rows and batch scalars; ``loss_fn.compute_metrics`` the
    losses from them."""
    towers = towers if towers is not None else Towers(model, head)
    train_bn = has_batch_norm(model) and not cfg.freeze_bn_stats

    def encode_fn(batch: Dict[str, torch.Tensor], step: int,
                  generator: Optional[torch.Generator] = None):
        dino_feats = None
        if cfg.loss_type == "dino":
            dino_feats = batch.get("dino_features")
            if dino_feats is None and dino_teacher is not None:
                dino_feats = dino_teacher.extract(batch["images"])
        project = dino_feats is not None and cfg.dino.use_projection and head is not None
        with batch_norm_mode(model, train_bn, group):
            out = towers(batch["images"], batch["texts"], generator, project)
        rows = {"img_f": out["image_features"], "txt_f": out["text_features"]}
        scalars: Dict[str, Any] = {"logit_scale": out["logit_scale"]}
        if cfg.loss_type == "dino":
            if dino_feats is not None:
                rows["dino_features"] = dino_feats
                if project:
                    rows["raw_proj"] = out["raw_proj"]
            scalars.update(_lambda_overrides(cfg, step))
        elif cfg.loss_type == "siglip" and "logit_bias" in out:
            scalars["logit_bias"] = out["logit_bias"]
        elif cfg.loss_type == "coca":
            rows["logits"], rows["labels"] = out["logits"], out["labels"]
        elif cfg.loss_type == "distill":
            if "dist_image_features" in batch:  # phase 2: the phase-1 rows
                rows["dist_image_features"] = batch["dist_image_features"]
                rows["dist_text_features"] = batch["dist_text_features"]
                scalars["dist_logit_scale"] = dist_model.logit_scale.detach().exp()
            else:
                with torch.no_grad():
                    t_out = dist_model(batch["images"], batch["texts"])
                rows["dist_image_features"] = t_out["image_features"].detach()
                rows["dist_text_features"] = t_out["text_features"].detach()
                scalars["dist_logit_scale"] = t_out["logit_scale"].detach()
        return rows, scalars

    def compute_metrics(rows, scalars) -> Dict[str, torch.Tensor]:
        logit_scale = scalars["logit_scale"]
        metrics = {"logit_scale": logit_scale}
        if cfg.loss_type == "clip":
            total = clip_loss(rows["img_f"], rows["txt_f"], logit_scale, group)
            metrics["contrastive_loss"] = total
        elif cfg.loss_type == "siglip":
            total = siglip_loss(rows["img_f"], rows["txt_f"], logit_scale,
                                scalars.get("logit_bias", 0.0), group, cfg.siglip_dist_impl)
            metrics["contrastive_loss"] = total
        elif cfg.loss_type == "coca":
            losses = coca_loss(rows["img_f"], rows["txt_f"], rows["logits"], rows["labels"],
                               logit_scale, caption_loss_weight=cfg.coca_caption_loss_weight,
                               clip_loss_weight=cfg.coca_contrastive_loss_weight, group=group)
            total = losses["contrastive_loss"] + losses["caption_loss"]
            metrics.update(losses)
        elif cfg.loss_type == "cyclip":
            losses = cyclip_loss(rows["img_f"], rows["txt_f"], logit_scale,
                                 lambda_inmodal=cfg.lambda_cyc_inmodal,
                                 lambda_crossmodal=cfg.lambda_cyc_crossmodal, group=group)
            total = losses.pop("total_loss")
            metrics.update(losses)
        elif cfg.loss_type == "distill":
            losses = distill_clip_loss(rows["img_f"], rows["txt_f"], logit_scale,
                                       rows["dist_image_features"], rows["dist_text_features"],
                                       scalars["dist_logit_scale"], group=group)
            total = losses["contrastive_loss"] + losses["distill_loss"]
            metrics.update(losses)
        else:
            losses = dino_enhanced_loss(
                rows["img_f"], rows["txt_f"], logit_scale, rows.get("dino_features"),
                cfg.dino, image_proj=rows.get("raw_proj"), group=group,
                lambda_overrides={k: v for k, v in scalars.items()
                                  if k in ("lambda_soft", "lambda_weighted", "lambda_original")}
                or None,
            )
            total = losses.pop("total_loss")
            metrics.update(losses)
        metrics["total_loss"] = total
        return metrics

    def loss_fn(batch, step, generator=None):
        rows, scalars = encode_fn(batch, step, generator)
        metrics = compute_metrics(rows, scalars)
        return metrics["total_loss"], metrics

    loss_fn.encode_fn = encode_fn
    loss_fn.compute_metrics = compute_metrics
    loss_fn.towers = towers
    return loss_fn


def accumulate_grads(loss_fn: Callable, batch: Dict[str, torch.Tensor], step: int,
                     accum: int, generator_for: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
    """Cached-feature accumulation over ``batch``'s ``accum`` stacked
    microbatches: adds the gradients of the full-batch loss into ``.grad``
    (see the module docstring) and returns this rank's metrics' mean over
    the passes. ``generator_for(j)`` gives microbatch ``j``'s patch-dropout
    generator, a fresh one in each phase. The gradients are reduced over
    the ranks in the last pass's backward only."""
    from ..parallel.mesh import grad_sync_paused

    gen = generator_for or (lambda j: None)
    towers = getattr(loss_fn, "towers", None)
    micros = [{k: v[j] for k, v in batch.items()} for j in range(accum)]
    with torch.no_grad():
        cached = [loss_fn.encode_fn(m, step, gen(j))[0] for j, m in enumerate(micros)]
    passes = []
    for j, micro in enumerate(micros):
        micro = {**micro, **{k: cached[j][k] for k in TEACHER_ROWS
                             if k in cached[j] and k not in micro}}
        last = j == accum - 1
        with (contextlib.nullcontext() if last or towers is None
              else grad_sync_paused(towers)):
            rows, scalars = loss_fn.encode_fn(micro, step, gen(j))
            full = {k: torch.cat([r if i == j else c[k] for i, c in enumerate(cached)])
                    for k, r in rows.items()}
            metrics = loss_fn.compute_metrics(full, scalars)
            metrics["total_loss"].backward()
        passes.append({k: v.detach() for k, v in metrics.items()})
    return {k: torch.stack([m[k] for m in passes]).mean(0) for k in passes[0]}


def make_train_step(model: torch.nn.Module, cfg: StepCfg,
                    head: Optional[DinoProjectionHead] = None,
                    dino_teacher: Any = None, group=None,
                    towers: Optional[nn.Module] = None,
                    dist_model: Optional[nn.Module] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, updating the model
    and head in place through ``state.optimizer`` (``train/optim.py:
    build_optimizer`` over ``train_parameters(model, head)``). Metrics are
    detached tensors on the device, the rank mean under ``group``: reading
    one waits for the step. ``dino_teacher`` gives the DINO rows of batches
    that carry none. With ``cfg.accum_freq`` > 1 every tensor of ``batch``
    has a leading axis of ``accum_freq`` microbatches. Under a group,
    ``towers`` is the DDP-wrapped ``Towers`` (or, under FSDP, ``Towers`` of
    the sharded modules) and the optimizer's ``sharding`` the placement of
    ZeRO-1 or FSDP. ``dist_model`` is the frozen distillation teacher,
    whole on every rank and outside ``towers``."""
    if cfg.loss_type == "distill" and dist_model is None:
        raise ValueError('loss_type "distill" needs the teacher: pass dist_model')
    loss_fn = make_loss_fn(model, cfg, head, dino_teacher, group, towers, dist_model)
    rank, world = group_rank_size(group)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        generator_for = None
        if cfg.use_patch_dropout:
            seed = int(torch.randint(0, 1 << 62, (1,), generator=state.generator))
            device = batch["images"].device
            first = rank * max(1, cfg.accum_freq)
            generator_for = lambda j: patch_dropout_generator(seed, first + j, device)  # noqa: E731
        if cfg.device_preprocess is not None:
            crop_seed = int(torch.randint(0, 1 << 62, (1,), generator=state.generator))
            batch = {**batch, "images": device_preprocess_images(cfg, batch["images"],
                                                                 crop_seed, rank, world)}
        if cfg.accum_freq > 1:
            metrics = accumulate_grads(loss_fn, batch, state.step, cfg.accum_freq, generator_for)
        else:
            _, metrics = loss_fn(batch, state.step, generator_for and generator_for(0))
            metrics["total_loss"].backward()
        sharding = getattr(state.optimizer, "sharding", None)
        if sharding is not None:
            sharding.average_grads(state.optimizer.named)
        metrics = rank_mean(metrics, group)
        if cfg.log_grad_norm:
            metrics["grad_norm"] = (state.optimizer.grad_norm()
                                    if hasattr(state.optimizer, "grad_norm")
                                    else global_norm(state.optimizer.grads()))
        state.optimizer.step(state.step)
        with torch.no_grad():
            model.logit_scale.clamp_(0.0, LN100)
        state.step += 1
        return state, metrics

    return train_step
