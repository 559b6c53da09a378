"""The training step: forward both towers, the loss, backward, the
param-group optimizer (``train/optim.py``), the logit-scale clamp.

The port of the JAX package's ``train/step.py`` for one process and the
``"clip"`` and ``"dino"`` losses. PyTorch runs eagerly, so there is no
compiled function: ``make_train_step`` returns a closure over the model, the
DINO head and the optimizer that updates them in place. On a CUDA model
every attention call of both towers runs the fused kernels, forward and
backward (``ops/attention.py``, ``"auto"`` or ``"fused"``); with
``"flash"``, attention over 512 or more queries runs the flash forward
kernel and the shorter calls the plain path.

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

``accum_freq`` > 1 is the JAX step's cached-feature gradient accumulation:
the batch holds ``accum`` microbatches stacked on a leading axis; phase 1
encodes each under ``no_grad`` and caches its rows; phase 2 encodes each
again with grad, puts its live rows in its slot of the cached full batch,
takes the loss over all ``accum * B`` rows and backpropagates, so the
gradients add up in ``.grad`` to the single big batch's. The loss is not
scaled by ``1 / accum``, and the logit scale is live in every pass, so its
gradient is ``accum`` times the big batch's (as in torch and the JAX step).
The teacher's rows come from phase 1 and are reused in phase 2: the live
teacher runs once a microbatch. The metrics are the mean over the passes.

Patch dropout (``use_patch_dropout``, on a model whose vision config has a
probability) is the step's one random draw. Each step takes a seed from
the state's generator (saved in checkpoints, so a resume draws on) and
gives microbatch ``j`` a generator on the model's device seeded from it
with ``j`` folded in (``patch_dropout_generator``), as the JAX step folds
the microbatch index into its rng: both phases of ``accumulate_grads`` see
the same kept tokens for the same rows. Forwards without a generator (the
evaluations, CLIP-blind) keep every token.

The other loss types, BatchNorm towers and device preprocessing raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..losses import DinoLossCfg, clip_loss, dino_enhanced_loss
from ..losses.dino import DinoProjectionHead
from .optim import HEAD_PREFIX, GroupOptimizer, global_norm

LN100 = math.log(100.0)
LOSS_TYPES = ("clip", "dino")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    head: Optional[DinoProjectionHead]
    optimizer: GroupOptimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class StepCfg:
    loss_type: str = "clip"  # clip | dino
    dino: DinoLossCfg = DinoLossCfg()
    accum_freq: int = 1
    enable_warmup_dino_hyperparams: bool = False
    warmup: int = 10000
    use_patch_dropout: bool = False
    device_preprocess: Optional[Tuple] = None
    log_grad_norm: bool = False

    def __post_init__(self):
        unported = {
            f"loss_type {self.loss_type!r}": self.loss_type not in LOSS_TYPES,
            "device preprocessing": self.device_preprocess is not None,
        }
        for what, present in unported.items():
            if present:
                raise NotImplementedError(
                    f"{what}: the port's train step has the clip and dino losses, without "
                    "device preprocessing, so far (ROADMAP Queue 1 item 5)")


# an odd 63-bit constant (the golden ratio's): folds a microbatch index
# into the step's seed
_FOLD = 0x1E3779B97F4A7C15


def patch_dropout_generator(seed: int, index: int, device) -> torch.Generator:
    """Microbatch ``index``'s generator on ``device``: ``seed`` with the
    index folded in. The same (seed, index) gives the same draws."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + _FOLD * (index + 1)) % (1 << 63))
    return g


def train_parameters(model: torch.nn.Module, head: Optional[torch.nn.Module]
                     ) -> Dict[str, torch.nn.Parameter]:
    """Every trained tensor by name: the model's, then the head's under
    ``dino_head.`` (the JAX train tree's ``{"model", "dino_head"}``)."""
    params = dict(model.named_parameters())
    if head is not None:
        params.update({HEAD_PREFIX + n: p for n, p in head.named_parameters()})
    return params


def _lambda_overrides(cfg: StepCfg, step: int) -> Dict[str, float]:
    """lambda_soft grows linearly over ``warmup`` steps; the other lambdas
    stay at full strength from step 0."""
    if not cfg.enable_warmup_dino_hyperparams:
        return {}
    frac = min(1.0, float(step) / max(1, cfg.warmup))
    return {"lambda_soft": frac * cfg.dino.lambda_soft}


def make_loss_fn(model: torch.nn.Module, cfg: StepCfg,
                 head: Optional[DinoProjectionHead] = None,
                 dino_teacher: Any = None) -> Callable:
    """``loss_fn(batch, step) -> (loss, metrics)``. ``batch`` holds tensors on
    the model's device: images [B,H,W,3] float, texts [B,L] int, optional
    dino_features [B,Dd]; without them, ``dino_teacher`` (a
    ``LiveDinoTeacher``) encodes the images. ``loss_fn.encode_fn`` gives the
    per-sample rows and batch scalars; ``loss_fn.compute_metrics`` the losses
    from them."""

    def encode_fn(batch: Dict[str, torch.Tensor], step: int,
                  generator: Optional[torch.Generator] = None):
        out = model(batch["images"], batch["texts"], patch_dropout_generator=generator)
        rows = {"img_f": out["image_features"], "txt_f": out["text_features"]}
        scalars: Dict[str, Any] = {"logit_scale": out["logit_scale"]}
        if cfg.loss_type == "dino":
            dino_feats = batch.get("dino_features")
            if dino_feats is None and dino_teacher is not None:
                dino_feats = dino_teacher.extract(batch["images"])
            if dino_feats is not None:
                rows["dino_features"] = dino_feats
                if cfg.dino.use_projection and head is not None:
                    rows["raw_proj"] = head(rows["img_f"])
            scalars.update(_lambda_overrides(cfg, step))
        return rows, scalars

    def compute_metrics(rows, scalars) -> Dict[str, torch.Tensor]:
        logit_scale = scalars["logit_scale"]
        metrics = {"logit_scale": logit_scale}
        if cfg.loss_type == "clip":
            total = clip_loss(rows["img_f"], rows["txt_f"], logit_scale)
            metrics["contrastive_loss"] = total
        else:
            losses = dino_enhanced_loss(
                rows["img_f"], rows["txt_f"], logit_scale, rows.get("dino_features"),
                cfg.dino, image_proj=rows.get("raw_proj"),
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
    return loss_fn


def accumulate_grads(loss_fn: Callable, batch: Dict[str, torch.Tensor], step: int,
                     accum: int, generator_for: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
    """Cached-feature accumulation over ``batch``'s ``accum`` stacked
    microbatches: adds the gradients of the full-batch loss into ``.grad``
    (see the module docstring) and returns the metrics' mean over the
    passes. ``generator_for(j)`` gives microbatch ``j``'s patch-dropout
    generator, a fresh one in each phase."""
    gen = generator_for or (lambda j: None)
    micros = [{k: v[j] for k, v in batch.items()} for j in range(accum)]
    with torch.no_grad():
        cached = [loss_fn.encode_fn(m, step, gen(j))[0] for j, m in enumerate(micros)]
    passes = []
    for j, micro in enumerate(micros):
        if "dino_features" in cached[j] and "dino_features" not in micro:
            micro = {**micro, "dino_features": cached[j]["dino_features"]}
        rows, scalars = loss_fn.encode_fn(micro, step, gen(j))
        full = {k: torch.cat([r if i == j else c[k] for i, c in enumerate(cached)])
                for k, r in rows.items()}
        metrics = loss_fn.compute_metrics(full, scalars)
        metrics["total_loss"].backward()
        passes.append({k: v.detach() for k, v in metrics.items()})
    return {k: torch.stack([m[k] for m in passes]).mean(0) for k in passes[0]}


def make_train_step(model: torch.nn.Module, cfg: StepCfg,
                    head: Optional[DinoProjectionHead] = None,
                    dino_teacher: Any = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, updating the model
    and head in place through ``state.optimizer`` (``train/optim.py:
    build_optimizer`` over ``train_parameters(model, head)``). Metrics are
    detached tensors on the device: reading one waits for the step.
    ``dino_teacher`` gives the DINO rows of batches that carry none. With
    ``cfg.accum_freq`` > 1 every tensor of ``batch`` has a leading axis of
    ``accum_freq`` microbatches."""
    loss_fn = make_loss_fn(model, cfg, head, dino_teacher)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        generator_for = None
        if cfg.use_patch_dropout:
            seed = int(torch.randint(0, 1 << 62, (1,), generator=state.generator))
            device = batch["images"].device
            generator_for = lambda j: patch_dropout_generator(seed, j, device)  # noqa: E731
        if cfg.accum_freq > 1:
            metrics = accumulate_grads(loss_fn, batch, state.step, cfg.accum_freq, generator_for)
        else:
            _, metrics = loss_fn(batch, state.step, generator_for and generator_for(0))
            metrics["total_loss"].backward()
        if cfg.log_grad_norm:
            metrics["grad_norm"] = global_norm(state.optimizer.grads())
        state.optimizer.step(state.step)
        with torch.no_grad():
            model.logit_scale.clamp_(0.0, LN100)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
