"""The training step: forward both towers, the loss, backward, param-group
AdamW, the logit-scale clamp.

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
it; ``grad_norm`` of the raw gradients when ``log_grad_norm`` is set.
Gradient accumulation, the other loss types, patch dropout, BatchNorm
towers, device preprocessing and live teachers raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..losses import DinoLossCfg, clip_loss, dino_enhanced_loss
from ..losses.dino import DinoProjectionHead
from .optim import HEAD_PREFIX, GroupAdamW, global_norm

LN100 = math.log(100.0)
LOSS_TYPES = ("clip", "dino")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    head: Optional[DinoProjectionHead]
    optimizer: GroupAdamW
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
            "gradient accumulation (accum_freq > 1)": self.accum_freq > 1,
            "patch dropout": self.use_patch_dropout,
            "device preprocessing": self.device_preprocess is not None,
        }
        for what, present in unported.items():
            if present:
                raise NotImplementedError(
                    f"{what}: the port's train step has the clip and dino losses, one "
                    "step per batch, so far (ROADMAP Queue 1 item 5)")


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
    dino_features [B,Dd]. ``loss_fn.encode_fn`` gives the per-sample rows and
    batch scalars; ``loss_fn.compute_metrics`` the losses from them."""
    if dino_teacher is not None:
        raise NotImplementedError("the live DINOv2 teacher is not ported (ROADMAP Queue 1 item 9)")

    def encode_fn(batch: Dict[str, torch.Tensor], step: int):
        out = model(batch["images"], batch["texts"])
        rows = {"img_f": out["image_features"], "txt_f": out["text_features"]}
        scalars: Dict[str, Any] = {"logit_scale": out["logit_scale"]}
        if cfg.loss_type == "dino":
            dino_feats = batch.get("dino_features")
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

    def loss_fn(batch, step):
        rows, scalars = encode_fn(batch, step)
        metrics = compute_metrics(rows, scalars)
        return metrics["total_loss"], metrics

    loss_fn.encode_fn = encode_fn
    loss_fn.compute_metrics = compute_metrics
    return loss_fn


def make_train_step(model: torch.nn.Module, cfg: StepCfg,
                    head: Optional[DinoProjectionHead] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, updating the model
    and head in place through ``state.optimizer`` (``train/optim.py:
    build_optimizer`` over ``train_parameters(model, head)``). Metrics are
    detached tensors on the device: reading one waits for the step."""
    loss_fn = make_loss_fn(model, cfg, head)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        _, metrics = loss_fn(batch, state.step)
        metrics["total_loss"].backward()
        if cfg.log_grad_norm:
            metrics["grad_norm"] = global_norm(state.optimizer.grads())
        state.optimizer.step(state.step)
        with torch.no_grad():
            model.logit_scale.clamp_(0.0, LN100)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
