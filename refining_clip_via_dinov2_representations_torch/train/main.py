"""Training CLI: the run lifecycle of the port's training slice.

The port of the JAX package's ``train/main.py`` for one process:
flags -> device -> seed -> model -> tokenizer -> DINO features -> data ->
schedule -> DINO head -> param-group AdamW -> epochs of ``train_one_epoch``
-> ``loss_steps.json``, ``params.txt`` and ``checkpoints/epoch_N.pt`` under
``--logs/--name``. A checkpoint holds the open_clip-layout ``state_dict``
(which ``models.create_model(pretrained=path)`` and
``inference.create_engine(checkpoint=path)`` load strictly), the head's
state dict and the optimizer state.

The run trains on the CUDA card unless ``--force-cpu`` (or ``--device``)
asks for another device; with no card it raises. Flags the port does not
honour yet raise at parse time (``train/params.py:UNPORTED``). Evaluation,
resume, remote sync and the live teacher are later slices (ROADMAP).

Usage: python -m refining_clip_via_dinov2_representations_torch.train.main <flags>
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {"images": torch.from_numpy(np.asarray(batch["images"], np.float32)),
           "texts": torch.from_numpy(np.asarray(batch["texts"])).long()}
    if "dino_features" in batch:
        out["dino_features"] = torch.from_numpy(np.asarray(batch["dino_features"], np.float32))
    return {k: v.to(device) for k, v in out.items()}


def train_one_epoch(train_step, state, train_data, args, epoch: int, device: torch.device,
                    stop_after: int = 0):
    """One epoch of the loop: fetch, move to the device, step, and log every
    ``--log-every-n-steps`` (and at the epoch's last batch). Returns
    (state, records, steps_done); ``stop_after`` > 0 ends the epoch after
    that many steps."""
    loader = train_data.dataloader
    loader.set_epoch(epoch)
    records: List[dict] = []
    steps_done = 0
    window_samples, window_t0 = 0, time.time()
    num_batches = getattr(loader, "num_batches", None)
    for i, batch in enumerate(loader):
        state, metrics = train_step(state, _to_device(batch, device))
        steps_done += 1
        window_samples += len(batch["images"])
        stop_now = bool(stop_after and steps_done >= stop_after)
        if state.step % args.log_every_n_steps == 0 or i == (num_batches or 0) - 1 or stop_now:
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}  # waits for the step
            now = time.time()
            ips = window_samples / max(now - window_t0, 1e-9)
            window_samples, window_t0 = 0, now
            logging.info("Train Epoch: %d [%d] total_loss: %.5f logit_scale: %.3f %.1f samples/s",
                         epoch, state.step, m["total_loss"], m["logit_scale"], ips)
            records.append({"step": state.step, "epoch": epoch, **m})
        if stop_now:
            break
    return state, records, steps_done


def main(args=None):
    from ..losses import DinoLossCfg, DinoProjectionHead
    from ..models.factory import create_model, get_tokenizer
    from ..transform import image_transform_v2
    from .data import DinoFeatureStore, get_data
    from .optim import OptimCfg, build_optimizer
    from .params import parse_args
    from .scheduler import const_lr, make_schedule
    from .step import StepCfg, TrainState, make_train_step, train_parameters

    args = parse_args(args) if (args is None or isinstance(args, list)) else args
    device = torch.device(args.device or ("cpu" if args.force_cpu else "cuda"))

    if args.name is None:
        args.name = "-".join([datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
                              f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                              f"b_{args.batch_size}", f"p_{args.precision}"])
    log_base = os.path.join(args.logs, args.name)
    checkpoint_dir = os.path.join(log_base, "checkpoints")
    os.makedirs(checkpoint_dir, exist_ok=True)

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    # ---- model (raises when the device is a missing CUDA card) ----
    # nargs='+' gives a list; collapse a single value to a scalar
    if isinstance(args.force_image_size, (tuple, list)) and len(args.force_image_size) == 1:
        args.force_image_size = args.force_image_size[0]
    model, pp_cfg = create_model(args.model, args.pretrained or None, precision=args.precision,
                                 device=device, attn_impl=args.attn_impl, seed=args.seed,
                                 force_image_size=args.force_image_size,
                                 grad_checkpointing=args.grad_checkpointing)
    model.train()
    preprocess = image_transform_v2(pp_cfg, is_train=False)
    tokenizer = get_tokenizer(args.model)

    # ---- DINO teacher features: the mmap store, or synthetic ones ----
    dino_store = None
    if args.use_dino_general:
        if args.dino_fts_path:
            dino_store = DinoFeatureStore(args.dino_fts_path)
            logging.info("[DINO] feats mmap: shape=%s", dino_store.shape)
        elif args.dataset_type == "synthetic":
            args.synthetic_dino_dim = args.synthetic_dino_dim or 384
        else:
            raise NotImplementedError("--use_dino_general needs --dino_fts_path or synthetic "
                                      "data: the live DINOv2 teacher is not ported")

    data = get_data(args, (preprocess, preprocess), tokenizer=tokenizer)
    steps_per_epoch = data["train"].dataloader.num_batches
    total_steps = steps_per_epoch * args.epochs
    if args.skip_scheduler:
        schedule = const_lr(args.lr, 0, total_steps)
    else:
        schedule = make_schedule(args, args.lr, total_steps, steps_per_epoch)

    head = None
    if args.use_dino_general and args.use_projection:
        dino_dim = dino_store.shape[1] if dino_store is not None else args.synthetic_dino_dim
        torch.manual_seed(args.seed + 1)
        head = DinoProjectionHead(model.text_projection.shape[1], dino_dim,
                                  args.projection_type, args.use_layernorm).to(device)

    optim_cfg = OptimCfg(
        opt=args.opt, lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps, wd=args.wd,
        head_lr=args.head_lr, logit_scale_lr=args.logit_scale_lr, text_lr=args.text_lr,
        resnet_lr4=args.resnet_lr4, resnet_lr3=args.resnet_lr3,
        grad_clip_norm=args.grad_clip_norm, lock_image=args.lock_image,
        lock_image_unlocked_groups=args.lock_image_unlocked_groups, lock_text=args.lock_text,
        lock_text_unlocked_layers=args.lock_text_unlocked_layers,
        freeze_projection=args.freeze_projection, flatten_group_lrs=args.flatten_group_lrs,
        use_param_groups=args.use_param_groups,
    )
    optimizer, _ = build_optimizer(train_parameters(model, head), optim_cfg, schedule)
    dino_cfg = DinoLossCfg(
        lambda_original=args.lambda_original, lambda_soft=args.lambda_soft,
        soft_mode=args.soft_mode, teacher_temp=args.teacher_temp,
        soft_dino_to_text=args.soft_dino_to_text, text_lambda=args.text_lambda,
        text_student_temp=args.text_student_temp, lambda_weighted=args.lambda_weighted,
        rho=args.rho, c_clip=args.c_clip, weight_text_symmetry=args.weight_text_symmetry,
        use_projection=args.use_projection, projection_type=args.projection_type,
        use_layernorm=args.use_layernorm, residual_projection=args.residual_projection,
        residual_alpha=args.residual_alpha, with_diagnostics=args.dbg_print_every > 0,
    )
    step_cfg = StepCfg(
        loss_type="dino" if args.use_dino_general else "clip", dino=dino_cfg,
        accum_freq=args.accum_freq,
        enable_warmup_dino_hyperparams=args.enable_warmup_dino_hyperparams,
        warmup=args.warmup, log_grad_norm=bool(args.grad_clip_norm) or args.debug,
    )
    train_step = make_train_step(model, step_cfg, head)
    state = TrainState(model, head, optimizer, 0, torch.Generator().manual_seed(args.seed))

    with open(os.path.join(log_base, "params.txt"), "w") as f:
        for name in sorted(vars(args)):
            f.write(f"{name}: {getattr(args, name)}\n")

    loss_steps: List[dict] = []
    steps_budget = max(0, int(args.stop_after_steps or 0))
    for epoch in range(args.epochs):
        logging.info("Start epoch %d", epoch)
        state, records, steps_done = train_one_epoch(train_step, state, data["train"], args,
                                                     epoch, device, stop_after=steps_budget)
        loss_steps.extend(records)
        completed_epoch = epoch + 1
        if args.save_frequency > 0 and (completed_epoch % args.save_frequency == 0
                                        or completed_epoch == args.epochs):
            torch.save({
                "epoch": completed_epoch, "name": args.name, "step": state.step,
                "state_dict": model.state_dict(),
                "dino_head": None if head is None else head.state_dict(),
                "optimizer": optimizer.state_dict(),
            }, os.path.join(checkpoint_dir, f"epoch_{completed_epoch}.pt"))
        if steps_budget:
            steps_budget -= steps_done
            if steps_budget <= 0:
                logging.warning("--stop-after-steps %d reached at epoch %d",
                                args.stop_after_steps, epoch)
                break

    with open(os.path.join(log_base, "loss_steps.json"), "w") as f:
        json.dump(loss_steps, f)
    return loss_steps


if __name__ == "__main__":
    main()
