"""Training CLI: the run lifecycle of the port's training slice.

The port of the JAX package's ``train/main.py`` for one process:
flags -> device -> logging -> seed -> model (``--pretrained`` tag or file,
read offline under ``--cache-dir``) and transforms -> tokenizer ->
DINO features (the precomputed store, or the live DINOv2 teacher) and index
map -> data -> schedule -> DINO head ->
param-group AdamW -> resume -> pre-train evaluation over every val key ->
epochs of {``train_one_epoch`` -> evaluation -> best-epoch tracking ->
checkpoint} -> final artifacts -> the CLIP-blind check. The first val key's
evaluation of an epoch also runs zero-shot ImageNet (``--imagenet-val``,
``--imagenet-v2``, gated by ``--zeroshot-frequency``); with ImageNet data and
no val key it runs alone. Without ``--train-data`` the run evaluates once
(Config 1: zero-shot retrieval and ImageNet from ``--pretrained``) and
returns the results.

Under ``--logs/--name`` a run writes ``out.log``, ``params.txt``,
``loss_steps.json``, ``final_itm_results.json`` (the pre-train evaluation
as its epoch-0 entry, which never counts as "best"), ``best_metrics.json``
(the epoch with the best mean of the six recalls, tie-broken by the mean
R@1), ``itm_scores.csv``, ``checkpoints/epoch_N.pt`` (``train/checkpoint.py``)
and, under ``--run_clip_blind``, ``clip_blind/clip_blind_{val,train}.json``
with their top-pair CSVs. ``--resume latest|<path>`` continues at the saved
epoch boundary, and the artifacts of the earlier run are carried over, so
that they cover the whole run. The recall plots are drawn where
``matplotlib`` exists; a plot that fails is a warning, as are a failed
pre-train evaluation and a failed train-split CLIP-blind check, as in the
JAX package.

One difference from the JAX package: its precomputed-feature CLIP-blind
check of the train split reads the train loader, whose batches carry no
image paths, so it always fails (and is logged). The port runs it over an
eval loader of the train CSV, as the JAX package's live-teacher branch
does. ``--stop-after-steps`` ends the run after that epoch's evaluation
and checkpoint (mid-epoch resume is not ported).

With ``--use_dino_general`` and no ``--dino_fts_path`` (on CSV data, or on
synthetic data with ``--dino_model_name``) the teacher runs live:
``--dino_model_name`` (default ``facebook/dinov2-small``) is a local HF
directory, or a hub name found in the hub cache under ``--cache-dir``
(``models/dinov2.py:load_dinov2_model``; nothing is downloaded). It computes
in the CLI's dtype on the run's device with ``--attn-impl``, inverts the
student's ``preprocess_val`` normalisation, sets the DINO head's width, and
stays out of the optimizer, the gradient norm, the checkpoints and the
resume. Its CLIP-blind check covers both splits, each failure a warning.

The run trains on the CUDA card unless ``--force-cpu`` (or ``--device``)
asks for another device; with no card it raises. Flags the port does not
honour yet raise at parse time (``train/params.py:UNPORTED``).

Usage: python -m refining_clip_via_dinov2_representations_torch.train.main <flags>
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
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


def _data_order_flags(args) -> Dict[str, int]:
    """The flags that fix the train batch order, recorded in checkpoints."""
    return {"accum_freq": max(1, int(args.accum_freq or 1)), "batch_size": int(args.batch_size),
            "seed": int(args.seed or 0), "world": 1}


def _preload_artifacts(log_base: str, resumed_step: int, start_epoch: int):
    """The earlier run's ``loss_steps.json`` and ``final_itm_results.json``
    records up to the restored step and epoch, so that a resumed run's
    artifacts cover the whole run."""
    loss_steps, all_results = [], []
    try:
        with open(os.path.join(log_base, "loss_steps.json")) as f:
            loss_steps = [r for r in json.load(f) if r.get("step", 0) <= resumed_step]
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    try:
        with open(os.path.join(log_base, "final_itm_results.json")) as f:
            all_results = [e for e in json.load(f) if e.get("epoch", 0) <= start_epoch]
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    if loss_steps or all_results:
        logging.info("resume: preloaded %d loss-step records and %d epoch-eval entries from "
                     "the earlier run", len(loss_steps), len(all_results))
    return loss_steps, all_results


def _update_best(best: dict, epoch: int, results: List[dict]) -> dict:
    """The better of ``best`` and this epoch's results, by
    ``epoch_retrieval_score``."""
    from .helpers import epoch_retrieval_score

    score, tie = epoch_retrieval_score(results)
    if math.isnan(score) or (score, tie) <= (best["score"], best["tie"]):
        return best
    new = {"score": score, "tie": tie, "epoch": epoch}
    if results:
        new["metrics"] = {r["val_name"]: r["metrics"] for r in results}
    return new


def build_transforms(args, pp_cfg):
    """(train, eval) transforms of the model's preprocess config with the
    ``--image-*`` overrides; the train one takes ``--aug-cfg`` and, as in
    the JAX CLI, an unseeded generator."""
    from ..transform import PreprocessCfg, image_transform_v2, merge_preprocess_dict

    pp_cfg = PreprocessCfg(**merge_preprocess_dict(pp_cfg, {
        "mean": args.image_mean, "std": args.image_std,
        "interpolation": args.image_interpolation, "resize_mode": args.image_resize_mode}))
    return (image_transform_v2(pp_cfg, is_train=True, aug_cfg=args.aug_cfg),
            image_transform_v2(pp_cfg, is_train=False))


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
    """Runs the CLI. Returns the logged loss records of a training run, or
    the ``{"val_name", "metrics"}`` results of an eval-only run (no
    ``--train-data``)."""
    from .params import parse_args

    args = parse_args(args) if (args is None or isinstance(args, list)) else args
    with contextlib.ExitStack() as stack:
        if args.debug:  # raise at the first NaN of a backward
            stack.enter_context(torch.autograd.detect_anomaly())
        return _main(args)


def _main(args):
    from ..eval.clip_blind import run_clip_blind_on_split
    from ..losses import DinoLossCfg, DinoProjectionHead
    from ..models.factory import _precision_to_dtype, create_model, get_tokenizer
    from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from .data import (DinoFeatureStore, _clone_args, get_csv_dataset, get_data,
                       get_dataset_fn, load_dino_index_map)
    from .dino_teacher import LiveDinoTeacher
    from .evaluate import evaluate
    from .logger import setup_logging
    from .optim import OptimCfg, build_optimizer
    from .scheduler import const_lr, make_schedule
    from .step import StepCfg, TrainState, make_train_step, train_parameters

    device = torch.device(args.device or ("cpu" if args.force_cpu else "cuda"))
    if args.name is None:
        args.name = "-".join([datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
                              f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                              f"b_{args.batch_size}", f"p_{args.precision}"])
    log_base = os.path.join(args.logs, args.name)
    checkpoint_dir = os.path.join(log_base, "checkpoints")
    os.makedirs(checkpoint_dir, exist_ok=True)
    setup_logging(os.path.join(log_base, "out.log"), logging.DEBUG if args.debug else logging.INFO)

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    # ---- model and transforms (raises when the device is a missing card) ----
    # nargs='+' gives a list; collapse a single value to a scalar
    if isinstance(args.force_image_size, (tuple, list)) and len(args.force_image_size) == 1:
        args.force_image_size = args.force_image_size[0]
    model, pp_cfg = create_model(args.model, args.pretrained or None, precision=args.precision,
                                 device=device, attn_impl=args.attn_impl, seed=args.seed,
                                 force_quick_gelu=args.force_quick_gelu,
                                 force_image_size=args.force_image_size,
                                 cache_dir=args.cache_dir,
                                 grad_checkpointing=args.grad_checkpointing)
    model.train()
    preprocess_train, preprocess_val = build_transforms(args, pp_cfg)
    tokenizer = get_tokenizer(args.model, cache_dir=args.cache_dir)

    # ---- DINO teacher features: the precomputed store, synthetic ones, or
    # the live teacher ----
    dino_store = dino_index_map = dino_teacher = None
    if args.use_dino_general:
        if args.dino_fts_path:
            dino_store = DinoFeatureStore(args.dino_fts_path)
            logging.info("[DINO] feats mmap: shape=%s", dino_store.shape)
        elif args.dataset_type == "synthetic" and not args.dino_model_name:
            args.synthetic_dino_dim = args.synthetic_dino_dim or 384
        else:
            name = args.dino_model_name or "facebook/dinov2-small"
            dino_teacher = LiveDinoTeacher.from_pretrained(
                name, dtype=_precision_to_dtype(args.precision)[0], cache_dir=args.cache_dir,
                input_mean=preprocess_val.mean, input_std=preprocess_val.std, device=device,
                attn_impl=args.attn_impl)
            logging.info("[DINO] live teacher %s (dim %d) runs inside the train step", name,
                         dino_teacher.hidden_size)
        if args.dino_index_map_path:
            dino_index_map = load_dino_index_map(args.dino_index_map_path)

    data = get_data(args, (preprocess_train, preprocess_val), epoch=0, tokenizer=tokenizer,
                    dino_index_map=dino_index_map)
    if not data:
        raise ValueError("At least one train or eval dataset must be specified.")

    # ---- schedule, DINO head, optimizer, train step ----
    state = train_step = None
    if "train" in data:
        steps_per_epoch = data["train"].dataloader.num_batches
        total_steps = steps_per_epoch * args.epochs
        if args.skip_scheduler:
            schedule = const_lr(args.lr, 0, total_steps)
        else:
            schedule = make_schedule(args, args.lr, total_steps, steps_per_epoch)
        head = None
        if args.use_dino_general and args.use_projection:
            if dino_store is not None:
                dino_dim = dino_store.shape[1]
            elif dino_teacher is not None:
                dino_dim = dino_teacher.hidden_size
            else:
                dino_dim = args.synthetic_dino_dim
            torch.manual_seed(args.seed + 1)
            head = DinoProjectionHead(model.text_projection.shape[1], dino_dim,
                                      args.projection_type, args.use_layernorm).to(device)
        optim_cfg = OptimCfg(
            opt=args.opt, lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
            wd=args.wd, head_lr=args.head_lr, logit_scale_lr=args.logit_scale_lr,
            text_lr=args.text_lr, resnet_lr4=args.resnet_lr4, resnet_lr3=args.resnet_lr3,
            grad_clip_norm=args.grad_clip_norm, lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text, lock_text_unlocked_layers=args.lock_text_unlocked_layers,
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
        train_step = make_train_step(model, step_cfg, head, dino_teacher)
        state = TrainState(model, head, optimizer, 0, torch.Generator().manual_seed(args.seed))

    # ---- resume at an epoch boundary ----
    start_epoch = 0
    if args.resume is not None and state is not None:
        if args.resume != "latest":
            resume_path = args.resume
            if "://" in resume_path:
                raise NotImplementedError(f"--resume {resume_path}: remote checkpoints are "
                                          "not ported (ROADMAP Queue 1 item 8)")
        elif args.save_most_recent:
            # --save-most-recent resumes from epoch_latest, not the newest
            # epoch_N (those may be pruned or gated by --save-frequency)
            resume_path = os.path.join(checkpoint_dir, "epoch_latest.pt")
            resume_path = resume_path if os.path.isfile(resume_path) else None
        else:
            resume_path = latest_checkpoint(checkpoint_dir)
        if resume_path:
            state, start_epoch = restore_checkpoint(resume_path, state)
            logging.info("=> resuming checkpoint '%s' (epoch %d)", resume_path, start_epoch)
        else:
            logging.info("=> no checkpoint found at %s", args.resume)

    with open(os.path.join(log_base, "params.txt"), "w") as f:
        for name in sorted(vars(args)):
            f.write(f"{name}: {getattr(args, name)}\n")

    eval_keys = [k for k in ("val", "flickr30k-val", "mscoco-val") if k in data]
    # ImageNet data without a retrieval key still evaluates (zero-shot alone)
    has_zs = any(k in data for k in ("imagenet-val", "imagenet-v2"))
    eval_rounds = eval_keys or (["val"] if has_zs else [])

    def evaluate_all(epoch: int) -> List[dict]:
        """Every round's metrics at ``epoch``; zero-shot with the first."""
        results = []
        for i, key in enumerate(eval_rounds):
            m = evaluate(model, data, epoch, args, tokenizer, val_key=key,
                         include_zero_shot=(i == 0))
            if m:
                results.append({"val_name": key, "metrics": m})
        return results

    if "train" not in data:  # eval-only
        return evaluate_all(start_epoch)

    # ---- pre-train evaluation: the epoch-0 entry, never "best" ----
    pretrain_results = []
    if start_epoch == 0:
        for i, key in enumerate(eval_rounds):
            try:
                m = evaluate(model, data, 0, args, tokenizer, val_key=key,
                             include_zero_shot=(i == 0))
                if m:
                    pretrain_results.append({"val_name": key, "metrics": m})
            except Exception as e:  # the pre-train evaluation does not end the run
                logging.warning("pre-train eval on %s failed: %r", key, e)

    loss_steps, all_results = (_preload_artifacts(log_base, state.step, start_epoch)
                               if args.resume else ([], []))
    if pretrain_results and not any(r.get("epoch") == 0 for r in all_results):
        all_results.insert(0, {"epoch": 0, "results": pretrain_results})
    best = {"score": float("-inf"), "tie": float("-inf"), "epoch": -1}
    for prior in all_results:
        if prior.get("epoch") != 0:
            best = _update_best(best, prior["epoch"], prior["results"])

    steps_budget = max(0, int(args.stop_after_steps or 0))
    for epoch in range(start_epoch, args.epochs):
        logging.info("Start epoch %d", epoch)
        state, records, steps_done = train_one_epoch(train_step, state, data["train"], args,
                                                     epoch, device, stop_after=steps_budget)
        loss_steps.extend(records)
        completed_epoch = epoch + 1

        epoch_results = evaluate_all(completed_epoch)
        all_results.append({"epoch": completed_epoch, "results": epoch_results})
        best = _update_best(best, completed_epoch, epoch_results)

        if args.save_frequency > 0 and (completed_epoch % args.save_frequency == 0
                                        or completed_epoch == args.epochs):
            save_checkpoint(checkpoint_dir, state, completed_epoch, name=args.name,
                            save_most_recent=args.save_most_recent,
                            delete_previous=args.delete_previous_checkpoint,
                            data_order=_data_order_flags(args))
        if steps_budget:
            steps_budget -= steps_done
            if steps_budget <= 0:
                logging.warning("--stop-after-steps %d reached at epoch %d",
                                args.stop_after_steps, epoch)
                break

    # ---- final artifacts ----
    with open(os.path.join(log_base, "loss_steps.json"), "w") as f:
        json.dump(loss_steps, f)
    itm_path = os.path.join(log_base, "final_itm_results.json")
    with open(itm_path, "w") as f:
        json.dump(all_results, f, default=float)
    if any(e["results"] for e in all_results):
        from ..eval.my_metrics import extract_and_plot_itm_scores

        try:
            extract_and_plot_itm_scores(
                itm_path, os.path.join(log_base, "itm_recall_plot.png"),
                os.path.join(log_base, "itm_similarity_plot.png"),
                save_csv_path=os.path.join(log_base, "itm_scores.csv"))
        except Exception as e:  # plots never fail the run
            logging.warning("ITM plotting failed: %r", e)
    if best["epoch"] >= 0:
        with open(os.path.join(log_base, "best_metrics.json"), "w") as f:
            json.dump(best, f, default=float)
        logging.info("Best epoch %d with retrieval score %.4f", best["epoch"], best["score"])

    # ---- the CLIP-blind check over the precomputed or live teacher features ----
    if args.run_clip_blind and args.use_dino_general and (dino_store is not None
                                                          or dino_teacher is not None):
        blind_dir = os.path.join(log_base, "clip_blind")
        if dino_teacher is not None:
            # the teacher encodes the val images themselves: no store, no map
            try:
                run_clip_blind_on_split("val", data, model, None, None, blind_dir,
                                        max_images=args.clip_blind_max_images,
                                        dino_teacher=dino_teacher)
            except Exception as e:  # a failure on either split is a warning
                logging.warning("[clip-blind] val-split check failed: %r", e)
        # the val split needs its own store and map: the train map does not
        # cover val paths and the basename fallback would align wrong rows
        elif args.dino_fts_path_val and args.dino_index_map_path_val:
            run_clip_blind_on_split(
                "val", data, model, np.asarray(DinoFeatureStore(args.dino_fts_path_val).features),
                {"path_to_index": load_dino_index_map(args.dino_index_map_path_val)},
                blind_dir, max_images=args.clip_blind_max_images)
        else:
            logging.warning("[CLIP-blind/val] missing --dino_fts_path_val / "
                            "--dino_index_map_path_val; skipping.")
        try:  # a failure on the train split is a warning
            if not (args.train_data
                    and get_dataset_fn(args.train_data, args.dataset_type) is get_csv_dataset):
                raise ValueError("the train split needs CSV --train-data (its image paths)")
            run_clip_blind_on_split(
                "train", {"train": get_csv_dataset(_clone_args(args, val_data=args.train_data),
                                                   preprocess_val, is_train=False,
                                                   tokenizer=tokenizer)},
                model, None if dino_store is None else np.asarray(dino_store.features),
                {"path_to_index": dino_index_map or {}}, blind_dir,
                max_images=args.clip_blind_max_images, dino_teacher=dino_teacher)
        except Exception as e:
            logging.warning("[clip-blind] train-split check failed: %r", e)
    return loss_steps


if __name__ == "__main__":
    main()
