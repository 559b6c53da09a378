"""Training CLI: the run lifecycle of the port's training slice.

The port of the JAX package's ``train/main.py`` for one process:
flags -> device -> logging -> seed -> model (``--pretrained`` tag or file,
read offline under ``--cache-dir``; ``--force-patch-dropout``,
``--grad-checkpointing`` under ``--remat-policy``) and transforms ->
tokenizer -> DINO features (the precomputed store, or the live DINOv2
teacher) and index map -> data -> schedule -> DINO head -> the param-group
optimizer (``--opt``, ``--adam-mu-dtype``) -> resume -> pre-train evaluation over every val key ->
epochs of {``train_one_epoch`` -> evaluation -> best-epoch tracking ->
checkpoint} -> final artifacts -> the CLIP-blind check -> the final remote
sync. The first val key's
evaluation of an epoch also runs zero-shot ImageNet (``--imagenet-val``,
``--imagenet-v2``, gated by ``--zeroshot-frequency``); with ImageNet data and
no val key it runs alone. Without ``--train-data`` the run evaluates once
(Config 1: zero-shot retrieval and ImageNet from ``--pretrained``) and
returns the results.

Under ``--logs/--name`` a run writes ``out.log``, ``params.txt``,
``loss_steps.json``, ``loss_curves.png``, ``final_itm_results.json`` (the
pre-train evaluation as its epoch-0 entry, which never counts as "best"),
``best_metrics.json`` (the epoch with the best mean of the six recalls,
tie-broken by the mean R@1), ``itm_scores.csv``, ``checkpoints/epoch_N.pt``
(``train/checkpoint.py``), ``checkpoints/final_torch_state.pt`` (the model
in open_clip's ``{"epoch", "name", "state_dict"}`` file, which the offline
suite reads) and, under ``--run_clip_blind``,
``clip_blind/clip_blind_{val,train}.json`` with their top-pair CSVs;
``--report-to tensorboard`` adds ``tensorboard/`` (``train/loggers.py``:
TensorBoard, MLflow and wandb where their packages import, else a warning),
``--copy-codebase`` a copy of this package under ``code/``. The plots are
drawn where ``matplotlib`` exists; a plot that fails is a warning, as are a
failed pre-train evaluation and a failed train-split CLIP-blind check, as
in the JAX package.

Preemption: under ``--save-on-preemption`` a SIGTERM ends the epoch at the
next optimizer step; ``--stop-after-steps N`` does the same after N steps
of the run. The run then saves ``checkpoints/epoch_E_preempt.pt`` with its
position in the epoch (``step_in_epoch``) and the flags that fix the batch
order, skips that epoch's evaluation, writes the final artifacts and
returns. ``--resume latest|<path>|<url>`` continues a preemption save at
its optimizer step inside the epoch (the loader skips the batches already
trained, unread), or an epoch save at the epoch's start, and carries the
earlier run's records over, so that the artifacts cover the whole run; a
preemption save whose batch-order flags differ from this run's redoes its
epoch, with a warning. ``--async-checkpoint`` writes every checkpoint on a
background thread, ``--remote-sync DIR`` mirrors the run directory to a
local path or fsspec URL (at the start, every ``--remote-sync-frequency``
seconds from a daemon process, and at every exit), and ``--resume latest``
with it takes the newest checkpoint of the remote run.

``--accum-freq a`` makes one optimizer step of ``a`` loader batches
(``train/step.py``'s cached-feature accumulation).

One difference from the JAX package: its precomputed-feature CLIP-blind
check of the train split reads the train loader, whose batches carry no
image paths, so it always fails (and is logged). The port runs it over an
eval loader of the train CSV, as the JAX package's live-teacher branch
does.

With ``--use_dino_general`` and no ``--dino_fts_path`` (on CSV data, or on
synthetic data with ``--dino_model_name``) the teacher runs live:
``--dino_model_name`` (default ``facebook/dinov2-small``) is a local HF
directory, or a hub name found in the hub cache under ``--cache-dir``
(``models/dinov2.py:load_dinov2_model``; nothing is downloaded). It computes
in the CLI's dtype on the run's device with ``--attn-impl``, inverts the
student's ``preprocess_val`` normalisation, sets the DINO head's width, and
stays out of the optimizer, the gradient norm, the checkpoints and the
resume. Its CLIP-blind check covers both splits, each failure a warning.

``--device-preprocess`` makes the train transform
``transform.py:raw_uint8_transform(--device-preprocess-raw-size)``: the
loaders decode (JPEGs through the native DCT-scaled decoder) and ship uint8
at the raw size, and the train step crops, resamples and normalises on the
device to the model's input size with its mean and std
(``train/step.py``). Evaluation keeps the host pipeline.

A CoCa model (a ``coca_*`` config, or ``--use_coca``) trains with the CoCa
loss, which takes precedence over SigLIP, CyCLIP and DINO as in the JAX CLI,
its ``--coca-*-loss-weight`` flags and CustomTextCLIP's locking and groups;
its validation adds ``val_generative_loss``. ``--distill-model`` with
``--distill-pretrained`` (before every other loss) trains under a frozen
CLIP teacher built by ``create_model`` at ``--precision`` and loaded by its
tag or file: in eval mode, whole on every rank (outside DDP, ZeRO-1, FSDP
and the model axis) and in no checkpoint. ``--use_CyClip`` takes the CyCLIP
loss. A ModifiedResNet (``RN*``) trains its BatchNorm running statistics
(``train/step.py``); ``--lock-image --lock-image-freeze-bn-stats`` keeps
them, and patch dropout is off for it, with the JAX CLI's warning.

The run trains on the CUDA card unless ``--force-cpu`` (or ``--device``)
asks for another device; with no card it raises. Flags the port does not
honour yet raise at parse time (``train/params.py:UNPORTED``).

A SigLIP model (``--model ViT-B-16-SigLIP``, Config 4 with ``--siglip``)
takes its tokenizer from its config's hub repo under ``--cache-dir``
(``tokenizer.py:HFTokenizer``), and tar shards train it
(``--dataset-type webdataset``, ``train/webdataset.py``).

Multi-GPU: one process a GPU, launched by torchrun (``torchrun
--nproc-per-node N -m refining_clip_via_dinov2_representations_torch.train.
main ...``) or any launcher that sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
(``train/distributed.py``). The process group comes first; then the
``(data, model)`` mesh (``--mesh-model-axis`` ranks a model: it must divide
the world size and every tower's and the teacher's head count), and the
global batch (``--batch-size`` is per data rank). Under a model axis the
model, the DINO head and the live teacher are split over each model group
(``parallel/tensor.py``), whose ranks read the same rows and compute the
same loss. Each data rank trains on its shard of every epoch; the losses
gather over the data ranks (``train/step.py``); DDP averages the gradients
over them, under
``--shard-opt-state`` each rank keeps and updates the optimizer state of
its slices (ZeRO-1), and under ``--fsdp`` (``--fsdp-min-size``) the blocks,
the model and the head are sharded with ``fully_shard`` (ZeRO-3). Every
rank evaluates its share of each val batch and runs the CLIP-blind check
with the others; only rank 0 writes the logs, the Tracker, checkpoints,
``final_torch_state.pt``, the plots, the remote sync and the codebase copy.
``--resume latest`` is resolved on rank 0 and broadcast; a checkpoint holds
the whole state whatever the mesh, and resumes at any other. Under
``--save-on-preemption`` the ranks agree at every step whether one of them
was signalled.

Usage: python -m refining_clip_via_dinov2_representations_torch.train.main <flags>
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import random
import shutil
import signal
import threading
import time
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .distributed import any_rank

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    images = np.asarray(batch["images"])  # uint8 under --device-preprocess: a quarter the bytes
    out = {"images": torch.from_numpy(images if images.dtype == np.uint8
                                      else images.astype(np.float32, copy=False)),
           "texts": torch.from_numpy(np.asarray(batch["texts"])).long()}
    if "dino_features" in batch:
        out["dino_features"] = torch.from_numpy(np.asarray(batch["dino_features"], np.float32))
    return {k: v.to(device) for k, v in out.items()}


def _data_order_flags(args) -> Dict[str, int]:
    """The flags that fix the train batch order, recorded in checkpoints:
    a preemption save's ``step_in_epoch`` counts steps in this order. The
    data axis's size is the ``world`` the loader shards over."""
    world = getattr(args, "data_world_size", getattr(args, "world_size", 1))
    return {"accum_freq": max(1, int(args.accum_freq or 1)), "batch_size": int(args.batch_size),
            "seed": int(args.seed or 0), "world": int(world or 1)}


def _fetch_remote_artifacts(remote_run_dir: str, log_base: str) -> None:
    """The remote run's ``loss_steps.json`` and ``final_itm_results.json``
    where this run directory has none (a resume on a fresh host)."""
    from .checkpoint import fetch_remote_checkpoint
    from .file_utils import check_exists

    for art in ("loss_steps.json", "final_itm_results.json"):
        remote = f"{remote_run_dir}/{art}"
        if os.path.exists(os.path.join(log_base, art)) or not check_exists(remote):
            continue
        try:
            fetch_remote_checkpoint(remote, log_base)  # a copy of any one file
            logging.info("fetched remote artifact %s", art)
        except OSError as e:  # the records are best-effort
            logging.warning("could not fetch remote %s: %r", art, e)


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


def _copy_codebase(log_base: str) -> None:
    """This package's source under ``<run>/code/<package>``."""
    dst = os.path.join(log_base, "code", os.path.basename(PACKAGE_DIR))
    if os.path.exists(dst):
        logging.info("codebase copy exists at %s; skipping", dst)
        return
    shutil.copytree(PACKAGE_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "assets"))
    logging.info("copied codebase to %s", dst)


def _plot_loss_curves(loss_steps: List[dict], log_base: str) -> None:
    """``loss_curves.png``: each loss against the step; never fails the run."""
    if not loss_steps:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        steps = [r["step"] for r in loss_steps]
        plt.figure()
        for key in ("total_loss", "classic_loss", "soft_loss", "weighted_loss",
                    "contrastive_loss"):
            vals = [r.get(key) for r in loss_steps]
            if any(v is not None for v in vals):
                plt.plot(steps, [float("nan") if v is None else v for v in vals], label=key)
        plt.xlabel("Step")
        plt.ylabel("Loss")
        plt.title("Training loss")
        plt.legend()
        plt.grid(True)
        plt.savefig(os.path.join(log_base, "loss_curves.png"))
        plt.close()
    except Exception as e:
        logging.warning("loss plotting failed: %r", e)


def _final_remote_sync(remote_sync_process, args, log_base: str) -> None:
    """Waits for the checkpoint writes, stops the sync daemon and mirrors
    the run directory one last time."""
    from .checkpoint import wait_for_checkpoints
    from .file_utils import remote_sync

    wait_for_checkpoints()
    if remote_sync_process is None:
        return
    logging.info("Final remote sync.")
    remote_sync_process.terminate()
    remote_sync_process.join(timeout=30)
    if remote_sync(log_base, os.path.join(args.remote_sync, args.name),
                   args.remote_sync_protocol):
        logging.info("Final remote sync successful.")
    else:
        logging.info("Final remote sync failed.")


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


class _NoTracker:
    """The Tracker of a rank that does not log."""

    def log_scalars(self, *args, **kwargs):
        pass

    def log_artifact(self, *args, **kwargs):
        pass

    def finish(self):
        pass


def train_one_epoch(train_step, state, train_data, args, epoch: int, device: torch.device,
                    tracker=None, stop_event=None, skip_steps: int = 0, stop_after: int = 0):
    """One epoch of the loop: fetch ``--accum-freq`` batches, move them to
    the device, step, and log every ``--log-every-n-steps`` (and at the
    epoch's last batch). ``stop_event`` (set by the SIGTERM handler) ends the
    epoch at the next step; ``skip_steps`` resumes a preemption save: the
    loader skips ``skip_steps * accum`` batches; ``stop_after`` > 0 sets
    ``stop_event`` after that many steps of this call. Returns (state,
    records, steps_done)."""
    loader = train_data.dataloader
    loader.set_epoch(epoch)
    accum = max(1, args.accum_freq)
    if skip_steps:
        loader.skip_next_batches(skip_steps * accum)
    records: List[dict] = []
    steps_done = 0
    # a signal may reach one rank only: the ranks stop at the same step
    agree = args.save_on_preemption and dist.is_initialized() and dist.get_world_size() > 1
    group: List[dict] = []
    window_samples, window_t0 = 0, time.time()
    num_batches = getattr(loader, "num_batches", None)
    for i, batch in enumerate(loader):
        stop = stop_event is not None and stop_event.is_set()
        if agree:
            stop = any_rank(stop, device)
            if stop:
                stop_event.set()
        if stop:
            logging.warning("stop requested: leaving epoch %d early", epoch)
            break
        group.append(batch)
        if len(group) < accum:
            continue
        if accum > 1:  # the step takes the microbatches stacked on a leading axis
            batch = {k: np.stack([m[k] for m in group]) for k in group[0]}
        window_samples += sum(len(m["images"]) for m in group)
        group = []
        state, metrics = train_step(state, _to_device(batch, device))
        steps_done += 1
        stop_now = bool(stop_after and steps_done >= stop_after)
        if stop_now:
            logging.warning("--stop-after-steps %d reached at epoch %d", stop_after, epoch)
            if stop_event is not None:
                stop_event.set()
        # a resumed epoch yields its batches after the skipped ones
        is_last = num_batches and i == num_batches - 1 - skip_steps * accum
        if state.step % args.log_every_n_steps == 0 or is_last:
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}  # waits for the step
            now = time.time()
            ips = window_samples / max(now - window_t0, 1e-9)
            window_samples, window_t0 = 0, now
            logging.info("Train Epoch: %d [%d] total_loss: %.5f logit_scale: %.3f %.1f samples/s",
                         epoch, state.step, m["total_loss"], m["logit_scale"], ips)
            records.append({"step": state.step, "epoch": epoch, **m})
            if tracker is not None:
                tracker.log_scalars({**m, "samples_per_s": ips}, step=state.step)
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


def _write_final_artifacts(args, log_base: str, loss_steps: List[dict],
                           all_results: List[dict], best: dict, tracker) -> None:
    """``loss_steps.json``, ``loss_curves.png``, ``final_itm_results.json``,
    the ITM plots and ``itm_scores.csv``, ``best_metrics.json``; each one
    handed to the Tracker."""
    with open(os.path.join(log_base, "loss_steps.json"), "w") as f:
        json.dump(loss_steps, f)
    _plot_loss_curves(loss_steps, log_base)
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
        tracker.log_scalars({"retrieval_score": best["score"], "epoch": best["epoch"]},
                            step=args.epochs, prefix="best")
    for artifact in ("loss_steps.json", "final_itm_results.json", "best_metrics.json",
                     "loss_curves.png", "itm_recall_plot.png", "itm_scores.csv"):
        tracker.log_artifact(os.path.join(log_base, artifact))


def _resolve_resume(args, checkpoint_dir: str, log_base: str):
    """The checkpoint ``--resume`` names, fetched to a local path where it
    is remote; None where there is none."""
    from .checkpoint import fetch_remote_checkpoint, latest_checkpoint, wait_for_checkpoints

    wait_for_checkpoints()  # an earlier run's writes in this process
    if args.resume != "latest":
        if "://" not in args.resume:
            return args.resume
        # a cleared staging directory: a foreign checkpoint must not join this
        # run's own files, which `latest` and the pruning read
        staging = os.path.join(checkpoint_dir, "_remote_staging")
        shutil.rmtree(staging, ignore_errors=True)
        logging.info("=> fetching remote checkpoint %s", args.resume)
        return fetch_remote_checkpoint(args.resume, staging)
    if args.remote_sync is not None:
        if args.save_most_recent:
            raise ValueError("Cannot use save-most-recent with remote_sync and resume latest.")
        remote_run = os.path.join(args.remote_sync, args.name)
        path = latest_checkpoint(remote_run + "/checkpoints")
        if path is None:
            return None
        logging.info("=> fetching remote checkpoint %s", path)
        _fetch_remote_artifacts(remote_run, log_base)
        return fetch_remote_checkpoint(path, checkpoint_dir)
    if args.save_most_recent:
        # --save-most-recent resumes from epoch_latest, not the newest
        # epoch_N (those may be pruned or gated by --save-frequency)
        path = os.path.join(checkpoint_dir, "epoch_latest.pt")
        return path if os.path.isfile(path) else None
    return latest_checkpoint(checkpoint_dir)


def resolve_loss_type(args) -> str:
    """The JAX CLI's loss dispatch (``tpu/train/main.py:103-113``, in its
    order): distillation (both ``--distill-model`` and
    ``--distill-pretrained``), then CoCa (a ``coca`` model name or
    ``--use_coca``), SigLIP, CyCLIP and DINO, so a CoCa run with
    ``--use_dino_general`` takes the CoCa loss."""
    if args.distill_model and args.distill_pretrained:
        return "distill"
    if "coca" in args.model.lower() or args.use_coca:
        return "coca"
    if args.siglip:
        return "siglip"
    if args.use_CyClip:
        return "cyclip"
    if args.use_dino_general:
        return "dino"
    return "clip"


def _main(args):
    from ..eval.clip_blind import run_clip_blind_on_split
    from ..losses import DinoLossCfg, DinoProjectionHead
    from ..models.factory import _precision_to_dtype, create_model, get_tokenizer
    from ..models.resnet import has_batch_norm
    from ..transform import raw_uint8_transform
    from .checkpoint import export_torch_checkpoint, restore_checkpoint, save_checkpoint
    from .data import (DinoFeatureStore, _clone_args, get_csv_dataset, get_data,
                       get_dataset_fn, load_dino_index_map)
    from .dino_teacher import LiveDinoTeacher
    from .evaluate import evaluate
    from .file_utils import remote_sync, start_sync_process
    from .logger import setup_logging
    from .loggers import Tracker
    from ..parallel.mesh import (DATA_AXIS, apply_fsdp, create_mesh, log_mesh, tp_sharding,
                                 wrap_ddp, zero1_sharding)
    from ..parallel.tensor import model_parallel, shard_module
    from .distributed import (barrier, broadcast_object, data_group, init_distributed_device,
                              is_master, model_group)
    from .optim import OptimCfg, build_optimizer
    from .scheduler import const_lr, make_schedule
    from .step import StepCfg, TrainState, Towers, make_train_step, train_parameters, train_splits

    # the process group first: every rank must join before any other work
    device = init_distributed_device(args)
    master = is_master(args)
    if args.name is None:
        name = "-".join([datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
                         f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                         f"b_{args.batch_size}", f"p_{args.precision}"])
        args.name = broadcast_object(args, name)  # one run directory for every rank
    log_base = os.path.join(args.logs, args.name)
    checkpoint_dir = os.path.join(log_base, "checkpoints")
    level = logging.DEBUG if args.debug else logging.INFO
    if master:
        os.makedirs(checkpoint_dir, exist_ok=True)
        setup_logging(os.path.join(log_base, "out.log"), level)
    else:
        setup_logging(None, max(level, logging.WARNING))

    mesh = group = mp = None
    args.data_rank, args.data_world_size = 0, 1
    if args.distributed:
        mesh = create_mesh(model=args.mesh_model_axis, device_type=device.type)
        log_mesh(mesh)
        group, mp = data_group(), model_parallel(model_group())
        args.data_rank, args.data_world_size = (mesh[DATA_AXIS].get_local_rank(),
                                                mesh[DATA_AXIS].size())
    elif args.shard_opt_state or args.fsdp or args.mesh_model_axis > 1:
        raise ValueError("--shard-opt-state, --fsdp and --mesh-model-axis need a process group: "
                         "launch with torchrun (WORLD_SIZE=1 with MASTER_ADDR/MASTER_PORT for "
                         "one GPU)")
    args.global_batch_size = args.batch_size * args.data_world_size
    logging.info("batch: %d/rank x %d ranks = %d global", args.batch_size, args.data_world_size,
                 args.global_batch_size)

    # every rank seeds alike (no rank offset): the train loader shards one
    # shared permutation per epoch
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
                                 force_patch_dropout=args.force_patch_dropout,
                                 grad_checkpointing=(
                                     args.remat_policy
                                     if args.grad_checkpointing and args.remat_policy != "full"
                                     else args.grad_checkpointing))
    model.train()
    loss_type = resolve_loss_type(args)
    coca = hasattr(model, "text_decoder")
    if loss_type == "coca" and not coca:
        raise ValueError(f"--use_coca needs a CoCa model (a coca_* config), not {args.model}")
    shard_module(model, mp)  # this rank's heads and columns under a model axis
    preprocess_train, preprocess_val = build_transforms(args, pp_cfg)
    tokenizer = get_tokenizer(args.model, cache_dir=args.cache_dir)
    # ---- --device-preprocess (``tpu/train/main.py:317-335``): the host
    # ships uint8 at the raw size; the step crops and normalises on the
    # device at the train transform's size, mean and std. Evaluation keeps
    # the host pipeline ----
    device_pp = None
    if args.device_preprocess:
        device_pp = (*preprocess_train.image_size, preprocess_train.mean, preprocess_train.std)
        preprocess_train = raw_uint8_transform(args.device_preprocess_raw_size)
        logging.info("device preprocess: host ships uint8 %dpx, the step crops to %s",
                     args.device_preprocess_raw_size, device_pp[:2])

    # ---- the distillation teacher (``tpu/train/main.py:336-345``): frozen,
    # whole on every rank, in no checkpoint ----
    dist_model = None
    if loss_type == "distill":
        dist_model, _ = create_model(args.distill_model, args.distill_pretrained,
                                     precision=args.precision, device=device,
                                     attn_impl=args.attn_impl, cache_dir=args.cache_dir)
        dist_model.eval().requires_grad_(False)
        logging.info("[distill] teacher %s (%s) runs inside the train step", args.distill_model,
                     args.distill_pretrained)

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
            # split over the model group by the student's rules (Config 5's
            # sharded teacher)
            shard_module(dino_teacher.model, mp)
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
        steps_per_epoch = data["train"].dataloader.num_batches // max(1, args.accum_freq)
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
            head = DinoProjectionHead(model.embed_dim, dino_dim,
                                      args.projection_type, args.use_layernorm).to(device)
            shard_module(head, mp, head=True)
        # the forward's module across the data ranks: FSDP's shards, or DDP
        towers = sharding = None
        if args.fsdp:
            sharding = apply_fsdp(model, head, mesh, train_parameters(model, head),
                                  args.fsdp_min_size)
            towers = Towers(model, head)
        elif args.distributed:
            named, dgroup = train_parameters(model, head), mesh[DATA_AXIS].get_group()
            if args.shard_opt_state:
                sharding = zero1_sharding(named, dgroup, args.fsdp_min_size, mp,
                                          train_splits(model, head))
            elif mp is not None:
                sharding = tp_sharding(named, dgroup, mp, train_splits(model, head))
            towers = wrap_ddp(Towers(model, head), device, dgroup,
                              static_graph=args.ddp_static_graph)
        optim_cfg = OptimCfg(
            opt=args.opt, lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
            wd=args.wd, head_lr=args.head_lr, logit_scale_lr=args.logit_scale_lr,
            text_lr=args.text_lr, resnet_lr4=args.resnet_lr4, resnet_lr3=args.resnet_lr3,
            grad_clip_norm=args.grad_clip_norm, lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text, lock_text_unlocked_layers=args.lock_text_unlocked_layers,
            # the JAX _text_tower_style: CustomTextCLIP's locking and groups
            text_tower_style="custom_text" if model.custom_text else "clip",
            freeze_projection=args.freeze_projection, flatten_group_lrs=args.flatten_group_lrs,
            use_param_groups=args.use_param_groups,
            mu_dtype=None if args.adam_mu_dtype == "float32" else args.adam_mu_dtype,
        )
        optimizer, _ = build_optimizer(train_parameters(model, head), optim_cfg, schedule,
                                       sharding=sharding)
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
        want_patch_dropout = (bool(args.force_patch_dropout)
                              or getattr(model.visual, "patch_dropout", None) is not None)
        if want_patch_dropout and has_batch_norm(model):
            # the JAX step ties BN's mode to ``deterministic``, so a BatchNorm
            # tower never runs PatchDropout (``tpu/train/main.py:545-553``)
            logging.warning(
                "--force-patch-dropout has no effect on BatchNorm towers: PatchDropout is "
                "disabled so BN statistics handling stays correct (see train/step.py)")
            want_patch_dropout = False
        step_cfg = StepCfg(
            loss_type=loss_type,
            coca_caption_loss_weight=args.coca_caption_loss_weight,
            coca_contrastive_loss_weight=args.coca_contrastive_loss_weight,
            lambda_cyc_inmodal=args.lambda_cyc_inmodal,
            lambda_cyc_crossmodal=args.lambda_cyc_crossmodal,
            dino=dino_cfg, siglip_dist_impl=args.loss_dist_impl or "bidir",
            accum_freq=args.accum_freq,
            enable_warmup_dino_hyperparams=args.enable_warmup_dino_hyperparams,
            warmup=args.warmup, log_grad_norm=bool(args.grad_clip_norm) or args.debug,
            # forced from the CLI or set in the model's config, as in the JAX CLI
            use_patch_dropout=want_patch_dropout,
            freeze_bn_stats=bool(args.lock_image and args.lock_image_freeze_bn_stats),
            device_preprocess=device_pp,
        )
        train_step = make_train_step(model, step_cfg, head, dino_teacher, group=group,
                                     towers=towers, dist_model=dist_model)
        state = TrainState(model, head, optimizer, 0, torch.Generator().manual_seed(args.seed))

    tracker = (Tracker(log_base, args, enable_tb="tensorboard" in (args.report_to or ""))
               if master else _NoTracker())

    # ---- resume: at an epoch's start, or inside it after a preemption ----
    start_epoch = resume_step_in_epoch = 0
    if args.resume is not None and state is not None:
        resume_path = broadcast_object(
            args, _resolve_resume(args, checkpoint_dir, log_base) if master else None)
        if resume_path:
            state, start_epoch, resume_step_in_epoch, saved_order = restore_checkpoint(
                resume_path, state)
            current_order = _data_order_flags(args)
            if resume_step_in_epoch and saved_order and saved_order != current_order:
                # the saved position counts steps in the saved batch order:
                # skipping it in another order would drop or repeat batches
                logging.warning(
                    "mid-epoch resume: data-order flags changed since the preemption save "
                    "(%s -> %s); cannot skip %d steps safely — redoing epoch %d from its start",
                    saved_order, current_order, resume_step_in_epoch, start_epoch)
                resume_step_in_epoch = 0
            logging.info("=> resuming checkpoint '%s' (epoch %d%s)", resume_path, start_epoch,
                         f", step {resume_step_in_epoch}" if resume_step_in_epoch else "")
        else:
            logging.info("=> no checkpoint found at %s", args.resume)

    # ---- remote sync: a verification sync, then the daemon ----
    remote_sync_process = None
    if args.remote_sync is not None and master:
        remote_run = os.path.join(args.remote_sync, args.name)
        if not remote_sync(log_base, remote_run, args.remote_sync_protocol):
            raise RuntimeError("Error: remote sync failed. Exiting.")
        logging.info("remote sync successful.")
        remote_sync_process = start_sync_process(args.remote_sync_frequency, log_base,
                                                 remote_run, args.remote_sync_protocol)
        remote_sync_process.start()

    if master:
        with open(os.path.join(log_base, "params.txt"), "w") as f:
            for name in sorted(vars(args)):
                f.write(f"{name}: {getattr(args, name)}\n")
        if args.copy_codebase:
            _copy_codebase(log_base)

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
        results = evaluate_all(start_epoch)
        tracker.finish()
        _final_remote_sync(remote_sync_process, args, log_base)
        barrier()
        return results

    # ---- pre-train evaluation: the epoch-0 entry, never "best"; a resume
    # inside epoch 0 has it from the earlier run ----
    pretrain_results = []
    if start_epoch == 0 and resume_step_in_epoch == 0:
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

    # ---- preemption: SIGTERM ends the epoch at the next step boundary ----
    preempt = threading.Event()
    prev_sigterm = None
    if args.save_on_preemption:
        def _on_sigterm(signum, frame):
            logging.warning("SIGTERM: checkpointing and exiting at the next step boundary")
            preempt.set()

        if threading.current_thread() is threading.main_thread():
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        else:  # signal handlers are the main thread's only
            logging.warning("--save-on-preemption: not on the main thread; SIGTERM handler "
                            "not installed")
    try:
        steps_budget = max(0, int(args.stop_after_steps or 0))
        for epoch in range(start_epoch, args.epochs):
            skip_steps = resume_step_in_epoch if epoch == start_epoch else 0
            logging.info("Start epoch %d%s", epoch,
                         f" (resuming at optimizer step {skip_steps})" if skip_steps else "")
            state, records, steps_done = train_one_epoch(
                train_step, state, data["train"], args, epoch, device, tracker=tracker,
                stop_event=preempt, skip_steps=skip_steps, stop_after=steps_budget)
            if steps_budget:
                steps_budget = max(0, steps_budget - steps_done)
            loss_steps.extend(records)
            if preempt.is_set():
                # its own file: overwriting epoch_N would put the newest
                # completed checkpoint at risk until the new one is written
                step_in_epoch = skip_steps + steps_done
                logging.warning("preemption: saving epoch_%d_preempt (at optimizer step %d of "
                                "the epoch; resume continues there) and shutting down", epoch,
                                step_in_epoch)
                save_checkpoint(checkpoint_dir, state, epoch, name=args.name,
                                save_most_recent=args.save_most_recent,
                                data_order=_data_order_flags(args),
                                async_save=args.async_checkpoint, name_suffix="_preempt",
                                step_in_epoch=step_in_epoch)
                break
            completed_epoch = epoch + 1

            epoch_results = evaluate_all(completed_epoch)
            for r in epoch_results:
                tracker.log_scalars({k: v for k, v in r["metrics"].items()
                                     if isinstance(v, (int, float))},
                                    step=completed_epoch, prefix=f"val/{r['val_name']}")
            all_results.append({"epoch": completed_epoch, "results": epoch_results})
            best = _update_best(best, completed_epoch, epoch_results)

            if args.save_frequency > 0 and (completed_epoch % args.save_frequency == 0
                                            or completed_epoch == args.epochs):
                save_checkpoint(checkpoint_dir, state, completed_epoch, name=args.name,
                                save_most_recent=args.save_most_recent,
                                delete_previous=args.delete_previous_checkpoint,
                                data_order=_data_order_flags(args),
                                async_save=args.async_checkpoint)
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)

    # ---- final artifacts (rank 0 writes) ----
    if master:
        _write_final_artifacts(args, log_base, loss_steps, all_results, best, tracker)
    tracker.finish()
    export_torch_checkpoint(state, args.epochs, args.name,
                            os.path.join(checkpoint_dir, "final_torch_state.pt"))

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
    _final_remote_sync(remote_sync_process, args, log_base)
    barrier()
    return loss_steps


if __name__ == "__main__":
    main()
