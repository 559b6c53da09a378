"""Training CLI flags.

The port of the JAX package's ``train/params.py``: the same flag names and
defaults, and ``get_default_params`` for the model family. A flag that this
slice of the port cannot honour raises ``NotImplementedError`` at parse time
when it is set away from its default (``UNPORTED``), rather than being
ignored. Flags that change nothing in one process (``--local-loss``,
``--gather-with-grad``), the sweep-surface knobs the reference parses but no
loss reads, and reporting knobs without a reporter are accepted, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import ast

# flag dest -> what the port is missing for it
UNPORTED = {
    "train_data": "CSV/webdataset datasets (ROADMAP Queue 1 item 6)",
    "val_data": "evaluation (ROADMAP Queue 1 item 7)",
    "flickr_val_data": "evaluation (ROADMAP Queue 1 item 7)",
    "mscoco_val_data": "evaluation (ROADMAP Queue 1 item 7)",
    "flickr30k_val": "evaluation (ROADMAP Queue 1 item 7)",
    "mscoco_val": "evaluation (ROADMAP Queue 1 item 7)",
    "val_num_samples": "evaluation (ROADMAP Queue 1 item 7)",
    "imagenet_val": "zero-shot evaluation (ROADMAP Queue 1 item 7)",
    "imagenet_v2": "zero-shot evaluation (ROADMAP Queue 1 item 7)",
    "imagenet_train": "zero-shot evaluation (ROADMAP Queue 1 item 7)",
    "dataset_resampled": "webdataset resampling (ROADMAP Queue 1 item 6)",
    "train_data_upsampling_factors": "webdataset (ROADMAP Queue 1 item 6)",
    "cache_dir": "downloads",
    "aug_cfg": "training augmentation (ROADMAP Queue 1 item 6)",
    "image_mean": "preprocessing overrides (ROADMAP Queue 1 item 6)",
    "image_std": "preprocessing overrides (ROADMAP Queue 1 item 6)",
    "image_interpolation": "preprocessing overrides (ROADMAP Queue 1 item 6)",
    "image_resize_mode": "preprocessing overrides (ROADMAP Queue 1 item 6)",
    "accum_freq": "gradient accumulation (ROADMAP Queue 1 item 5)",
    "opt": "optimizers other than AdamW",
    "momentum": "optimizers other than AdamW",
    "force_quick_gelu": "model overrides",
    "force_custom_text": "model overrides",
    "force_patch_dropout": "patch dropout (ROADMAP Queue 1 item 3)",
    "adam_mu_dtype": "a bf16 first moment",
    "remat_policy": "selective activation-checkpointing policies (jax.checkpoint_policies; "
                    "ROADMAP Queue 1 item 3)",
    "lock_image_freeze_bn_stats": "BatchNorm towers",
    "lock_text_freeze_layer_norm": "frozen LayerNorms",
    "torchscript": "TorchScript",
    "torchcompile": "torch.compile",
    "trace": "tracing",
    "use_bn_sync": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "siglip": "the SigLIP loss (ROADMAP Queue 1 item 12)",
    "loss_dist_impl": "the SigLIP loss (ROADMAP Queue 1 item 12)",
    "dino_model_name": "the live DINOv2 teacher (ROADMAP Queue 1 item 9)",
    "dino_index_map_path": "the CSV join of DINO features (ROADMAP Queue 1 item 6)",
    "dino_fts_path_val": "evaluation (ROADMAP Queue 1 item 7)",
    "dino_index_map_path_val": "evaluation (ROADMAP Queue 1 item 7)",
    "use_CyClip": "the CyCLIP loss (ROADMAP Queue 1 item 12)",
    "use_coca": "CoCa (ROADMAP Queue 1 item 14)",
    "distill_model": "the distillation loss (ROADMAP Queue 1 item 12)",
    "distill_pretrained": "the distillation loss (ROADMAP Queue 1 item 12)",
    "save_most_recent": "checkpoint rotation (ROADMAP Queue 1 item 8)",
    "delete_previous_checkpoint": "checkpoint rotation (ROADMAP Queue 1 item 8)",
    "compile_cache": "a JAX compilation cache",
    "save_on_preemption": "preemption checkpoints (ROADMAP Queue 1 item 8)",
    "async_checkpoint": "asynchronous checkpoints (ROADMAP Queue 1 item 8)",
    "resume": "resuming (ROADMAP Queue 1 item 8)",
    "report_to": "tensorboard/wandb/MLflow reporting (ROADMAP Queue 1 item 8)",
    "log_checkpoint": "MLflow artifacts (ROADMAP Queue 1 item 8)",
    "copy_codebase": "codebase snapshots (ROADMAP Queue 1 item 8)",
    "profile": "the step profiler",
    "run_clip_blind": "the CLIP-blind check (ROADMAP Queue 1 item 7)",
    "clip_blind_dino_feats": "the CLIP-blind check (ROADMAP Queue 1 item 7)",
    "clip_blind_dino_index_map": "the CLIP-blind check (ROADMAP Queue 1 item 7)",
    "pretrained_image": "pretrained towers",
    "use_bnb_linear": "bitsandbytes layers",
    "remote_sync": "remote sync (ROADMAP Queue 1 item 8)",
    "device_preprocess": "device preprocessing (ROADMAP Queue 1 item 11)",
    "mesh_model_axis": "model parallelism (ROADMAP Queue 1 item 10)",
    "shard_opt_state": "sharded optimizer state (ROADMAP Queue 1 item 10)",
    "fsdp": "FSDP (ROADMAP Queue 1 item 10)",
    "dist_url": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "dist_backend": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "horovod": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "ddp_static_graph": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "no_set_device_rank": "multi-GPU training (ROADMAP Queue 1 item 10)",
}


def get_default_params(model_name: str):
    """Model-family default hparams."""
    if "vit" in model_name.lower():
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    """``--aug-cfg k=v`` parsing."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, _, v = value.partition("=")
            try:
                kw[key] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kw[key] = v
        setattr(namespace, self.dest, kw)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PyTorch/CUDA open_clip training (the port)")
    a = p.add_argument
    flag = lambda name, **kw: a(name, default=False, action="store_true", **kw)  # noqa: E731

    # ---- data ----
    a("--train-data", type=str, default=None)
    a("--val-data", type=str, default=None)
    a("--flickr-val-data", dest="flickr_val_data", type=str, default=None)
    a("--mscoco-val-data", dest="mscoco_val_data", type=str, default=None)
    a("--train-num-samples", type=int, default=None)
    a("--val-num-samples", type=int, default=None)
    a("--dataset-type", choices=["webdataset", "csv", "synthetic", "auto"], default="auto")
    flag("--dataset-resampled")
    a("--csv-separator", type=str, default=",")
    a("--csv-img-key", type=str, default="filepath")
    a("--csv-caption-key", type=str, default="title")
    a("--imagenet-val", type=str, default=None)
    a("--imagenet-v2", type=str, default=None)
    a("--imagenet-train", type=str, default=None)
    a("--cache-dir", type=str, default=None)
    a("--workers", type=int, default=8)
    a("--batch-size", type=int, default=64)
    a("--aug-cfg", nargs="*", default={}, action=ParseKwargs)
    a("--flickr30k_val", type=str, default=None)
    a("--mscoco_val", type=str, default=None)
    a("--train-data-upsampling-factors", type=str, default=None)
    a("--image-mean", type=float, nargs="+", default=None)
    a("--image-std", type=float, nargs="+", default=None)
    a("--image-interpolation", type=str, default=None, choices=["bicubic", "bilinear", "random"])
    a("--image-resize-mode", type=str, default=None, choices=["shortest", "longest", "squash"])

    # ---- schedule / optim ----
    a("--epochs", type=int, default=32)
    a("--epochs-cooldown", type=int, default=None)
    a("--lr", type=float, default=None)
    a("--beta1", type=float, default=None)
    a("--beta2", type=float, default=None)
    a("--eps", type=float, default=None)
    a("--wd", type=float, default=0.2)
    a("--momentum", type=float, default=None)
    a("--warmup", type=int, default=10000)
    a("--lr-scheduler", type=str, default="cosine", choices=["cosine", "const", "const-cooldown"])
    a("--lr-min", type=float, default=0.0)
    a("--lr-cooldown-end", type=float, default=0.0)
    a("--lr-cooldown-power", type=float, default=1.0)
    a("--grad-clip-norm", type=float, default=None)
    a("--accum-freq", type=int, default=1)
    a("--opt", type=str, default="adamw")
    a("--head-lr", dest="head_lr", type=float, default=1e-4)
    a("--logit-scale-lr", dest="logit_scale_lr", type=float, default=1e-6)
    a("--text-lr", dest="text_lr", type=float, default=5e-5)
    a("--resnet-lr4", dest="resnet_lr4", type=float, default=2e-5)
    a("--resnet-lr3", dest="resnet_lr3", type=float, default=1e-5)
    a("--use-param-groups", dest="use_param_groups", default=True, action="store_true")
    a("--no-param-groups", dest="use_param_groups", action="store_false")
    flag("--flatten-group-lrs")

    # ---- model ----
    a("--model", type=str, default="RN50")
    a("--pretrained", type=str, default="")
    a("--precision", choices=["amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16", "pure_bf16",
                              "pure_fp16", "fp32"], default="amp")
    flag("--force-quick-gelu")
    flag("--force-custom-text")
    a("--force-patch-dropout", type=float, default=None)
    a("--force-image-size", type=int, nargs="+", default=None)
    flag("--grad-checkpointing")
    a("--adam-mu-dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    a("--remat-policy", type=str, default="full",
      choices=["full", "dots_saveable", "dots_with_no_batch_dims_saveable",
               "offload_dots_with_no_batch_dims"])
    flag("--lock-image")
    a("--lock-image-unlocked-groups", type=int, default=0)
    flag("--lock-image-freeze-bn-stats")
    flag("--lock-text")
    a("--lock-text-unlocked-layers", type=int, default=0)
    flag("--lock-text-freeze-layer-norm")
    flag("--torchscript")
    flag("--torchcompile")
    flag("--trace")
    flag("--use-bn-sync")
    flag("--siglip")
    a("--loss-dist-impl", type=str, default=None)

    # ---- DINO thesis knobs ----
    flag("--use_dino_general")
    a("--lambda_original", type=float, default=1.0)
    a("--lambda_soft", type=float, default=0.0)
    a("--soft_mode", type=str, default="none", choices=["none", "siglip_dino", "kl_teacher"])
    a("--teacher_temp", type=float, default=0.15)
    a("--student_temp", type=float, default=None)
    flag("--soft_dino_to_text")
    a("--text_lambda", type=float, default=0.2)
    a("--text_student_temp", type=float, default=0.05)
    a("--lambda_weighted", type=float, default=0.0)
    a("--rho", type=float, default=0.1)
    a("--c_clip", type=float, default=1.0)
    flag("--weight_text_symmetry")
    a("--use_projection", default=True, action="store_true")
    a("--no_projection", dest="use_projection", action="store_false")
    a("--projection_type", type=str, default="mlp", choices=["linear", "mlp"])
    flag("--use_layernorm")
    flag("--residual_projection")
    a("--residual_alpha", type=float, default=None)
    flag("--freeze_projection")
    flag("--enable_warmup_dino_hyperparams")
    a("--dino_fts_path", type=str, default=None)
    a("--dino_index_map_path", type=str, default=None)
    a("--dino_model_name", type=str, default=None)
    a("--synthetic-dino-dim", dest="synthetic_dino_dim", type=int, default=None)
    a("--dbg_print_every", type=int, default=0)
    a("--dino_fts_path_val", type=str, default=None)
    a("--dino_index_map_path_val", type=str, default=None)

    # ---- sweep-surface knobs the reference parses and no loss reads ----
    for name, default in (("--alpha", 1.0), ("--beta_weight", 0.0), ("--lambda_dino", 0.0),
                          ("--lambda_geom", 0.0), ("--lambda_graph_near", 0.0),
                          ("--lambda_graph_far", 0.0), ("--lambda_hard_neg", 0.0),
                          ("--lambda_self_align", 0.0), ("--lambda_sim_align", 0.0),
                          ("--lambda_weighted_contrastive_loss", 0.0),
                          ("--graph_near_pct", 0.8), ("--graph_far_pct", 0.2),
                          ("--soft_near_pct", 0.8), ("--soft_far_pct", 0.2),
                          ("--soft_w_mid", 0.2), ("--soft_temprature", 0.02),
                          ("--dino_far_pct", 0.2), ("--far_target_percentile", 0.75),
                          ("--hard_cap_gap", 1.0), ("--topp_teacher", 0.0),
                          ("--txt_cov_weight", 0.0), ("--txt_var_weight", 0.0),
                          ("--txt_top_pct", 0.8)):
        a(name, type=float, default=default)
    a("--loss_mode", type=str, default="clip")
    a("--topk_teacher", type=int, default=0)
    for name in ("--normalize_rows", "--normalize_cols", "--enforce_to_text",
                 "--use_dino_similarities", "--use_dino_soft_targets", "--use_dino_weight",
                 "--use_dino_self_align", "--use_dino_sim_align", "--use_soft_labels",
                 "--use_symmetric_dino_weights"):
        flag(name)
    a("--use-symmetric-dino-weights", dest="use_symmetric_dino_weights", action="store_true",
      help=argparse.SUPPRESS)
    a("--vit-lr-decay", dest="vit_lr_decay", type=float, default=0.9)

    # ---- CyCLIP / CoCa / distill ----
    flag("--use_CyClip")
    a("--lambda_cyc_inmodal", type=float, default=0.25)
    a("--lambda_cyc_crossmodal", type=float, default=0.25)
    flag("--use_coca")
    a("--coca-caption-loss-weight", type=float, default=2.0)
    a("--coca-contrastive-loss-weight", type=float, default=1.0)
    a("--distill-model", type=str, default=None)
    a("--distill-pretrained", type=str, default=None)

    # ---- contrastive dist options (no effect in one process) ----
    flag("--local-loss")
    flag("--gather-with-grad")

    # ---- eval / logging / ckpt ----
    a("--val-frequency", type=int, default=1)
    a("--zeroshot-frequency", type=int, default=2)
    a("--save-frequency", type=int, default=1)
    flag("--save-most-recent")
    flag("--delete-previous-checkpoint")
    a("--compile-cache", type=str, default=None)
    flag("--save-on-preemption")
    a("--stop-after-steps", type=int, default=0,
      help="stop the run after N optimizer steps (0 = run to completion)")
    flag("--async-checkpoint")
    a("--resume", type=str, default=None)
    a("--logs", type=str, default="./logs/")
    flag("--log-local")
    a("--name", type=str, default=None)
    a("--log-every-n-steps", type=int, default=100)
    a("--report-to", type=str, default="")
    a("--wandb-notes", type=str, default="")
    a("--wandb-project-name", type=str, default="open-clip")
    flag("--copy-codebase")
    flag("--profile")
    a("--profile-steps", type=int, default=5)
    flag("--debug")
    flag("--run_clip_blind")
    a("--clip_blind_max_images", type=int, default=2000)
    a("--clip_blind_dino_feats", type=str, default=None)
    a("--clip_blind_dino_index_map", type=str, default=None)
    a("--clip_blind_val_key", type=str, default="flickr30k-val")
    a("--clip_blind_train_key", type=str, default="train")
    a("--log-checkpoint", dest="log_checkpoint", default=False, action="store_true")
    a("--use_mlflow", default=None, action="store_true")
    a("--skip-scheduler", dest="skip_scheduler", default=False, action="store_true")
    a("--pretrained-image", dest="pretrained_image", default=False, action="store_true")
    a("--use-bnb-linear", dest="use_bnb_linear", type=str, default=None)
    a("--remote-sync", type=str, default=None)
    a("--remote-sync-frequency", type=int, default=300)
    a("--remote-sync-protocol", choices=["s3", "fsspec"], default="s3")

    # ---- runtime ----
    a("--seed", type=int, default=0)
    a("--device", type=str, default=None,
      help="torch device to train on (default: cuda, or cpu under --force-cpu)")
    flag("--device-preprocess")
    a("--device-preprocess-raw-size", type=int, default=256)
    flag("--force-cpu", help="train on the CPU with the plain attention versions (tests)")
    a("--mesh-model-axis", type=int, default=1)
    flag("--shard-opt-state")
    flag("--fsdp")
    a("--fsdp-min-size", type=int, default=2**16)
    a("--attn-impl", type=str, default="auto", choices=["auto", "xla", "flash"])
    a("--dist-url", type=str, default=None)
    a("--dist-backend", type=str, default=None)
    flag("--horovod")
    flag("--ddp-static-graph")
    flag("--no-set-device-rank")
    return p


def parse_args(args=None):
    parser = _parser()
    ns = parser.parse_args(args)
    for dest, missing in UNPORTED.items():
        if getattr(ns, dest) != parser.get_default(dest):
            raise NotImplementedError(
                f"{dest}={getattr(ns, dest)!r}: the PyTorch port has no {missing} yet")
    for name, val in get_default_params(ns.model).items():
        if getattr(ns, name) is None:
            setattr(ns, name, val)
    return ns
