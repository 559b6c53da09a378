"""Experiment tracking: TensorBoard, MLflow and wandb.

The port of the JAX package's ``train/loggers.py``, with its key names:
``train/<k>`` every ``--log-every-n-steps``, ``val/<key>/<k>`` per evaluated
epoch (step = the epoch), ``best/retrieval_score`` and ``best/epoch`` at the
end, and the run's artifacts.

* TensorBoard (``--report-to tensorboard``) writes through
  ``torch.utils.tensorboard.SummaryWriter`` into ``<run>/tensorboard``;
* MLflow is gated by ``MLFLOW_ENABLE`` (``MLFLOW_TRACKING_URI``,
  ``MLFLOW_EXPERIMENT``) and receives the flags, the metrics under
  MLflow-safe names, and the artifacts;
* wandb is gated by ``--report-to wandb`` and runs on rank 0 only.

A backend whose package does not import, or whose start fails, is a no-op
after one warning: tracking never takes a run down.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

from .helpers import sanitize_metric_name


def _flag_strings(args) -> Dict[str, str]:
    return {k: str(v)[:500] for k, v in sorted(vars(args).items())}


class Tracker:
    """One facade over the three backends."""

    def __init__(self, log_dir: str, args=None, enable_tb: bool = True):
        self._tb = self._mlflow = self._wandb = None
        report_to = (getattr(args, "report_to", "") or "") if args is not None else ""
        if "wandb" in report_to and int(getattr(args, "rank", 0) or 0) == 0:
            try:
                import wandb

                wandb.init(project=getattr(args, "wandb_project_name", "open-clip"),
                           name=getattr(args, "name", None),
                           notes=getattr(args, "wandb_notes", "") or None,
                           config=_flag_strings(args), dir=log_dir)
                self._wandb = wandb
            except Exception:  # not importable, not logged in, no network
                logging.warning("--report-to wandb set but wandb.init failed; continuing "
                                "without wandb", exc_info=True)
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logging.warning("tensorboard logging unavailable (no tensorboard package)")
            else:
                self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tensorboard"))
        if os.environ.get("MLFLOW_ENABLE"):
            try:
                import mlflow
            except ImportError:
                logging.warning("MLFLOW_ENABLE set but mlflow not importable")
            else:
                uri = os.environ.get("MLFLOW_TRACKING_URI")
                if uri:
                    mlflow.set_tracking_uri(uri)
                mlflow.set_experiment(os.environ.get("MLFLOW_EXPERIMENT", "open_clip_tpu"))
                mlflow.start_run(run_name=getattr(args, "name", None))
                self._mlflow = mlflow
                if args is not None:
                    items = list(_flag_strings(args).items())
                    for i in range(0, len(items), 90):  # MLflow caps a batch of params
                        mlflow.log_params(dict(items[i:i + 90]))

    def log_scalars(self, metrics: Dict[str, float], step: int, prefix: str = "train"):
        named = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in named.items():
                self._tb.add_scalar(k, v, global_step=step)
        if self._mlflow is not None:
            self._mlflow.log_metrics({sanitize_metric_name(k): v for k, v in named.items()},
                                     step=step)
        if self._wandb is not None:
            # the step rides as a field, never as wandb's step: the train rows
            # count optimizer steps and the val rows epochs, and wandb drops
            # every row whose step decreases
            self._wandb.log(dict(named, step=step))

    def log_artifact(self, path: str):
        if self._mlflow is not None and os.path.exists(path):
            self._mlflow.log_artifact(path)

    def finish(self):
        if self._tb is not None:
            self._tb.close()
        if self._mlflow is not None:
            self._mlflow.end_run()
        if self._wandb is not None:
            self._wandb.finish()
