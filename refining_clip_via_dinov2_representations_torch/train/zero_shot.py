"""ImageNet zero-shot evaluation.

The port of the JAX package's ``train/zero_shot.py`` for one device: the
80-template prompt-ensemble classifier over the 1000 ImageNet classes is
built once per evaluation (``eval/zero_shot_classifier.py``), then every
image batch of ``--imagenet-val`` / ``--imagenet-v2`` is scored as
``100 * encode_image(normalize=True) @ classifier`` under ``no_grad`` on the
model's device, and top-1/top-5 are counted on the host. It runs at epoch
0, at every ``--zeroshot-frequency``-th epoch and at the last one; a
frequency of 0 turns it off.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..eval._imagenet_metadata import IMAGENET_CLASSNAMES, OPENAI_IMAGENET_TEMPLATES
from ..eval.zero_shot_classifier import build_zero_shot_classifier


def accuracy(logits: np.ndarray, target: np.ndarray, topk=(1,)):
    """Top-k correct counts."""
    order = np.argsort(-logits, axis=1)
    return [float((order[:, :k] == target[:, None]).any(axis=1).sum()) for k in topk]


def run(model: torch.nn.Module, classifier: torch.Tensor, dataloader):
    """(top-1, top-5) fractions of ``dataloader``'s ``images``/``labels``
    batches under ``classifier``; NaN for an empty loader."""
    device = next(model.parameters()).device
    top1 = top5 = n = 0.0
    for batch in dataloader:
        images = torch.from_numpy(np.asarray(batch["images"], np.float32)).to(device)
        target = np.asarray(batch["labels"])
        with torch.no_grad():
            feats = model.encode_image(images, normalize=True)
            logits = (100.0 * feats @ classifier).float().cpu().numpy()
        acc1, acc5 = accuracy(logits, target, topk=(1, 5))
        top1 += acc1
        top5 += acc5
        n += images.shape[0]
    if n == 0:  # an empty ImageNet folder: skipped, the run goes on
        logging.warning("zero-shot loader yielded no samples; skipping")
        return float("nan"), float("nan")
    return top1 / n, top5 / n


def zero_shot_eval(model: torch.nn.Module, data: Dict, epoch: int, args,
                   tokenizer=None) -> Dict[str, float]:
    """``imagenet-zeroshot-val-top{1,5}`` and ``imagenetv2-zeroshot-val-top{1,5}``
    of the ImageNet keys in ``data``; empty when there is none or the
    frequency skips this epoch."""
    if "imagenet-val" not in data and "imagenet-v2" not in data:
        return {}
    if args.zeroshot_frequency == 0:
        return {}
    if (epoch % args.zeroshot_frequency) != 0 and epoch != args.epochs:
        return {}
    logging.info("Starting zero-shot imagenet.")
    if tokenizer is None:
        from ..models import get_tokenizer

        tokenizer = get_tokenizer(args.model)
    logging.info("Building zero-shot classifier")
    classifier = build_zero_shot_classifier(model, tokenizer=tokenizer,
                                            classnames=IMAGENET_CLASSNAMES,
                                            templates=OPENAI_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=10)
    results = {}
    for key, name in (("imagenet-val", "imagenet-zeroshot-val"),
                      ("imagenet-v2", "imagenetv2-zeroshot-val")):
        if key in data:
            top1, top5 = run(model, classifier, data[key].dataloader)
            results[f"{name}-top1"] = top1
            results[f"{name}-top5"] = top5
    logging.info("Finished zero-shot imagenet.")
    return results
