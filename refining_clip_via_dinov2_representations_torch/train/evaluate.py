"""Validation: the val loss and Flickr-style retrieval.

The port of the JAX package's ``train/evaluate.py`` for one device: every
val batch runs through the model under ``torch.no_grad()`` on the model's
device (on a card, every attention call through the fused forward kernel:
12 launches a tower), the features move to the host as fp32, caption rows
map to image ids by the first occurrence of their ``image_path``, image
features are deduplicated by first occurrence, and the retrieval metrics
of ``train/metrics.py`` follow. Without image paths (synthetic data) the
in-batch ranks of ``get_clip_metrics`` stand in. The first evaluation
round of an epoch also runs the zero-shot ImageNet evaluation
(``train/zero_shot.py``; frequency-gated there), as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..losses import clip_loss
from .metrics import build_unique_image_features, clip_retrieval_metrics, get_clip_metrics


def evaluate(model: torch.nn.Module, data: Dict, epoch: int, args, tokenizer=None,
             val_key: str = "val", include_zero_shot: bool = True) -> Dict[str, float]:
    """The metrics of ``data[val_key]`` at ``epoch``, after the zero-shot
    ImageNet metrics where ``include_zero_shot`` (the caller passes it for
    the first val key only, so the classifier is built once an epoch).
    The retrieval part is skipped when the key is absent or
    ``--val-frequency`` skips this epoch (it runs when ``epoch %
    val_frequency == 0`` or at the last epoch; 0 turns it off)."""
    metrics: Dict[str, float] = {}
    if include_zero_shot:
        from .zero_shot import zero_shot_eval

        metrics.update(zero_shot_eval(model, data, epoch, args, tokenizer))
    if val_key not in data or not args.val_frequency:
        return metrics
    if not ((epoch % args.val_frequency) == 0 or epoch == args.epochs):
        return metrics

    loader = data[val_key].dataloader
    device = next(model.parameters()).device
    all_img, all_txt, all_ids = [], [], []
    path2id: Dict[str, int] = {}
    cumulative_loss = 0.0
    num_samples = 0
    logit_scale = 1.0
    for i, batch in enumerate(loader):
        images = torch.from_numpy(np.asarray(batch["images"], np.float32)).to(device)
        texts = torch.from_numpy(np.asarray(batch["texts"])).long().to(device)
        b = images.shape[0]
        with torch.no_grad():
            out = model(images, texts)
            img_f, txt_f, scale = out["image_features"], out["text_features"], out["logit_scale"]
            batch_loss = float(clip_loss(img_f, txt_f, scale))
        logit_scale = float(scale)
        all_img.append(img_f.float().cpu().numpy())
        all_txt.append(txt_f.float().cpu().numpy())
        if "image_path" in batch:
            for p in batch["image_path"]:
                if p not in path2id:
                    path2id[p] = len(path2id)
                all_ids.append(path2id[p])
        cumulative_loss += batch_loss * b
        num_samples += b
        if i % 100 == 0:
            logging.info("Eval Epoch: %d [%d / %d]\tClip Loss: %.6f", epoch, num_samples,
                         getattr(loader, "num_samples", -1),
                         cumulative_loss / max(1, num_samples))

    if not all_img:
        logging.warning("evaluate: val loader %r yielded no batches", val_key)
        return metrics

    img_feats_per_cap = np.concatenate(all_img, axis=0)
    txt_feats = np.concatenate(all_txt, axis=0)
    if all_ids:
        cap2img = np.asarray(all_ids, np.int64)
        img_feats = build_unique_image_features(img_feats_per_cap, cap2img)
        metrics.update(clip_retrieval_metrics(img_feats, txt_feats, cap2img))
    else:
        metrics.update(get_clip_metrics(img_feats_per_cap, txt_feats, logit_scale))
    metrics.update({"clip_val_loss": cumulative_loss / max(1, num_samples), "epoch": epoch,
                    "num_samples": num_samples})
    logging.info("Eval Epoch: %d %s", epoch,
                 "\t".join(f"{k}: {round(v, 4):.4f}" for k, v in metrics.items()))
    return metrics
