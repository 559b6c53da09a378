"""Evaluation metrics: retrieval, in-batch ranks, modality gap.

The port's own copy of the JAX package's ``train/metrics.py``, on numpy as
there; these formulas produce the thesis' headline numbers:

* text→image: each caption has one ground-truth image; R@K on the 0-based
  rank of that image.
* image→text: each image has (typically 5) ground-truth captions; credit is
  the best rank among them.
* mean/median rank are 1-based; in-batch variant floors the median
  (`train.py:849-866`).
* modality gap = L2 distance between modality mean embeddings
  (`train.py:824-827`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def clip_retrieval_metrics(
    img_feats: np.ndarray, txt_feats: np.ndarray, cap2img: Sequence[int]
) -> Dict[str, float]:
    """Flickr30k-style retrieval (`train.py:762-847`)."""
    img_feats = _l2n(np.asarray(img_feats, np.float32))
    txt_feats = _l2n(np.asarray(txt_feats, np.float32))
    cap2img = np.asarray(cap2img, np.int64)
    n_img = img_feats.shape[0]
    n_caps = txt_feats.shape[0]

    s_txt2img = txt_feats @ img_feats.T  # [N_caps, N_img]

    # ----- text -> image -----
    order_ti = np.argsort(-s_txt2img, axis=1)
    pos_rank_ti = np.argmax(order_ti == cap2img[:, None], axis=1).astype(np.float64)

    def recall_at(ranks, k):
        return float((ranks < k).mean() * 100.0)

    pos_sims = s_txt2img[np.arange(n_caps), cap2img]

    # ----- image -> text (best of the image's captions) -----
    s_img2txt = img_feats @ txt_feats.T
    order_it = np.argsort(-s_img2txt, axis=1)
    # rank position of each caption for each image
    rank_of_cap = np.empty_like(order_it)
    rows = np.arange(n_img)[:, None]
    rank_of_cap[rows, order_it] = np.arange(n_caps)[None, :]
    best_ranks_it = np.full(n_img, n_caps, np.float64)
    for c_idx, i_idx in enumerate(cap2img):
        r = rank_of_cap[i_idx, c_idx]
        if r < best_ranks_it[i_idx]:
            best_ranks_it[i_idx] = r

    mu_img = img_feats.mean(axis=0)
    mu_txt = txt_feats.mean(axis=0)

    return {
        "text_to_image_R@1": recall_at(pos_rank_ti, 1),
        "text_to_image_R@5": recall_at(pos_rank_ti, 5),
        "text_to_image_R@10": recall_at(pos_rank_ti, 10),
        "text_to_image_mean_rank": float(pos_rank_ti.mean() + 1.0),
        "text_to_image_median_rank": float(np.median(pos_rank_ti) + 1.0),
        "image_to_text_R@1": recall_at(best_ranks_it, 1),
        "image_to_text_R@5": recall_at(best_ranks_it, 5),
        "image_to_text_R@10": recall_at(best_ranks_it, 10),
        "image_to_text_mean_rank": float(best_ranks_it.mean() + 1.0),
        "image_to_text_median_rank": float(np.median(best_ranks_it) + 1.0),
        "average_similarity": float(pos_sims.mean()),
        "modality_gap": float(np.linalg.norm(mu_img - mu_txt)),
    }


def get_clip_metrics(
    image_features: np.ndarray, text_features: np.ndarray, logit_scale: float
) -> Dict[str, float]:
    """In-batch paired ranks (`train.py:849-866`)."""
    metrics: Dict[str, float] = {}
    logits_per_image = float(logit_scale) * np.asarray(image_features) @ np.asarray(
        text_features
    ).T
    logits = {
        "image_to_text": logits_per_image,
        "text_to_image": logits_per_image.T,
    }
    n = logits_per_image.shape[0]
    gt = np.arange(n)[:, None]
    for name, logit in logits.items():
        ranking = np.argsort(-logit, axis=1)
        preds = np.argmax(ranking == gt, axis=1)
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return metrics


def build_unique_image_features(
    img_feats_per_cap: np.ndarray, cap2img: Sequence[int]
) -> np.ndarray:
    """First-occurrence dedup of per-caption image features
    (`train.py:706-714`). QUIRK KEPT: 'first occurrence wins' — identical to
    the reference even if later rows differ numerically."""
    cap2img = np.asarray(cap2img, np.int64)
    n_img = int(cap2img.max()) + 1
    d = img_feats_per_cap.shape[1]
    out = np.zeros((n_img, d), img_feats_per_cap.dtype)
    seen = np.zeros(n_img, bool)
    for row, idx in enumerate(cap2img):
        if not seen[idx]:
            out[idx] = img_feats_per_cap[row]
            seen[idx] = True
    return out
