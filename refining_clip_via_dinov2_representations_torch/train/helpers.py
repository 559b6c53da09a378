"""Harness helpers: recall extraction, retrieval scores, metric names.

The port's own copy of the JAX package's ``train/helpers.py`` selection
machinery: the best-epoch criterion of the thesis is the mean of the six R@K
recalls over the eval datasets, tie-broken by the mean R@1.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

_RE_RECALL = re.compile(
    r"^(?:val/)?(text[_ ]?to[_ ]?image|image[_ ]?to[_ ]?text)[_/ ]?r@(\d+)$", re.I
)

_WANTED_KEYS = [
    "text_to_image_R@1", "text_to_image_R@5", "text_to_image_R@10",
    "image_to_text_R@1", "image_to_text_R@5", "image_to_text_R@10",
]


def _normalize_recall_value(v) -> Optional[float]:
    if v is None:
        return None
    v = float(v)
    return v * 100.0 if 0.0 <= v <= 1.0 else v


def extract_recalls_0_100(metrics: Dict) -> Dict[str, float]:
    out = {}
    for k, v in metrics.items():
        if not isinstance(v, (int, float)):
            continue
        m = _RE_RECALL.match(k.replace("-", "_"))
        if not m:
            continue
        direction = m.group(1).lower().replace(" ", "_")
        out[f"{direction}_R@{m.group(2)}"] = _normalize_recall_value(v)
    return out


def dataset_retrieval_score(metrics: Dict) -> Tuple[float, float]:
    """(mean of available recalls, tie-break mean R@1) — `helpers.py:426-441`."""
    rec = extract_recalls_0_100(metrics)
    vals = [rec[k] for k in _WANTED_KEYS if rec.get(k) is not None]
    if not vals:
        return float("nan"), float("-inf")
    score = sum(vals) / len(vals)
    r1s = [x for x in (rec.get("text_to_image_R@1"), rec.get("image_to_text_R@1")) if x is not None]
    tie = sum(r1s) / len(r1s) if r1s else float("-inf")
    return score, tie


def epoch_retrieval_score(epoch_results: List[Dict]) -> Tuple[float, float]:
    """Average dataset scores for one epoch (`helpers.py:443-457`)."""
    scores, ties = [], []
    for r in epoch_results:
        s, t = dataset_retrieval_score(r.get("metrics", {}))
        if not math.isnan(s):
            scores.append(s)
            ties.append(t)
    if not scores:
        return float("nan"), float("-inf")
    return sum(scores) / len(scores), (sum(ties) / len(ties) if ties else float("-inf"))


def sanitize_metric_name(name: str) -> str:
    """MLflow-safe metric names (`helpers.py:459-463`)."""
    name = name.replace("@", "_at_")
    return re.sub(r"[^A-Za-z0-9 _\-.:/]", "_", name)


class AverageMeter:
    """Running average meter (`train.py:48-64`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
