"""End-of-run metrics: Flickr-style retrieval on aligned rows, and the
per-epoch recall table with its plots.

The port of the JAX package's ``eval/my_metrics.py`` (``flickr_retrieval_eval_``
and ``extract_and_plot_itm_scores``), on numpy. The table
``itm_scores.csv`` is written with the ``csv`` module before any plot, and
``matplotlib`` is imported only to plot, so a machine without it still gets
the table; the caller treats a plot failure as a warning.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

_COLUMNS = ("epoch", "txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1", "img_r5",
            "img_r10", "img_r_mean", "r_mean", "average_similarity", "modality_gap")


def _canon_key(k: str) -> str:
    """Metric name -> table column. As in the JAX package (and the reference
    it follows), ``text_to_image_R@*`` maps to ``txt_r*``: the "Text R@1"
    curve is the text-to-image recall. Absent keys fill 0.0."""
    if "/" in k:
        k = k.split("/", 1)[1]
    k = k.replace("text_to_image_R@", "txt_r")
    k = k.replace("image_to_text_R@", "img_r")
    k = k.replace("text_to_image_mean_rank", "txt_mean_rank")
    k = k.replace("text_to_image_median_rank", "txt_median_rank")
    k = k.replace("image_to_text_mean_rank", "img_mean_rank")
    k = k.replace("image_to_text_median_rank", "img_median_rank")
    return k.replace("@", "_at_")


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def flickr_retrieval_eval_(text_embeddings, image_embeddings) -> Dict[str, float]:
    """Five captions per image on aligned caption-level rows: row i is
    caption i, its image's features repeated at the same row; images are
    rows 0, 5, 10, ... As in the JAX package, ``txt_r*`` are the
    image-to-text recalls and ``img_r*`` the text-to-image ones."""
    t = _l2n(np.asarray(text_embeddings, np.float32))
    i_feats = _l2n(np.asarray(image_embeddings, np.float32))
    n = t.shape[0]
    if n % 5:
        raise ValueError(f"{n} rows: five captions per image expected")
    n_img = n // 5
    average_similarity = float(np.sum(i_feats * t, axis=-1).mean())

    img_rows = np.arange(0, n, 5)
    scores_it = i_feats[img_rows] @ t.T
    order_it = np.argsort(-scores_it, axis=1)
    rank_of = np.empty_like(order_it)
    rank_of[np.arange(n_img)[:, None], order_it] = np.arange(n)[None, :]
    ranks_img = np.array([rank_of[g, g * 5:g * 5 + 5].min() for g in range(n_img)], np.int64)

    scores_ti = t @ i_feats[img_rows].T
    order_ti = np.argsort(-scores_ti, axis=1)
    targets = np.arange(n) // 5
    ranks_cap = np.argmax(order_ti == targets[:, None], axis=1)

    def r(at, ranks):
        return float(100.0 * (ranks < at).mean())

    return {
        "txt_r1": r(1, ranks_img), "txt_r5": r(5, ranks_img), "txt_r10": r(10, ranks_img),
        "img_r1": r(1, ranks_cap), "img_r5": r(5, ranks_cap), "img_r10": r(10, ranks_cap),
        "average_similarity": average_similarity,
    }


def _itm_columns(results, prefer_dataset: Optional[str]) -> Dict[str, list]:
    """One row per epoch that has results: the chosen dataset's metrics
    under the table's column names, the recall means filled in."""

    def mean_of(keys, d):
        vals = [d[k] for k in keys if k in d]
        return sum(vals) / len(vals) if vals else 0.0

    cols = {k: [] for k in _COLUMNS}
    for entry in results:
        epoch = entry.get("epoch")
        res_list = entry.get("results", [])
        if epoch is None or not res_list:
            continue
        chosen = None
        if prefer_dataset is not None:
            chosen = next((r for r in res_list if r.get("val_name") == prefer_dataset), None)
        if chosen is None:
            chosen = res_list[0]
        m = {_canon_key(k): float(v) for k, v in chosen.get("metrics", chosen).items()
             if isinstance(v, (int, float))}
        m.setdefault("txt_r_mean", mean_of(["txt_r1", "txt_r5", "txt_r10"], m))
        m.setdefault("img_r_mean", mean_of(["img_r1", "img_r5", "img_r10"], m))
        m.setdefault("r_mean", (m["txt_r_mean"] + m["img_r_mean"]) / 2.0)
        cols["epoch"].append(epoch)
        for k in _COLUMNS[1:]:
            cols[k].append(m.get(k, 0.0))
    return cols


def _plot(epochs, cols, output_plot_path, output_similarity_plot_path,
          output_modality_gap_plot_path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r_mean = cols["r_mean"]
    best = max(r_mean)
    plt.figure()
    for key, label in (("txt_r1", "Text R@1"), ("txt_r5", "Text R@5"), ("txt_r10", "Text R@10"),
                       ("img_r1", "Image R@1"), ("img_r5", "Image R@5"),
                       ("img_r10", "Image R@10")):
        plt.plot(epochs, cols[key], label=label)
    plt.plot(epochs, r_mean, label="R Mean", linestyle="--", linewidth=2)
    plt.scatter([epochs[r_mean.index(best)]], [best], label=f"Best R Mean ({best:.2f})")
    plt.scatter([epochs[-1]], [r_mean[-1]], label=f"Final R Mean ({r_mean[-1]:.2f})")
    plt.xlabel("Epoch"); plt.ylabel("Recall (%)")
    plt.title("ITM Recall Scores over Epochs")
    plt.legend(); plt.grid(True)
    plt.savefig(output_plot_path); plt.close()

    for key, label, pick, path in (
            ("average_similarity", "Average Similarity", max, output_similarity_plot_path),
            ("modality_gap", "Modality Gap (L2)", min, output_modality_gap_plot_path)):
        vals = cols[key]
        chosen = pick(vals)
        plt.figure()
        plt.plot(epochs, vals, label=label, linewidth=2)
        plt.scatter([epochs[vals.index(chosen)]], [chosen], label=f"Best ({chosen:.4f})")
        plt.scatter([epochs[-1]], [vals[-1]], label=f"Final ({vals[-1]:.4f})")
        plt.xlabel("Epoch"); plt.ylabel(label)
        plt.title(f"{label} over Epochs")
        plt.legend(); plt.grid(True)
        plt.savefig(path); plt.close()


def extract_and_plot_itm_scores(results_file_path: str, output_plot_path: str,
                                output_similarity_plot_path: str,
                                save_csv_path: Optional[str] = None,
                                prefer_dataset: Optional[str] = None,
                                output_modality_gap_plot_path: Optional[str] = None,
                                ) -> Dict[str, Tuple]:
    """Per-epoch recall, similarity and modality-gap columns from a run's
    ``final_itm_results.json``: ``save_csv_path`` gets the table (the JAX
    package's ``itm_scores.csv`` columns), then the three PNG plots are
    drawn (this raises where ``matplotlib`` is missing, after the table is
    written). Returns the best and final values."""
    with open(results_file_path) as f:
        results = json.load(f)
    cols = _itm_columns(results, prefer_dataset)
    epochs = cols["epoch"]
    if not epochs:
        raise ValueError(f"No usable results found in {results_file_path}")
    if save_csv_path:
        with open(save_csv_path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(_COLUMNS)
            w.writerows(zip(*(cols[k] for k in _COLUMNS)))

    r_mean, sims, gaps = cols["r_mean"], cols["average_similarity"], cols["modality_gap"]
    summary = {
        "best_r_mean": (epochs[r_mean.index(max(r_mean))], max(r_mean)),
        "final_r_mean": (epochs[-1], r_mean[-1]),
        "best_similarity": (epochs[sims.index(max(sims))], max(sims)),
        "final_similarity": (epochs[-1], sims[-1]),
        "best_modality_gap": (epochs[gaps.index(min(gaps))], min(gaps)),
        "final_modality_gap": (epochs[-1], gaps[-1]),
    }
    if output_modality_gap_plot_path is None and output_similarity_plot_path:
        output_modality_gap_plot_path = os.path.join(
            os.path.dirname(output_similarity_plot_path), "modality_gap_plot.png")
    _plot(epochs, cols, output_plot_path, output_similarity_plot_path,
          output_modality_gap_plot_path)
    return summary
