"""Evaluation beyond the train loop's: the CLIP-blind pair check, the
end-of-run retrieval table, the zero-shot classifier and the offline
acceptance tools (``offline``, ``run_all_evals``, ``clip_blinds_cli``)."""

from .clip_blind import (
    DEFAULT_THRESHOLDS,
    align_dino_feats_to_paths,
    build_dino_path_maps,
    dedup_by_path,
    encode_clip_and_dino_images,
    encode_clip_images_and_paths,
    pair_stats,
    run_clip_blind_on_split,
)
from .my_metrics import extract_and_plot_itm_scores, flickr_retrieval_eval_
from .zero_shot_classifier import build_zero_shot_classifier, build_zero_shot_classifier_legacy

__all__ = [
    "DEFAULT_THRESHOLDS",
    "align_dino_feats_to_paths",
    "build_dino_path_maps",
    "build_zero_shot_classifier",
    "build_zero_shot_classifier_legacy",
    "dedup_by_path",
    "encode_clip_and_dino_images",
    "encode_clip_images_and_paths",
    "extract_and_plot_itm_scores",
    "flickr_retrieval_eval_",
    "pair_stats",
    "run_clip_blind_on_split",
]
