"""Evaluation beyond the train loop's: the CLIP-blind pair check and the
end-of-run retrieval table."""

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

__all__ = [
    "DEFAULT_THRESHOLDS",
    "align_dino_feats_to_paths",
    "build_dino_path_maps",
    "dedup_by_path",
    "encode_clip_and_dino_images",
    "encode_clip_images_and_paths",
    "extract_and_plot_itm_scores",
    "flickr_retrieval_eval_",
    "pair_stats",
    "run_clip_blind_on_split",
]
