"""Precompute DINOv2 teacher features and the index map for a training CSV.

The port of the JAX package's ``eval/extract_dino_features.py``, with its
flags: CSV -> batched DINOv2 CLS features (``.npy``, fp32 rows, memory-mapped
by ``train/data.DinoFeatureStore``) + a canonical-path index map (``.json``,
``{"path_to_index": {path: row}}``), keyed by the same ``_canon_path`` that
``CsvDataset`` uses, so ``CsvDataset._validate_dino_map`` passes by
construction. The CSV is read with the port's ``csv``-module reader (no
pandas); each unique image once, in first-seen order. Preprocessing is the
eval transform (shortest-edge resize, centre crop) with ImageNet statistics.
The teacher comes from ``models/dinov2.py:load_dinov2_model`` (a local HF
directory or the hub cache under ``--cache-dir``; nothing is downloaded) in
fp32, through the fused attention kernel on the card (12 launches a batch
at dinov2-small). It runs on the CUDA card unless ``--force-cpu`` is given;
with no card it raises.

  python -m refining_clip_via_dinov2_representations_torch.eval.extract_dino_features \\
      --csv train.csv --img-key filepath --dino-model /path/to/dinov2-small \\
      --out-feats dino_feats.npy --out-map dino_index_map.json
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None):
    """Writes the features and the map; returns (out_feats, out_map)."""
    import numpy as np
    import torch

    from ..constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    from ..models.dinov2 import load_dinov2_model
    from ..train.data import _canon_path, _read_csv
    from ..transform import image_transform
    from ._batching import encode_images_padded

    ap = argparse.ArgumentParser("extract_dino_features")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--img-key", default="filepath")
    ap.add_argument("--dino-model", default="facebook/dinov2-small")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--out-feats", required=True, help=".npy output")
    ap.add_argument("--out-map", required=True, help=".json path->row map")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--force-cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    device = torch.device("cpu" if args.force_cpu else "cuda")
    model = load_dinov2_model(args.dino_model, cache_dir=args.cache_dir, device=device)
    paths = [_canon_path(p) for p in _read_csv(args.csv, ",", (args.img_key,))[args.img_key]]
    uniq = list(dict.fromkeys(paths))  # unique, order-preserving
    logging.info("%d rows, %d unique images", len(paths), len(uniq))
    # the teacher's own preprocessing: shortest-edge resize + centre crop +
    # ImageNet normalisation (HF Dinov2 processor defaults)
    preprocess = image_transform(args.image_size, is_train=False,
                                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)

    def encode(images: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model(torch.from_numpy(images).to(device)).float().cpu().numpy()

    all_feats = encode_images_padded(encode, uniq, preprocess, args.batch_size, log_tag="dino")
    np.save(args.out_feats, all_feats)
    with open(args.out_map, "w") as f:
        json.dump({"path_to_index": {p: i for i, p in enumerate(uniq)}}, f)
    logging.info("wrote %s %s and %s (%d entries)", args.out_feats, all_feats.shape,
                 args.out_map, len(uniq))
    return args.out_feats, args.out_map


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
