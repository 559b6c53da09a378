"""Standalone CLIP-blind counter.

The port of the JAX package's ``eval/clip_blinds_cli.py``: a CSV image list
-> CLIP image embeddings (on the CUDA card unless ``--force-cpu``; 12
fused-forward launches a batch for ViT-B-16) against cached DINO features
-> upper-triangle pairs with CLIP similarity >= ``--clip-thr`` (0.8) and
DINO similarity <= ``--dino-thr`` (0.3) -> ``summary.txt``,
``summary.json`` and, with ``--save-pairs``, ``pairs.csv`` under
``--out-dir``. Unlike ``offline.extract_features`` it does not force
QuickGELU, as in the JAX package. The DINO rows align to the CSV's unique
canonical paths through ``--dino-index-map`` (path, then basename), or are
taken in CSV order without one.

  python -m refining_clip_via_dinov2_representations_torch.eval.clip_blinds_cli \\
      --csv val.csv --model ViT-B-16 --pretrained openai \\
      --dino-feats dino_feats.pt --dino-index-map dino_index_map.pt --out-dir blind
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np


def load_dino_features_any(path: str) -> np.ndarray:
    """[N, D] fp32 DINO features from ``.npy``, ``.npz`` or ``.safetensors``
    (``train/data.DinoFeatureStore``), or a torch file holding a tensor,
    ``{"feats": tensor}`` or a path -> feature dict (stacked in key order)."""
    if path.endswith((".npy", ".npz", ".safetensors")):
        from ..train.data import DinoFeatureStore

        return np.asarray(DinoFeatureStore(path, mmap=False).features, np.float32)
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, torch.Tensor):
        return obj.float().numpy()
    if isinstance(obj, dict):
        if "feats" in obj:
            return obj["feats"].float().numpy()
        return np.stack([np.asarray(v, np.float32) for v in obj.values()])
    raise ValueError(f"unrecognized DINO feature file format: {path}")


def main(argv=None):
    """Writes the summaries; returns ``pair_stats``' result."""
    import torch

    from ..models.factory import create_model, load_checkpoint
    from ..train.data import _canon_path, _read_csv, load_dino_index_map
    from ..transform import image_transform_v2
    from ._batching import encode_images_padded
    from .clip_blind import align_dino_feats_to_paths, build_dino_path_maps, pair_stats

    ap = argparse.ArgumentParser("clip_blinds")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--img-key", default="filepath")
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dino-feats", required=True)
    ap.add_argument("--dino-index-map", default=None)
    ap.add_argument("--clip-thr", type=float, default=0.8)
    ap.add_argument("--dino-thr", type=float, default=0.3)
    ap.add_argument("--out-dir", default="./clip_blind_out")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-images", type=int, default=2000)
    ap.add_argument("--save-pairs", action="store_true")
    ap.add_argument("--cache-dir", default=None, help="where --pretrained tags are looked for")
    ap.add_argument("--force-cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    model, pp_cfg = create_model(args.model, args.pretrained, cache_dir=args.cache_dir,
                                 device="cpu" if args.force_cpu else "cuda")
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint, strict=False)
    # unique canonical paths, in CSV order
    uniq = list(dict.fromkeys(_canon_path(p) for p in
                              _read_csv(args.csv, ",", (args.img_key,))[args.img_key]))
    uniq = uniq[:args.max_images]
    dev = next(model.parameters()).device

    def encode(images: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model.encode_image(torch.from_numpy(images).to(dev),
                                      normalize=True).float().cpu().numpy()

    clip_z = encode_images_padded(encode, uniq, image_transform_v2(pp_cfg), args.batch_size)
    dino_feats = load_dino_features_any(args.dino_feats)
    if args.dino_index_map:
        p2i, b2i = build_dino_path_maps({"path_to_index":
                                         load_dino_index_map(args.dino_index_map)})
        dino_z, keep, hp, hb, miss = align_dino_feats_to_paths(dino_feats, p2i, b2i, uniq)
        if dino_z is None:
            raise ValueError(f"no CSV path of {args.csv} is in {args.dino_index_map}")
        clip_z = clip_z[keep]
        logging.info("aligned: path=%d base=%d miss=%d", hp, hb, miss)
    else:
        if dino_feats.shape[0] < clip_z.shape[0]:
            raise ValueError(f"{args.dino_feats} holds {dino_feats.shape[0]} rows for "
                             f"{clip_z.shape[0]} images")
        dino_z = dino_feats[:clip_z.shape[0]]
        dino_z = dino_z / np.maximum(np.linalg.norm(dino_z, axis=-1, keepdims=True), 1e-12)

    stats = pair_stats(clip_z, dino_z, thresholds=[(args.clip_thr, args.dino_thr)])
    res = stats["results"][f"clip≥{args.clip_thr}_dino≤{args.dino_thr}"]
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "summary.txt"), "w") as f:
        f.write(f"images: {clip_z.shape[0]}\n"
                f"total_pairs: {stats['total_pairs']}\n"
                f"clip_thr: {args.clip_thr}\ndino_thr: {args.dino_thr}\n"
                f"blind_pairs: {res['count']}\n"
                f"blind_percent_of_all: {res['percent']:.4f}\n"
                f"clip_high_pairs: {res['clip_high_count']}\n"
                f"blind_relative_percent: {res['relative_percent']:.4f}\n")
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(stats["results"], f, indent=2, ensure_ascii=False)
    if args.save_pairs:
        with open(os.path.join(args.out_dir, "pairs.csv"), "w") as f:
            f.write("i,j,clip_sim,dino_sim,gap\n")
            for p in stats["top_pairs"]:
                f.write(f"{p['i']},{p['j']},{p['clip_sim']:.4f},{p['dino_sim']:.4f},"
                        f"{p['gap']:.4f}\n")
    print(f"[clip-blind] {res['count']} blind pairs "
          f"({res['relative_percent']:.2f}% of CLIP-high pairs)")
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
