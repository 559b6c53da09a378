"""Offline-eval orchestrator: extract -> kNN -> geometry -> linear probe.

The port of the JAX package's ``eval/run_all_evals.py``: the stages of
``eval/offline.py`` in-process, in the same order and with the same outputs
(``train_feats.npz``, ``val_feats.npz`` and ``all_evals.json`` under
``--out-dir``). The image encoder and the probe run on the CUDA card unless
``--force-cpu`` is given.

  python -m refining_clip_via_dinov2_representations_torch.eval.run_all_evals \\
      --train-csv train.csv --val-csv val.csv --model ViT-B-16 \\
      --pretrained openai --checkpoint run/checkpoints/epoch_5.pt --out-dir evals
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def main(argv=None):
    """Runs the stages; returns the dict written to ``all_evals.json``."""
    from .offline import eval_geometry, extract_features, knn_top1, linear_probe

    ap = argparse.ArgumentParser("run_all_evals")
    ap.add_argument("--train-csv", required=True, help="CSV with (filepath,label)")
    ap.add_argument("--val-csv", required=True)
    ap.add_argument("--img-key", default="filepath")
    ap.add_argument("--label-key", default="label")
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out-dir", default="./eval_out")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--knn-k", type=int, default=20)
    ap.add_argument("--probe-epochs", type=int, default=15)
    ap.add_argument("--skip-extract", action="store_true")
    ap.add_argument("--cache-dir", default=None, help="where --pretrained tags are looked for")
    ap.add_argument("--force-cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.force_cpu else "cuda"

    os.makedirs(args.out_dir, exist_ok=True)
    train_feats = os.path.join(args.out_dir, "train_feats.npz")
    val_feats = os.path.join(args.out_dir, "val_feats.npz")
    if not args.skip_extract:
        for split, csv, out in (("train", args.train_csv, train_feats),
                                ("val", args.val_csv, val_feats)):
            logging.info("[1/4] extracting %s features", split)
            extract_features(csv, out, args.model, args.pretrained, args.checkpoint,
                             args.img_key, args.label_key, args.batch_size, device=device,
                             cache_dir=args.cache_dir)
    logging.info("[2/4] kNN")
    knn = knn_top1(train_feats, val_feats, k=args.knn_k)
    logging.info("[3/4] geometry")
    geom = eval_geometry(val_feats)
    logging.info("[4/4] linear probe")
    probe = linear_probe(train_feats, val_feats, epochs=args.probe_epochs, device=device)

    results = {"knn_top1": knn, "linear_probe_top1": probe, **geom}
    with open(os.path.join(args.out_dir, "all_evals.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
