"""Offline evaluation harness: the thesis' acceptance tools.

The port of the JAX package's ``eval/offline.py``, as callable functions and
one CLI with a subcommand each:

  extract_features    CSV (path, label) -> L2-normalised CLIP image features
  knn_top1            blocked cosine kNN (k = 20) on frozen features
  eval_geometry       uniformity and anisotropy of the embedding
  linear_probe        SGD linear head on frozen features (best top-1)

Feature files are ``.npz`` with keys {feats, labels[, classes]}; a ``.pt``
path takes the reference's torch layout, both ways. CSVs are read with the
port's ``csv``-module reader (the card's machine has no pandas). The image
encoder runs on the CUDA card (``device``; ``--force-cpu`` on the CPU), in
bf16 by default, through the fused attention kernel (12 launches a batch
for ViT-B-16); kNN and geometry are numpy on the host; the probe is
``torch.optim.SGD`` on ``device``.

  python -m refining_clip_via_dinov2_representations_torch.eval.offline extract \\
      --csv val.csv --out val_feats.npz --model ViT-B-16 --pretrained openai
  python -m refining_clip_via_dinov2_representations_torch.eval.offline knn \\
      --train train_feats.npz --val val_feats.npz
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np


def load_feats(path: str):
    """{feats, labels[, classes]} from ``.npz`` or the reference's ``.pt``."""
    if str(path).endswith(".pt"):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        return (obj["feats"].float().numpy(), obj["labels"].long().numpy(),
                obj.get("classes"))
    z = np.load(path, allow_pickle=True)
    classes = z["classes"].tolist() if "classes" in z else None
    return np.asarray(z["feats"], np.float32), np.asarray(z["labels"], np.int64), classes


def save_feats(path: str, feats: np.ndarray, labels: np.ndarray, classes=None):
    """A feature dump that ``load_feats`` reads back at the same path: a
    ``.pt`` path in the reference's torch layout, anything else through
    ``np.savez`` (which appends ``.npz`` when it is missing)."""
    if str(path).endswith(".pt"):
        import torch

        payload = {"feats": torch.from_numpy(np.ascontiguousarray(feats, np.float32)),
                   "labels": torch.from_numpy(np.ascontiguousarray(labels, np.int64))}
        if classes is not None:
            payload["classes"] = list(classes)
        torch.save(payload, path)
        return
    payload = {"feats": feats.astype(np.float32), "labels": labels.astype(np.int64)}
    if classes is not None:
        payload["classes"] = np.asarray(classes)
    np.savez(path, **payload)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def align_label_spaces(ytr, ctr, yva, cva):
    """Two feature files' integer labels on one class space: where both
    stored their ``classes``, remapped through the sorted union (each CSV's
    class -> index map is its own, so a split missing a class shifts the
    others); files without class lists are taken as aligned."""
    if not ctr or not cva:
        return ytr, yva, None
    ctr = [str(c) for c in ctr]
    cva = [str(c) for c in cva]
    if ctr == cva:
        return ytr, yva, ctr
    union = sorted(set(ctr) | set(cva))
    m = {c: i for i, c in enumerate(union)}
    ytr = np.asarray([m[ctr[int(y)]] for y in ytr], np.int64)
    yva = np.asarray([m[cva[int(y)]] for y in yva], np.int64)
    return ytr, yva, union


def extract_features(csv_path: str, out_path: str, model_name: str = "ViT-B-32",
                     pretrained: Optional[str] = None, checkpoint: Optional[str] = None,
                     img_key: str = "filepath", label_key: str = "label",
                     batch_size: int = 256, precision: str = "bf16", device="cuda",
                     cache_dir: Optional[str] = None):
    """Normalised ``encode_image`` features of a (path, label) CSV, written
    with ``save_feats`` (labels index the sorted class names). The model
    always runs QuickGELU, as the reference's ``build_image_encoder`` does;
    ``checkpoint`` loads over the weights with ``strict=False``."""
    import torch

    from ..models.factory import create_model, load_checkpoint
    from ..train.data import _read_csv
    from ..transform import image_transform_v2
    from ._batching import encode_images_padded

    model, pp_cfg = create_model(model_name, pretrained, precision=precision, device=device,
                                 force_quick_gelu=True, cache_dir=cache_dir)
    if checkpoint:
        load_checkpoint(model, checkpoint, strict=False)
    cols = _read_csv(csv_path, ",", (img_key, label_key))
    raw_labels = cols[label_key]
    classes = sorted(set(map(str, raw_labels)))
    cls2idx = {c: i for i, c in enumerate(classes)}
    labels = np.asarray([cls2idx[str(v)] for v in raw_labels], np.int64)
    dev = next(model.parameters()).device

    def encode(images: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model.encode_image(torch.from_numpy(images).to(dev),
                                      normalize=True).float().cpu().numpy()

    feats = encode_images_padded(encode, cols[img_key], image_transform_v2(pp_cfg), batch_size,
                                 log_tag="extract")
    save_feats(out_path, feats, labels, classes)
    return out_path


def knn_top1(train_path: str, val_path: str, k: int = 20, block: int = 8192) -> float:
    """Top-1 of a majority vote over each val row's k nearest train rows
    (cosine), in blocks of ``block`` val rows."""
    xtr, ytr, ctr = load_feats(train_path)
    xva, yva, cva = load_feats(val_path)
    ytr, yva, _ = align_label_spaces(ytr, ctr, yva, cva)
    xtr, xva = _l2n(xtr), _l2n(xva)
    correct = total = 0
    for i in range(0, xva.shape[0], block):
        s = xva[i:i + block] @ xtr.T
        topk = np.argpartition(-s, kth=min(k, s.shape[1] - 1), axis=1)[:, :k]
        preds = np.array([np.bincount(row).argmax() for row in ytr[topk]], np.int64)
        correct += int((preds == yva[i:i + block]).sum())
        total += preds.size
    acc = correct / total
    print(f"[kNN] k={k} top1={acc:.4f}")
    return acc


def uniformity(feats: np.ndarray, n_pairs: int = 20000, temperature: float = 2.0,
               seed: int = 0) -> float:
    """E[exp(-t ||z_i - z_j||^2)] over random pairs (lower = more uniform)."""
    rng = np.random.default_rng(seed)
    n = feats.shape[0]
    i = rng.integers(0, n, n_pairs)
    j = rng.integers(0, n, n_pairs)
    d2 = np.sum((feats[i] - feats[j]) ** 2, axis=1)
    return float(np.exp(-temperature * d2).mean())


def anisotropy(feats: np.ndarray, q: int = 256) -> Tuple[float, float, float]:
    """Explained-variance share of the leading 1, 10 and 100 PCs."""
    x = feats - feats.mean(axis=0, keepdims=True)
    q = min(q, min(x.shape) - 1)
    s = np.linalg.svd(x, compute_uv=False)[:q]
    expl = s ** 2 / np.sum(s ** 2)
    pc10 = float(expl[:10].sum()) if expl.size >= 10 else float(expl.sum())
    pc100 = float(expl[:100].sum()) if expl.size >= 100 else float(expl.sum())
    return float(expl[0]), pc10, pc100


def eval_geometry(feats_path: str, n_pairs: int = 20000, temperature: float = 2.0):
    feats, _, _ = load_feats(feats_path)
    feats = _l2n(feats)
    u = uniformity(feats, n_pairs, temperature)
    pc1, pc10, pc100 = anisotropy(feats)
    print(f"[uniformity] {u:.6f} (lower better)")
    print(f"[anisotropy] PC1={pc1*100:.2f}%  PC1-10={pc10*100:.2f}%  "
          f"PC1-100={pc100*100:.2f}% (flatter better)")
    return {"uniformity": u, "pc1": pc1, "pc10": pc10, "pc100": pc100}


def linear_probe(train_path: str, val_path: str, epochs: int = 15, lr: float = 1e-2,
                 wd: float = 0.0, batch_size: int = 2048, seed: int = 0, device="cuda",
                 history: Optional[List[dict]] = None) -> float:
    """A zero-initialised linear head on frozen features, trained with
    ``torch.optim.SGD(momentum=0.9, weight_decay=wd)`` (the JAX package's
    ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum=0.9))``) over
    batches in ``np.random.default_rng(seed)`` order; returns the best
    val top-1 over the epochs. ``history`` receives each epoch's mean train
    loss and top-1."""
    import torch
    import torch.nn.functional as F

    from ..models.factory import _resolve_device

    dev = _resolve_device(device)
    xtr, ytr, ctr = load_feats(train_path)
    xva, yva, cva = load_feats(val_path)
    ytr, yva, union = align_label_spaces(ytr, ctr, yva, cva)
    n_classes = len(union) if union else int(max(ytr.max(), yva.max())) + 1
    print(f"[data] train={xtr.shape} val={xva.shape} classes={n_classes}")
    w = torch.zeros(xtr.shape[1], n_classes, device=dev, requires_grad=True)
    b = torch.zeros(n_classes, device=dev, requires_grad=True)
    opt = torch.optim.SGD([w, b], lr=lr, momentum=0.9, weight_decay=wd)
    xtr_t, ytr_t = torch.from_numpy(xtr).to(dev), torch.from_numpy(ytr).to(dev)
    xva_t = torch.from_numpy(xva).to(dev)
    rng = np.random.default_rng(seed)
    best_acc, best_epoch = 0.0, -1
    n = xtr.shape[0]
    for ep in range(1, epochs + 1):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            loss = F.cross_entropy(xtr_t[idx] @ w + b, ytr_t[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            preds = torch.cat([torch.argmax(xva_t[i:i + batch_size] @ w + b, dim=1)
                               for i in range(0, xva.shape[0], batch_size)])
        acc = float((preds.cpu().numpy() == yva).mean())
        if acc > best_acc:
            best_acc, best_epoch = acc, ep
        if history is not None:
            history.append({"epoch": ep, "loss": float(torch.stack(losses).mean()),
                            "top1": acc})
        print(f"[eval] acc@top1={acc:.4f} (best {best_acc:.4f} @epoch {best_epoch})")
    print(f"[done] Linear probe best top1={best_acc:.4f} @epoch {best_epoch}")
    return best_acc


def main(argv=None):
    """``extract``, ``knn``, ``geometry`` and ``linear-probe`` subcommands,
    with the JAX CLI's flags, plus ``--force-cpu`` (the card otherwise) and
    ``--cache-dir`` (where ``--pretrained`` tags are looked for)."""
    import argparse

    p = argparse.ArgumentParser(prog="offline-evals",
                                description="Offline thesis acceptance tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("extract", help="CSV(path,label) -> CLIP image features")
    ex.add_argument("--csv", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--model", default="ViT-B-32")
    ex.add_argument("--pretrained", default=None)
    ex.add_argument("--checkpoint", default=None)
    ex.add_argument("--img-key", default="filepath")
    ex.add_argument("--label-key", default="label")
    ex.add_argument("--batch-size", type=int, default=256)
    ex.add_argument("--precision", default="bf16")
    ex.add_argument("--cache-dir", default=None)

    kn = sub.add_parser("knn", help="blocked cosine kNN top-1 (k=20)")
    kn.add_argument("--train", required=True)
    kn.add_argument("--val", required=True)
    kn.add_argument("--k", type=int, default=20)
    kn.add_argument("--block", type=int, default=8192)

    ge = sub.add_parser("geometry", help="uniformity + anisotropy diagnostics")
    ge.add_argument("--feats", required=True)
    ge.add_argument("--n-pairs", type=int, default=20000)
    ge.add_argument("--temperature", type=float, default=2.0)

    lp = sub.add_parser("linear-probe", help="SGD linear head on frozen feats")
    lp.add_argument("--train", required=True)
    lp.add_argument("--val", required=True)
    lp.add_argument("--epochs", type=int, default=15)
    lp.add_argument("--lr", type=float, default=1e-2)
    lp.add_argument("--wd", type=float, default=0.0)
    lp.add_argument("--batch-size", type=int, default=2048)
    lp.add_argument("--seed", type=int, default=0)
    for sp in (ex, lp):
        sp.add_argument("--force-cpu", action="store_true", help="run on the CPU, not the card")

    a = p.parse_args(argv)
    if a.cmd == "extract":
        out = extract_features(a.csv, a.out, model_name=a.model, pretrained=a.pretrained,
                               checkpoint=a.checkpoint, img_key=a.img_key,
                               label_key=a.label_key, batch_size=a.batch_size,
                               precision=a.precision, cache_dir=a.cache_dir,
                               device="cpu" if a.force_cpu else "cuda")
        print(f"[done] wrote {out}")
    elif a.cmd == "knn":
        acc = knn_top1(a.train, a.val, k=a.k, block=a.block)
        print(f"[done] kNN top1={acc:.4f}")
    elif a.cmd == "geometry":
        eval_geometry(a.feats, n_pairs=a.n_pairs, temperature=a.temperature)
    elif a.cmd == "linear-probe":
        linear_probe(a.train, a.val, epochs=a.epochs, lr=a.lr, wd=a.wd,
                     batch_size=a.batch_size, seed=a.seed,
                     device="cpu" if a.force_cpu else "cuda")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
