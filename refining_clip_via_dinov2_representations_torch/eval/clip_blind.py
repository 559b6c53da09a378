"""CLIP-blind pair analysis: the thesis' diagnostic metric.

The port of the JAX package's ``eval/clip_blind.py``. A pair of images is
"CLIP-blind" when their CLIP embeddings are very similar but their DINOv2
embeddings are not. The headline number is the relative percentage: blind
pairs over CLIP-high pairs.

Pipeline: encode images (the image tower alone under ``torch.no_grad()``; on
a card 12 fused-forward launches a batch at ViT-B-16) -> dedup by canonical
path -> align the precomputed DINO features by path, with a basename
fallback -> upper-triangle similarity thresholds -> summary JSON and a CSV
of the top-gap pairs. With a live teacher
(``train/dino_teacher.py:LiveDinoTeacher``, when training ran without
precomputed features) one pass over the loader gives both embeddings of the
same pixels, so no path alignment is needed; on a card that adds 12
fused-forward launches a batch at dinov2-small. Across ranks each rank
encodes its share of every batch and the shares are gathered
(``parallel/mesh.py:on_rank_rows``); rank 0 writes the files.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import on_rank_rows
from ..train.data import _canon_path
from ..train.distributed import data_group

DEFAULT_THRESHOLDS: List[Tuple[float, float]] = [(0.90, 0.60), (0.85, 0.65), (0.80, 0.65)]


def encode_clip_images_and_paths(model: torch.nn.Module, dataloader, max_images=None):
    """[M, D] L2-normalised CLIP image features (fp32, on the host) and
    canonical paths. Stops once ``max_images`` samples are encoded."""
    device = next(model.parameters()).device
    embs, paths_all = [], []
    total = 0
    for batch in dataloader:
        if "image_path" not in batch:
            raise RuntimeError("Eval batch missing file paths; CsvDataset should return them.")
        images = torch.from_numpy(np.asarray(batch["images"], np.float32)).to(device)
        with torch.no_grad():
            feats = on_rank_rows(model.encode_image, images, group=data_group()).float()
            feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        embs.append(feats.cpu().numpy())
        paths_all.extend(_canon_path(p) for p in batch["image_path"])
        total += len(batch["image_path"])
        if max_images and total >= max_images:
            break
    clip_z = np.concatenate(embs, axis=0) if embs else np.empty((0, 0))
    return clip_z, paths_all


def encode_clip_and_dino_images(model: torch.nn.Module, dino_teacher, dataloader,
                                max_images=None):
    """The live-teacher pass: ([M, D] L2-normalised CLIP image features,
    [M, Dd] L2-normalised teacher features, canonical paths), fp32 on the
    host. Stops once ``max_images`` samples are encoded."""
    device = next(model.parameters()).device
    clip_all, dino_all, paths_all = [], [], []
    total = 0
    for batch in dataloader:
        if "image_path" not in batch:
            raise RuntimeError("Eval batch missing file paths; CsvDataset should return them.")
        images = torch.from_numpy(np.asarray(batch["images"], np.float32)).to(device)
        with torch.no_grad():
            feats, dino = on_rank_rows(lambda x: (model.encode_image(x), dino_teacher.extract(x)),
                                       images, group=data_group())
            feats, dino = feats.float(), dino.float()
        for out, z in ((clip_all, feats), (dino_all, dino)):
            out.append((z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)).cpu().numpy())
        paths_all.extend(_canon_path(p) for p in batch["image_path"])
        total += len(batch["image_path"])
        if max_images and total >= max_images:
            break
    if not clip_all:
        return np.empty((0, 0)), np.empty((0, 0)), paths_all
    return np.concatenate(clip_all), np.concatenate(dino_all), paths_all


def build_dino_path_maps(dino_index_map_obj: Dict):
    """path -> index and basename -> index maps."""
    if not isinstance(dino_index_map_obj, dict):
        raise RuntimeError("DINO index map must be a dict.")
    if "path_to_index" in dino_index_map_obj:
        p2i_raw = dino_index_map_obj["path_to_index"]
    else:
        p2i_raw = {k: v for k, v in dino_index_map_obj.items()
                   if isinstance(v, (int, np.integer))}
    path2idx = {_canon_path(k): int(v) for k, v in p2i_raw.items()}
    if isinstance(dino_index_map_obj.get("basename_to_index"), dict):
        base2idx = {os.path.basename(k): int(v)
                    for k, v in dino_index_map_obj["basename_to_index"].items()}
    else:
        base2idx = {os.path.basename(k): int(v) for k, v in path2idx.items()}
    return path2idx, base2idx


def dedup_by_path(clip_z: np.ndarray, paths: List[str]):
    """First-occurrence dedup -> (rows, paths, kept indices)."""
    seen = {}
    idx_keep = []
    for i, p in enumerate(paths):
        if p not in seen:
            seen[p] = i
            idx_keep.append(i)
    if len(idx_keep) == len(paths):
        return clip_z, paths, list(range(len(paths)))
    return clip_z[idx_keep], [paths[i] for i in idx_keep], idx_keep


def align_dino_feats_to_paths(dino_feats: np.ndarray, path2idx: Dict, base2idx: Dict,
                              paths: List[str]):
    """Path first, basename as the fallback; an unknown path or an index past
    the store is a miss. -> (L2-normalised rows or None, kept indices, path
    hits, basename hits, misses)."""
    out, keep_idx = [], []
    hit_path = hit_base = miss = 0
    for i, p in enumerate(paths):
        j = path2idx.get(p)
        via_base = False
        if j is None:
            j = base2idx.get(os.path.basename(p))
            via_base = j is not None
        if j is None or not (0 <= int(j) < len(dino_feats)):
            miss += 1
            continue
        if via_base:
            hit_base += 1
        else:
            hit_path += 1
        out.append(np.asarray(dino_feats[j], np.float32))
        keep_idx.append(i)
    if not out:
        return None, [], hit_path, hit_base, miss
    z = np.stack(out, axis=0)
    z = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-12)
    return z, keep_idx, hit_path, hit_base, miss


def pair_stats(clip_z: np.ndarray, dino_z: np.ndarray,
               thresholds: Sequence[Tuple[float, float]] = DEFAULT_THRESHOLDS,
               top_k: int = 200) -> Dict:
    """Upper-triangle blind-pair statistics; ``relative_percent`` = blind /
    CLIP-high pairs is the reported metric."""
    cs = clip_z @ clip_z.T
    ds = dino_z @ dino_z.T
    iu, ju = np.triu_indices(cs.shape[0], k=1)
    cs_u = cs[iu, ju]
    ds_u = ds[iu, ju]
    gap = cs_u - ds_u

    total_pairs = int(cs_u.size)
    out = {"total_pairs": total_pairs, "results": {}, "thresholds": list(thresholds)}
    for cmin, dmax in thresholds:
        clip_high = cs_u >= cmin
        blind = clip_high & (ds_u <= dmax)
        chc = int(clip_high.sum())
        bc = int(blind.sum())
        out["results"][f"clip≥{cmin}_dino≤{dmax}"] = {
            "count": bc,
            "percent": 100.0 * bc / (total_pairs or 1),
            "clip_high_count": chc,
            "relative_percent": 100.0 * bc / (chc or 1),
        }

    k = min(top_k, total_pairs)
    if k > 0:
        part = np.argpartition(-gap, k - 1)[:k]
        top = part[np.argsort(-gap[part])]
        out["top_pairs"] = [{"i": int(iu[r]), "j": int(ju[r]), "clip_sim": float(cs_u[r]),
                             "dino_sim": float(ds_u[r]), "gap": float(gap[r])} for r in top]
    else:
        out["top_pairs"] = []
    return out


def run_clip_blind_on_split(split_key: str, data: Dict, model: torch.nn.Module,
                            dino_feats: Optional[np.ndarray],
                            dino_index_map_obj: Optional[Dict], out_dir: str,
                            thresholds: Sequence[Tuple[float, float]] = DEFAULT_THRESHOLDS,
                            max_images: Optional[int] = 2000,
                            dino_teacher=None) -> Optional[Dict]:
    """Encode ``data[split_key]`` (an eval loader: its batches carry
    ``image_path``), take the teacher rows (aligned from the precomputed
    ``dino_feats`` by path, or from ``dino_teacher`` on the same pixels),
    and write ``clip_blind_<split>.json`` and
    ``clip_blind_<split>_top_pairs.csv`` under ``out_dir``. Returns the
    stats, or None when the split is absent or no path aligns."""
    if split_key not in data:
        logging.info("[clip-blind] split %s not in data; skipping", split_key)
        return None
    # a margin past the cap, so that it still holds after the dedup
    margin = (2 * max_images) if max_images else None
    if dino_teacher is not None:
        clip_z, dino_z, paths = encode_clip_and_dino_images(
            model, dino_teacher, data[split_key].dataloader, max_images=margin)
        clip_z, paths, keep = dedup_by_path(clip_z, paths)
        dino_z = dino_z[keep]
        if max_images and clip_z.shape[0] > max_images:
            clip_z, dino_z, paths = clip_z[:max_images], dino_z[:max_images], paths[:max_images]
        logging.info("[clip-blind] %s: %d images (live teacher)", split_key, clip_z.shape[0])
    else:
        clip_z, paths = encode_clip_images_and_paths(model, data[split_key].dataloader,
                                                     max_images=margin)
        clip_z, paths, _ = dedup_by_path(clip_z, paths)
        if max_images and clip_z.shape[0] > max_images:
            clip_z, paths = clip_z[:max_images], paths[:max_images]

        path2idx, base2idx = build_dino_path_maps(dino_index_map_obj)
        dino_z, keep_idx, hit_path, hit_base, miss = align_dino_feats_to_paths(
            dino_feats, path2idx, base2idx, paths)
        if dino_z is None:
            logging.warning("[clip-blind] no DINO alignment on %s (miss=%d)", split_key, miss)
            return None
        clip_z = clip_z[keep_idx]
        # pair indices refer to the aligned rows, so the paths follow them
        paths = [paths[i] for i in keep_idx]
        logging.info("[clip-blind] %s: %d images (path hits %d, basename hits %d, miss %d)",
                     split_key, clip_z.shape[0], hit_path, hit_base, miss)

    stats = pair_stats(clip_z, dino_z, thresholds)
    if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
        return stats  # every rank encodes its share; rank 0 writes
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, f"clip_blind_{split_key}.json")
    with open(summary_path, "w") as f:
        json.dump(stats, f, indent=2, ensure_ascii=False, default=float)
    with open(os.path.join(out_dir, f"clip_blind_{split_key}_top_pairs.csv"), "w") as f:
        f.write("i,j,path_i,path_j,clip_sim,dino_sim,gap\n")
        for p in stats["top_pairs"]:
            f.write(f"{p['i']},{p['j']},{paths[p['i']]},{paths[p['j']]},"
                    f"{p['clip_sim']:.4f},{p['dino_sim']:.4f},{p['gap']:.4f}\n")
    logging.info("[clip-blind] wrote %s", summary_path)
    return stats
