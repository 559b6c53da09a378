#!/usr/bin/env python3
"""Where the time of Config 5's single-chip step goes: ViT-g-14 on one CUDA
card.

    python3 scripts/profile_giant_step.py [--steps 2]

Builds ViT-g-14 (seeded random weights, bf16 compute over fp32 parameters)
with the DINO-soft loss (kl_teacher, lambda_soft 0.5, MLP head to 384) at
batch 16 on a seeded batch, and profiles ``--steps`` train steps with
``torch.profiler`` under: adafactor with a bf16 first moment and ``full``
remat (the recipe with the least memory), the same under
``dots_with_no_batch_dims_saveable`` (``docs/REPRODUCE.md``'s flags), the
same without remat, and AdamW (fp32 first moment) under ``full``. For each
it prints the host clock per step, the device busy time (union of kernel
intervals), the idle share, the kernels per step, the device time by kind
(GEMMs, the attention kernels, the optimizer's elementwise and reduction
kernels, the rest) and the top kernels, and the top host operators by
their own time. Prints the table as one JSON object on its last line.
Fails when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.profile_torch_serving import _busy_us, _short  # noqa: E402

MODEL, BATCH, DINO_DIM = "ViT-g-14", 16, 384
RUNS = [("adafactor bf16-mu, full remat", "adafactor", "bfloat16", "full"),
        ("adafactor bf16-mu, dots_with_no_batch_dims_saveable", "adafactor", "bfloat16",
         "dots_with_no_batch_dims_saveable"),
        ("adafactor bf16-mu, no remat", "adafactor", "bfloat16", None),
        ("adamw fp32-mu, full remat", "adamw", None, "full")]


def _kind(name: str) -> str:
    low = name.lower()
    if "fused_attention" in low or "flash_attention" in low:
        return "attention"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
        return "gemm"
    if "foreach" in low or "multi_tensor" in low:
        return "foreach"
    if "reduce" in low:
        return "reduction"
    return "other"


def profile_steps(step, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals, by_name = [], defaultdict(float)
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[_short(e.name)] += e.time_range.end - e.time_range.start
    busy = _busy_us(intervals)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    kinds = defaultdict(float)
    for k, v in by_name.items():
        kinds[_kind(k)] += v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return {
        "step_ms": wall_us / steps / 1e3,
        "device_busy_ms": busy / steps / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "kernels_per_step": len(intervals) / steps,
        "device_ms_by_kind": {k: v / steps / 1e3 for k, v in sorted(kinds.items())},
        "top_kernels_ms": {k: v / steps / 1e3 for k, v in top},
        "top_host_ops": {e.key: {"self_ms": e.self_cpu_time_total / steps / 1e3,
                                 "count": e.count / steps} for e in host},
    }


def main() -> None:
    import subprocess

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step, train_parameters,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    model, _ = create_model(MODEL, precision="bf16", device="cuda", grad_checkpointing=True)
    model.train()
    torch.manual_seed(1)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM).to("cuda")
    rng = np.random.default_rng(0)
    captions = [f"a photo of item {i}" for i in range(BATCH)]
    batch = {"images": torch.from_numpy(rng.normal(size=(BATCH, 224, 224, 3)).astype(
                 np.float32)).cuda(),
             "texts": torch.from_numpy(get_tokenizer(MODEL)(captions)).long().cuda(),
             "dino_features": torch.from_numpy(rng.normal(size=(BATCH, DINO_DIM)).astype(
                 np.float32)).cuda()}
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))
    train_step = make_train_step(model, cfg, head)
    table = {}
    for label, opt, mu, policy in RUNS:
        for tower in (model.visual.transformer, model.transformer):
            tower.grad_checkpointing = policy is not None
            tower.remat_policy = policy or "full"
        params = train_parameters(model, head)
        for p in params.values():
            p.grad = None
        torch.cuda.empty_cache()
        optimizer, _ = build_optimizer(params, OptimCfg(opt=opt, mu_dtype=mu),
                                       cosine_lr(5e-4, 0, 100))
        state = TrainState(model, head, optimizer)
        r = profile_steps(lambda: train_step(state, batch), args.steps)
        table[label] = r
        kinds = ", ".join(f"{k} {v:.1f}" for k, v in r["device_ms_by_kind"].items())
        print(f"{label}: step {r['step_ms']:.3f} ms (host clock, profiler on), device busy "
              f"{r['device_busy_ms']:.3f} ms, idle {r['idle_share']:.1%}, "
              f"{r['kernels_per_step']:.0f} kernels; device ms by kind: {kinds} [{card}]",
              flush=True)
        for k, v in r["top_kernels_ms"].items():
            print(f"    {v:9.3f} ms  {k}", flush=True)
        for k, v in r["top_host_ops"].items():
            print(f"    host {v['self_ms']:9.3f} ms x{v['count']:.0f}  {k}", flush=True)
        del state, optimizer
    print(json.dumps({"card": card, "model": MODEL, "batch": BATCH, "runs": table}), flush=True)


if __name__ == "__main__":
    main()
