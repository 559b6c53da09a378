#!/usr/bin/env python3
"""Where the serving and training time goes in the PyTorch port, on one
CUDA card.

    python3 scripts/profile_torch_serving.py

Builds the ViT-B-16 serving engine (seeded random weights, fp32 compute,
buckets 1/8/32), then for each bucket and tower profiles five engine calls
with ``torch.profiler`` (CPU + CUDA activities) and reports, per call:
the host-clock latency, the device busy time (union of kernel intervals),
the device idle share, the device operations (kernels and copies) per call,
the attention kernels' share of device time (the fused and the flash
kernels together, and the flash kernel alone), the top kernels by device
time and the top host operators by their own host time (inflated by the
profiler's overhead). Then the same for three ViT-B-16 DINO-soft train
steps (bf16 compute, batch 64, seeded random batch), through the fused
attention kernels and through the plain attention, and for three
ViT-L-14-336 DINO-soft train steps (577 vision tokens, bf16, batch 32) through
the flash kernel with grad checkpointing. Prints the full table as one JSON
object on its last line. Fails when the profiler records no device time (it
then cannot say where the time goes).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL, CALLS, TRAIN_STEPS, TRAIN_BATCH = "ViT-B-16", 5, 3, 64
LONG_MODEL, LONG_BATCH = "ViT-L-14-336", 32


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def profile_calls(fn, arg, calls: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(arg)  # ends in a device sync
        wall_us = (time.perf_counter() - t0) * 1e6
    intervals, by_name = [], defaultdict(float)
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):  # e.g. the optimizer step's range
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[_short(e.name)] += e.time_range.end - e.time_range.start
    busy = _busy_us(intervals)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    kernel_us = sum(by_name.values())
    flash = sum(v for k, v in by_name.items() if "flash_attention" in k)
    attn = flash + sum(v for k, v in by_name.items() if "fused_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # host side: the operators that take the most of the host's own time
    # (the profiler's overhead included), and how often each runs per call
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return {
        "latency_ms": wall_us / calls / 1e3,
        "device_busy_ms": busy / calls / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "device_ops_per_call": len(intervals) / calls,
        "attention_share_of_device": attn / kernel_us,
        "flash_share_of_device": flash / kernel_us,
        "top_kernels_ms": {k: v / calls / 1e3 for k, v in top},
        "top_host_ops": {e.key: {"self_ms": e.self_cpu_time_total / calls / 1e3,
                                 "count": e.count / calls} for e in host},
    }


def train_step_fn(attn_impl: str, model_name: str = MODEL, grad_checkpointing: bool = False):
    """A DINO-soft train step (bf16 compute, MLP head from the embed dim to
    384, default param groups, cosine schedule) that ends in a device sync."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg, DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train.optim import (
        OptimCfg, build_optimizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.scheduler import cosine_lr
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, TrainState, make_train_step, train_parameters,
    )

    model, _ = create_model(model_name, precision="bf16", device="cuda", attn_impl=attn_impl,
                            grad_checkpointing=grad_checkpointing)
    model.train()
    torch.manual_seed(1)
    head = DinoProjectionHead(model.text_projection.shape[1], 384).to("cuda")
    optimizer, _ = build_optimizer(train_parameters(model, head), OptimCfg(),
                                   cosine_lr(5e-4, 0, 100))
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))
    step = make_train_step(model, cfg, head)
    state = TrainState(model, head, optimizer)

    def run(batch):
        step(state, batch)
        torch.cuda.synchronize()

    return run


def main() -> None:
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine

    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    engine, _, tokenizer = create_engine(MODEL, device="cuda", buckets=(1, 8, 32))
    h, w = engine.image_size
    rng = np.random.default_rng(0)
    results = {"card": card, "model": MODEL, "calls": CALLS, "cells": {}}
    for b in engine.buckets:
        pixels = rng.normal(size=(b, h, w, 3)).astype(np.float32)
        ids = tokenizer([f"a photo of object number {i}" for i in range(b)])
        for tower, fn, arg in (("image", engine.encode_image, pixels),
                               ("text", engine.encode_text, ids)):
            r = profile_calls(fn, arg, CALLS)
            results["cells"][f"{tower}_b{b}"] = r
            top = ", ".join(f"{k} {v:.3f}" for k, v in list(r["top_kernels_ms"].items())[:3])
            print(f"{tower} bucket {b}: latency {r['latency_ms']:.3f} ms, device busy "
                  f"{r['device_busy_ms']:.3f} ms, idle {r['idle_share']:.1%}, attention "
                  f"kernels {r['attention_share_of_device']:.1%} of device; top: {top}",
                  flush=True)
    del engine

    def batch_of(n, size):
        ids = tokenizer([f"a photo of item {i} in scene {i % 5}" for i in range(n)])
        batch = {
            "images": torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32)),
            "texts": torch.from_numpy(ids).long(),
            "dino_features": torch.from_numpy(rng.normal(size=(n, 384)).astype(np.float32)),
        }
        return {k: v.to("cuda") for k, v in batch.items()}

    cells = (("train_b64", (MODEL, "auto", False), TRAIN_BATCH, h),
             ("train_b64_plain_attention", (MODEL, "xla", False), TRAIN_BATCH, h),
             ("train_vit_l_14_336_b32_flash_grad_checkpointing", (LONG_MODEL, "flash", True),
              LONG_BATCH, 336))
    for name, (model_name, impl, remat), n, size in cells:
        torch.cuda.empty_cache()
        r = profile_calls(train_step_fn(impl, model_name, remat), batch_of(n, size), TRAIN_STEPS)
        results["cells"][name] = r
        top = ", ".join(f"{k} {v:.3f}" for k, v in list(r["top_kernels_ms"].items())[:4])
        host = ", ".join(f"{k} {v['self_ms']:.3f} ms x {v['count']:.0f}"
                         for k, v in list(r["top_host_ops"].items())[:4])
        print(f"{name}: step {r['latency_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
              f"idle {r['idle_share']:.1%}, {r['device_ops_per_call']:.0f} device ops, attention "
              f"kernels {r['attention_share_of_device']:.1%} (flash "
              f"{r['flash_share_of_device']:.1%}) of device; top: {top}; host: {host}", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
