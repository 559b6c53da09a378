#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name and power limit; no CUDA device is a failure.
2. build   — compiles every CUDA kernel of the serving and training paths
   from ``csrc/``, one nvcc per source, all started together.
3. kernels — the forward kernel against its plain PyTorch version on the
   card, at the serving shapes and edge cases, in float32 (the split-TF32
   tensor-core kernel up to head dim 128) and bfloat16.
3b. kernels-bwd — the backward kernel against its plain version and a
   float64 version with the same rounding points, at the same cases plus
   the training shapes, Lq != Lk and head dims 80 and 128, in float32 and
   bfloat16 (both dtypes run tensor-core kernels up to head dim 128, fp32
   through split-TF32 products); the autograd Function against autograd
   through the plain forward.
4. serve   — ViT-B-16 at full width on a seeded random init, through
   ``create_engine`` and the HTTP server: image, text and similarity
   requests, ``/health`` and concurrent HTTP requests that the batcher
   coalesces. Checks unit-norm features, the kernel's launch count (12 per
   tower call: one per attention layer), agreement with the same weights
   run through the plain attention path (cosine >= 0.9999 in fp32), and by
   the profiler that one served fp32 image call ran the split-TF32 kernel
   and no scalar fp32 kernel.
5. times   — each kernel, its plain version and the library yardstick
   (``scaled_dot_product_attention``, which the port never calls) timed with
   CUDA events at the serving shapes, beside the kernel's bound (fp32: on
   TF32 tensor cores, three products a FLOP, with the CUDA-core bound beside
   it) and the time of the scalar kernel each tensor-core route replaced
   (where recorded), with the speedup; each tower's
   time per call with the kernel and with the plain attention (CUDA events
   behind a queued sleep: device time as long as the host launches faster
   than the device runs; ``scripts/profile_torch_serving.py`` gives device
   busy time and idle share); request latency per bucket.
6. train-step / train-cli — three ViT-B-16 DINO-soft steps through both
   fused kernels (24 + 24 launches per step), one step's loss and gradients
   against plain attention (bf16: all tensors together, beside the same
   comparison between the kernels' plain versions and plain attention), and
   the training CLI, whose checkpoint serves; the fp32 step (what
   ``--precision amp`` runs): its launches, the profiler's check that it ran
   the split-TF32 kernels and no scalar fp32 kernel, and its time and peak
   memory through the kernels and through plain attention; the backward
   kernel's times (each beside the scalar kernels' it replaced, with the
   speedup).
7. kernels-flash — the flash forward kernel against its plain version and a
   float64 version with the same rounding points, from 512 to 4097 tokens,
   causal, Lq != Lk both ways, head_dim 40 to 256, in float32 (the
   split-TF32 tensor-core kernel up to head dim 128) and bfloat16; its
   autograd Function against autograd through the plain version.
8. train-long — ViT-L-14-336 (577 vision tokens) at full width and depth,
   DINO-soft, bf16, ``attn_impl="flash"``: three steps without and three
   with grad checkpointing (24 and 48 flash launches per step, no fused
   launch), one step's loss and gradients against plain attention, step
   times and peak memory; then in fp32 compute with grad checkpointing
   (what ``--precision amp --attn-impl flash --grad-checkpointing`` runs):
   one step's loss and gradients against plain attention, three steps'
   launches (48 flash a step, no fused), the profiler's check that a step
   ran the split-TF32 flash kernel and no scalar fp32 kernel, and the
   step's time and peak memory through flash, through ``"auto"`` (the fused
   fp32 kernels at 577 tokens) and through plain attention.
9. train-cli-long — the training CLI on ViT-L-14-336 with
   ``--grad-checkpointing`` (its checkpoint loads strictly) and on ViT-B-16
   with ``--force-image-size 384`` (12 flash launches per forward); then the
   flash kernel's times beside its plain version, SDPA, its bound and the
   scalar kernel's time.

The DINOv2 teacher's phases run after train-eval-cli, on its mini-Flickr
set (the forward kernel is checked at the teacher's shapes ``[64,6,257,64]``
and ``[32,16,257,64]`` in phase 3, and timed in phase 5):

10. teacher — a seeded dinov2-small directory in the HF layout at the
    published config (hidden 384, 12 layers, 6 heads, patch 14, image_size
    518, LayerScale 1.0, LN eps 1e-6), loaded with ``load_dinov2_model``; a
    batch of 64 at 224 px in fp32 and bf16 through ``"auto"`` (12 fused
    forward launches a call, no backward) against ``"xla"`` (CLS cosine >=
    0.9999 fp32, >= 0.999 bf16), the time per batch; one fp32 forward each
    of dinov2-large and dinov2-giant (SwiGLU) at batch 32 against ``"xla"``.
11. extract — the port's feature extractor on both mini-Flickr CSVs with
    the seeded teacher: rows, the map, ``DinoFeatureStore`` and
    ``CsvDataset`` accept them, 12 launches a batch.
12. train-live-cli — the CLI at ViT-B-16, ``--precision amp``, batch 32, one
    epoch with evaluation and ``--run_clip_blind``, the teacher from
    ``--dino_model_name`` and no ``--dino_fts_path``: a non-zero
    ``soft_loss``, both CLIP-blind files, launches (36 forward + 24 backward
    a train step, 24 an eval batch, 24 a CLIP-blind batch), the extracted
    rows against the live check's teacher rows of the same val images
    (cosine >= 0.9999), wall time, samples/s and the seconds in the teacher
    (CUDA events around ``extract``); then the live fp32 step alone beside
    the step on cached features and the teacher alone at batch 32.

The pretrained-checkpoint and thesis-evaluation phases run after them on the
same set, at ViT-B-16's full width (the fused forward is checked and timed
at their new shapes, the zero-shot text batch ``[800,8,77,64]`` causal and
the offline extractor's bf16 ``[256,12,197,64]``, in phases 3 and 5):

13. pretrained — the port's seeded ViT-B-16 weights written twice: as the
    open_clip-layout file of the ``openai`` tag's hub repo in the hub-cache
    layout, and as an fp16 OpenAI TorchScript archive. ``create_model(...,
    pretrained="openai")``, ``load_openai_model(archive)`` and
    ``create_model(..., pretrained=archive)`` (what ``--pretrained
    <archive>`` runs) hold exactly the written values (fp16-rounded from the
    archive); the archive's features through the kernel against plain
    attention (cosine >= 0.9999, fp32, 12 launches a tower call); the 224-px
    checkpoint at ``force_image_size=384`` resizes its table and runs
    ``[B,12,577,64]`` through the fused kernel and through flash.
14. zero-shot — Config 1 through ``train.main.main``: ``--pretrained
    openai``, mini-Flickr's val CSV and ``--imagenet-val`` on a procedural
    ImageNet-V2-style folder (1000 digit-named classes, one image each), no
    train data: retrieval, top-1/top-5, the classifier's seconds (80,000
    captions, 100 text calls of ``[800,77]``) and the launches; the
    classifier of the first 10 classes through plain attention (weight
    cosine >= 0.9999, fp32).
15. finetune — Config 2: train-eval-cli's thesis flags with ``--pretrained
    openai`` for one epoch; its pre-train evaluation equals Config 1's
    retrieval (same weights); samples/s, the evaluations, the launches, and
    the fp32 step alone from the pretrained weights.
16. offline — ``eval.run_all_evals`` on both mini-Flickr CSVs (the ``label``
    column) from that run's checkpoint (bf16 extraction, 12 launches a batch
    of 256 rows), then ``eval.clip_blinds_cli`` on the val CSV with
    mini-Flickr's DINO features and map: kNN, probe, geometry and CLIP-blind
    results and each stage's seconds; the extracted val features against
    plain attention's (cosine >= 0.999, bf16).

The line before the last is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# published H100 SXM peaks (NVIDIA data sheet, dense): the tensor-core rates
# (TF32 for fp32, which the kernels form from three split TF32 products to
# keep fp32 accuracy, so one fp32 FLOP takes three), the plain fp32 FMA rate
# outside the tensor cores (printed beside fp32 bounds), HBM3 bandwidth
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PRODUCTS_PER_FLOP = {"float32": 3, "bfloat16": 1}
CUDA_CORE_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| compared in fp32, and |kernel - float64 version|:
# fp32 differs by summation order only; bf16 by one output ulp (7.8e-3
# near 1) where rounding flips
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MIN_COSINE = 0.9999  # engine features vs the plain-attention run, fp32
# Kernel cases: (B, H, L, D, causal). The ViT-B-16 serving shapes (image
# [b,12,197,64], causal text [b,8,77,64]) at buckets 8 and 32, ViT-B-32's
# [8,12,50,64], and edge cases: L = 1, odd L, L = 1024, odd B*H, head_dim
# not a multiple of 32, and the largest head_dim the gate admits.
KERNEL_CASES = [
    (8, 12, 197, 64, False), (8, 8, 77, 64, True), (8, 12, 50, 64, False),
    (32, 12, 197, 64, False), (32, 8, 77, 64, True),
    (1, 1, 1, 64, False), (1, 1, 1, 64, True), (3, 5, 23, 64, True),
    (3, 5, 23, 64, False), (1, 2, 1024, 64, False), (1, 2, 1024, 64, True),
    (2, 3, 65, 40, True), (1, 3, 130, 128, False), (1, 2, 300, 256, True),
    (2, 1, 1024, 256, False),
]
TIMED_CASES = [(1, 12, 197, 64, False), (8, 12, 197, 64, False), (32, 12, 197, 64, False),
               (64, 12, 197, 64, False), (1, 8, 77, 64, True), (8, 8, 77, 64, True),
               (32, 8, 77, 64, True), (64, 8, 77, 64, True)]
MAIN_PATH_CASE = (8, 12, 197, 64, False)  # the image call the served requests make
MODEL, BUCKETS, SEED = "ViT-B-16", (1, 8, 32), 0
DEVICE = "cuda"
CARD = "not read"  # the card's name and power limit, as nvidia-smi gives them
FUSED_TPU = "refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py:60"
FUSED_SRC = "refining_clip_via_dinov2_representations_torch/csrc/fused_attention_fwd.cu"
BWD_TPU = "refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py:69"
BWD_SRC = "refining_clip_via_dinov2_representations_torch/csrc/fused_attention_bwd.cu"
# backward: max |kernel - plain| and |kernel - float64 version| over the
# largest |grad| of the three outputs. fp32: summation order only. bf16: a
# few output ulps (one is 2^-8 of a value; dS, rounded to bf16 before its
# products, flips by one ulp where P or dP differ in their last bits).
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the training shapes: image [64,12,197,64], causal text [64,8,77,64]
TRAIN_CASES = [(64, 12, 197, 64, False), (64, 8, 77, 64, True)]
# backward times: the training shapes, and head dim 256, where both dtypes
# keep the scalar kernels (off every registry model)
BWD_TIMED = TRAIN_CASES + [(8, 4, 197, 256, False)]
# backward only, (B, H, Lq, Lk, D, causal): Lq != Lk with and without the
# causal mask, and head dims 80 and 128 (the widest the bf16 tensor-core
# route takes; 256 in KERNEL_CASES takes the scalar kernels)
BWD_CASES = [
    (4, 12, 197, 150, 64, False), (4, 8, 77, 120, 64, True), (4, 12, 150, 77, 64, True),
    (8, 12, 197, 197, 80, False), (8, 8, 77, 77, 80, True), (8, 12, 197, 197, 128, False),
    (4, 8, 77, 77, 128, True), (2, 4, 300, 1024, 128, False),
]
# The fused kernels' times on the scalar (CUDA-core) kernels each tensor-core
# route replaced (this script's time phases, CUDA events, as PERF.md records
# them); printed beside each new time with the speedup.
SCALAR_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
SCALAR_FUSED_MS = {
    ("float32", (8, 12, 197, 64, False)): 0.0998, ("float32", (32, 12, 197, 64, False)): 0.4184,
    ("float32", (8, 8, 77, 64, True)): 0.0245, ("float32", (32, 8, 77, 64, True)): 0.0472,
    ("bfloat16", (64, 12, 197, 64, False)): 0.8209, ("bfloat16", (64, 8, 77, 64, True)): 0.0725,
}
SCALAR_BWD_MS = {("bfloat16", (64, 12, 197, 64, False)): 2.7512,
                 ("bfloat16", (64, 8, 77, 64, True)): 0.2600,
                 ("float32", (64, 12, 197, 64, False)): 2.7458,
                 ("float32", (64, 8, 77, 64, True)): 0.2661}
# The CUDA kernels of the fp32 route (tensor cores, split TF32) and the
# scalar fp32 kernels they replace at head dim <= 128, as torch.profiler
# names them.
TF32_KERNELS = {"fwd": "fused_attention_fwd_tf32_kernel",
                "dq": "fused_attention_bwd_dq_tf32_kernel",
                "dkdv": "fused_attention_bwd_dkdv_tf32_kernel",
                "flash": "flash_attention_fwd_tf32_kernel"}
SCALAR_F32_KERNELS = {"fwd": "fused_attention_fwd_kernel<float",
                      "dq": "fused_attention_bwd_dq_kernel<float",
                      "dkdv": "fused_attention_bwd_dkdv_kernel<float",
                      "flash": "flash_attention_fwd_kernel<float"}
# the flash kernel's scalar times, each taken before its tensor-core route
# existed (fp32: one turn of scripts/ab_fp32_attention.py on that tree)
SCALAR_FLASH_MS = {(32, 16, 577, 577, 64, False, "bfloat16"): 2.8691,
                   (32, 16, 577, 577, 64, False, "float32"): 2.9048,
                   (32, 12, 577, 577, 64, False, "bfloat16"): 2.0935,
                   (32, 12, 577, 577, 64, False, "float32"): 2.1526}
TRAIN_BATCH, CLI_BATCH, CLI_SAMPLES, DINO_DIM = 64, 32, 96, 384
# train-eval-cli: mini-Flickr at full resolution, 800 train and 200 val
# caption rows; the thesis model at the CLI's batch
EVAL_MODEL, EVAL_BATCH, EVAL_SIZE_PX = "ViT-B-16", 32, 224
EVAL_TRAIN_IMAGES, EVAL_VAL_IMAGES = 160, 40
FLASH_TPU = "refining_clip_via_dinov2_representations_tpu/ops/flash_attention.py:44"
FLASH_SRC = "refining_clip_via_dinov2_representations_torch/csrc/flash_attention_fwd.cu"
# Flash kernel cases: (B, H, Lq, Lk, D, causal). The ViT-L-14-336 and
# ViT-B-16@384 vision shapes, the gate's edge (512) and one past it, 1370
# tokens (a 518-px DINOv2, where "fused" falls to flash), 4097 tokens at
# B*H = 1, Lq < Lk and Lq > Lk, head_dim 80 and 40 (the scale is not exact
# in bf16) and the largest head_dim the gate admits (fp32: the scalar kernel).
FLASH_CASES = [
    (8, 16, 577, 577, 64, False), (8, 16, 577, 577, 64, True),
    (8, 12, 577, 577, 64, False), (8, 12, 577, 577, 64, True),
    (1, 4, 512, 512, 64, False), (1, 4, 513, 513, 64, True), (2, 6, 1370, 1370, 64, False),
    (1, 1, 4097, 4097, 64, False), (1, 1, 4097, 4097, 64, True),
    (2, 4, 600, 1030, 64, False), (2, 4, 600, 1030, 64, True),
    (2, 4, 1030, 600, 64, False), (2, 4, 1030, 600, 64, True),
    (2, 4, 577, 577, 80, False), (2, 4, 577, 577, 40, True), (1, 2, 577, 577, 256, False),
]
FLASH_TIMED = [(32, 16, 577, 577, 64, False, "bfloat16"), (32, 16, 577, 577, 64, False, "float32"),
               (32, 12, 577, 577, 64, False, "bfloat16"), (32, 12, 577, 577, 64, False, "float32")]
LONG_MODEL, LONG_BATCH, CLI_LONG_SAMPLES = "ViT-L-14-336", 32, 96
# the DINOv2 teacher: every variant has head dim 64 and 257 tokens at 224 px
# (fused kernel's gate); the thesis teacher is dinov2-small, 6 heads. HF's
# published dinov2-small config (facebook/dinov2-small/config.json)
TEACHER_CASES = [(64, 6, 257, 64, False), (32, 16, 257, 64, False)]
DINOV2_SMALL = dict(hidden_size=384, layers=12, heads=6, patch_size=14, mlp_ratio=4.0,
                    layerscale_value=1.0, norm_eps=1e-6, use_swiglu_ffn=False,
                    native_image_size=518)
TEACHER_BATCH, TEACHER_BIG_BATCH, LIVE_BATCH = 64, 32, 32
TEACHER_MIN_COS = {"float32": 0.9999, "bfloat16": 0.999}
# one train step through the kernels vs the plain attention, same init/batch
STEP_TOL = {"bfloat16": (1e-2, 0.99), "float32": (1e-5, 0.9999)}  # (loss rel, min cosine)
# the pretrained and thesis-evaluation phases: the zero-shot text call (10
# ImageNet classes x 80 templates, causal) and the offline extractor's bf16
# image batch of 256 rows; the procedural ImageNet-V2 folder's classes (one
# image each); the revision of the seeded hub-cache snapshot
SLICE10_CASES = [(800, 8, 77, 64, True), (256, 12, 197, 64, False)]
ZS_IMAGES, ZS_CLASSES_PER_CALL, EXTRACT_BATCH, HUB_REV = 1000, 10, 256, "seeded"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_device() -> None:
    import torch

    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and bool(smi.stdout.strip()),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    # fp32 stays fp32 in every comparison: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import refining_clip_via_dinov2_representations_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is missing ({e}): run from the root of the repo")


def phase_build() -> None:
    from refining_clip_via_dinov2_representations_torch.ops import native

    t0 = time.perf_counter()
    seconds = native.build()
    print(f"build: {len(seconds)} kernel sources in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})", flush=True)
    for name, log in native.build_logs.items():
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = _kernel_name(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {kernel}: {line.strip()}", flush=True)


def _kernel_name(mangled: str) -> str:
    """``flash_attention_fwd_mma_kernel<64>`` from its mangled name: the
    identifier ending in ``_kernel`` whose length prefix matches (a kernel in
    an anonymous namespace follows a hashed namespace name)."""
    base = mangled
    for m in re.finditer(r"_kernelI", mangled):
        end = m.start() + len("_kernel")
        starts = [end - n for n in range(len("_kernel") + 1, end)
                  if mangled[end - n].isalpha() and mangled[:end - n].endswith(str(n))]
        if starts:
            base = mangled[starts[0]:end]
            break
    args = ["float"] if "IfLi" in mangled else ["bf16"] if "I13__nv_bfloat16Li" in mangled else []
    args += re.findall(r"Li(\d+)E", mangled)
    return f"{base}<{','.join(args)}>"


def _qkv(b, h, l, d, dtype, seed, lk=None):
    """Seeded q [b,h,l,d] and k, v [b,h,lk,d] (lk = l unless given) on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=g).to("cuda", dtype) for n in (l, lk or l, lk or l)]


def _attention_fp64(q, k, v, scale, causal):
    """The kernel's function in float64, P still rounded to V's dtype: its
    distance from the kernel is the kernel's own rounding error."""
    import torch

    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype).double(), v.double())


def phase_kernels() -> dict:
    """Kernel vs its plain version on the card, at the serving, edge,
    teacher and evaluation cases; returns {dtype: max_abs_err}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd, fused_attention_reference,
    )

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, l, d, causal) in enumerate(KERNEL_CASES + TEACHER_CASES + SLICE10_CASES):
            q, k, v = _qkv(b, h, l, d, dtype, seed=i)
            scale = d ** -0.5
            got = fused_attention_fwd(q, k, v, scale, causal)
            want = fused_attention_reference(q, k, v, scale, causal)
            exact = _attention_fp64(q, k, v, scale, causal)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"kernel output {tuple(got.shape)} {got.dtype} at {(b, h, l, d)}")
            err = (got.float() - want.float()).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            worst[name] = max(worst.get(name, 0.0), err)
            ok = (max(err, err64) <= TOL[name]
                  and bool(torch.isfinite(got.float()).all()))
            print(f"kernel fused_attention_fwd {name} [{b},{h},{l},{d}] causal={causal}: "
                  f"max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64 "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"fused_attention_fwd disagrees with its plain version at "
                      f"{name} [{b},{h},{l},{d}] causal={causal}: {err:.3e}")
    return worst


def _post(base: str, path: str, payload: dict):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _cosines(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serve():
    """Drive the port's serving path at ViT-B-16 width; returns
    (engine, plain-attention model, kernel launches of the served run)."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.serve import (
        ClipServer, make_http_server,
    )

    t0 = time.perf_counter()
    engine, preprocess, tokenizer = create_engine(MODEL, device=DEVICE, buckets=BUCKETS,
                                                  seed=SEED)
    model = engine.model
    n_vis, n_txt = len(model.visual.transformer.resblocks), len(model.transformer.resblocks)
    print(f"serve: {MODEL} engine on {engine.device} (vision {n_vis}x"
          f"{model.visual.width}, text {n_txt}x{model.ln_final.weight.numel()}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, buckets "
          f"{engine.buckets}) built and warmed in {time.perf_counter() - t0:.1f} s", flush=True)
    check(n_vis == 12 and n_txt == 12, "ViT-B-16 must have 12 layers per tower")

    rng = np.random.default_rng(SEED)
    pixels = rng.normal(size=(5, 224, 224, 3)).astype(np.float32)
    captions = ["a photo of a cat", "a diagram of a transformer", "two dogs in the snow"]
    http_texts = [f"request number {i} about a red bicycle" for i in range(6)]
    ids = tokenizer(captions)

    server = ClipServer(engine, preprocess, tokenizer, batch_window_ms=50.0)
    httpd = make_http_server(server, host="127.0.0.1", port=0)
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    batcher_calls = []
    text_fn = server._text_batcher._fn

    def counted(x):
        batcher_calls.append(x.shape[0])
        return text_fn(x)

    server._text_batcher._fn = counted
    http_feats = [None] * len(http_texts)
    barrier = threading.Barrier(len(http_texts))

    def client(i):
        barrier.wait(timeout=60)
        status, body = _post(base, "/v1/encode_text", {"texts": [http_texts[i]]})
        if status == 200:
            http_feats[i] = np.asarray(body["features"][0], np.float32)

    try:
        # ---- the main path: counts at 0 just before, read just after ----
        fused_attention_fwd.launches = 0
        img_f = engine.encode_image(pixels)            # 1 image-tower call (bucket 8)
        txt_f = engine.encode_text(ids)                # 1 text-tower call (bucket 8)
        sims = engine.similarity(pixels, ids)          # 1 image + 1 text call
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(http_texts))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        torch.cuda.synchronize()
        launches = fused_attention_fwd.launches
    finally:
        server._text_batcher._fn = text_fn
        httpd.shutdown()
        httpd.server_close()
        server.close()
        serve_thread.join(timeout=30)
    check(not any(t.is_alive() for t in clients), "an HTTP client did not finish")
    check(not serve_thread.is_alive(), "the HTTP server thread did not stop")

    tower_calls = 4 + len(batcher_calls)
    print(f"serve: encode_image {img_f.shape}, encode_text {txt_f.shape}, similarity "
          f"{sims.shape}, /health {health['status']} on {health['device']}, "
          f"{len(http_texts)} concurrent /v1/encode_text coalesced into "
          f"{len(batcher_calls)} batcher calls {batcher_calls}", flush=True)
    print(f"serve: fused_attention_fwd launches {launches} over {tower_calls} tower calls "
          f"(expected {12 * tower_calls})", flush=True)
    check(health["status"] == "ok" and health["buckets"] == list(BUCKETS), "bad /health")
    check(img_f.shape == (5, 512) and txt_f.shape == (3, 512) and sims.shape == (5, 3),
          "feature shapes")
    for name, f in (("image", img_f), ("text", txt_f)):
        norms = np.linalg.norm(f, axis=-1)
        check(bool(np.isfinite(f).all()) and bool(np.abs(norms - 1).max() < 1e-4),
              f"{name} features not finite unit vectors: norms {norms}")
    scale, bias = engine.logit_terms()
    check(bool(np.abs(sims - (scale * img_f @ txt_f.T + bias)).max() < 1e-3),
          "similarity != scale * cos + bias")
    check(all(f is not None for f in http_feats), "an HTTP request failed")
    check(sum(batcher_calls) == len(http_texts) and len(batcher_calls) < len(http_texts),
          f"concurrent requests did not coalesce: {batcher_calls}")
    direct = engine.encode_text(tokenizer(http_texts))
    check(bool(np.abs(np.stack(http_feats) - direct).max() < 1e-4),
          "HTTP features differ from direct engine calls")
    check(launches == 12 * tower_calls,
          f"fused_attention_fwd launched {launches} times, expected {12 * tower_calls}")

    # the same weights through the plain attention path on the card
    plain, _ = create_model(MODEL, device=DEVICE, attn_impl="xla", seed=SEED + 1)
    plain.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        x = torch.from_numpy(pixels).to(DEVICE).to(engine.dtype)
        ref_img = plain.encode_image(x).float().cpu().numpy()
        ref_txt = plain.encode_text(torch.from_numpy(ids).to(DEVICE).long()).float().cpu().numpy()
    cos_img, cos_txt = _cosines(img_f, ref_img), _cosines(txt_f, ref_txt)
    print(f"serve: cosine vs plain attention: image min {cos_img.min():.8f}, "
          f"text min {cos_txt.min():.8f} (need >= {MIN_COSINE})", flush=True)
    check(cos_img.min() >= MIN_COSINE and cos_txt.min() >= MIN_COSINE,
          "engine features disagree with the plain-attention run")
    check_fp32_route(lambda: engine.encode_image(pixels), ("fwd",), "one served fp32 image call")
    return engine, plain, launches


def _kernels_launched(fn) -> set:
    """Names of the CUDA kernels that ``fn`` launches, from torch.profiler.
    ``fn`` runs once before the profiled call: a kernel's first launch loads
    its module, and the profiler can miss the kernels of that launch. The
    profiler at times records a window's runtime calls but none of its
    kernels (seen on an H100); such a window is profiled again, up to three
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        if any("_kernel" in n for n in names):
            break
    return names


def check_fp32_route(fn, parts, what: str) -> None:
    """``fn`` ran the split-TF32 kernels named by ``parts`` (keys of
    ``TF32_KERNELS``) and none of the scalar fp32 kernels, by the profiler."""
    names = _kernels_launched(fn)
    ran = {TF32_KERNELS[p]: any(TF32_KERNELS[p] in n for n in names) for p in parts}
    scalar = sorted(n for n in names if any(k in n for k in SCALAR_F32_KERNELS.values()))
    print(f"route {what}: tensor-core fp32 kernels ran {ran}; scalar fp32 kernels "
          f"{scalar or 'none'}", flush=True)
    check(all(ran.values()) and not scalar,
          f"{what} did not run the split-TF32 kernels alone: {sorted(names)}")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls. A
    sleep kernel queued first keeps the device behind the host, so host-side
    launch cost does not leak into the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 1.5 * iters * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype_name: str):
    """(ms, what bounds it): the larger of the bytes over the memory rate and
    the FLOPs over the tensor-core rate for the type, an fp32 FLOP taking
    three TF32 products (split TF32 keeps fp32 accuracy)."""
    t_ops = flops * PRODUCTS_PER_FLOP[dtype_name] / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def attention_work(b, h, l, d, causal, dtype_name, lk=None):
    """(FLOPs, bytes) of the attention forward: QK^T and PV over the live
    score entries (about half when causal); q, k, v read once, o written
    once. lk = l unless given."""
    elem = 4 if dtype_name == "float32" else 2
    lk = lk or l
    pairs = sum(min(i + 1, lk) for i in range(l)) if causal else l * lk
    return 4.0 * b * h * pairs * d, 2.0 * b * h * (l + lk) * d * elem


def _fp32_cuda_core(work, dtype_name: str) -> str:
    """For fp32, the least time with its FLOPs on CUDA cores (67 TFLOP/s),
    printed beside the bound."""
    if dtype_name != "float32":
        return ""
    flops, nbytes = work
    ms = max(flops / CUDA_CORE_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    return f", cuda-core bound {ms:.4f} ms"


def _beside_scalar(before, ms: float) -> str:
    if before is None:
        return "scalar kernel: not recorded"
    return f"scalar kernel {before:.4f} ms (on {SCALAR_CARD}), {before / ms:.2f}x faster"


def phase_kernel_times(dtype_name: str) -> dict:
    """Kernel, plain version and SDPA (yardstick only) at the serving, the
    teacher and the evaluation shapes."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd, fused_attention_reference,
    )

    dtype = getattr(torch, dtype_name)
    rows = {}
    for b, h, l, d, causal in TIMED_CASES + TEACHER_CASES + SLICE10_CASES:
        q, k, v = _qkv(b, h, l, d, dtype, seed=100)
        scale = d ** -0.5
        ms = time_ms(lambda: fused_attention_fwd(q, k, v, scale, causal))
        plain = time_ms(lambda: fused_attention_reference(q, k, v, scale, causal))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale))
        work = attention_work(b, h, l, d, causal, dtype_name)
        bound, by = _bound(*work, dtype_name)
        rows[(b, h, l, d, causal)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                          bound_ms=bound, bound_by=by)
        print(f"time fused_attention_fwd {dtype_name} [{b},{h},{l},{d}] causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound; "
              f"{_beside_scalar(SCALAR_FUSED_MS.get((dtype_name, (b, h, l, d, causal))), ms)}"
              f" [{CARD}]", flush=True)
    return rows


def phase_serving_times(engine, plain) -> None:
    """Tower time per call with the kernel and with plain attention (CUDA
    events, see ``time_ms``), and the request latency per bucket (host
    clock, H2D and D2H included)."""
    import numpy as np
    import torch

    h, w = engine.image_size
    rng = np.random.default_rng(SEED + 2)
    for b in engine.buckets:
        x = torch.from_numpy(rng.normal(size=(b, h, w, 3)).astype(np.float32)).to("cuda")
        ids = torch.zeros(b, engine.context_length, dtype=torch.long, device="cuda")
        ids[:, 0], ids[:, 1:6], ids[:, 6] = 49406, 320, 49407
        with torch.inference_mode():
            img_ms = time_ms(lambda: engine.model.encode_image(x.to(engine.dtype)), iters=10)
            img_plain = time_ms(lambda: plain.encode_image(x.to(engine.dtype)), iters=10)
            txt_ms = time_ms(lambda: engine.model.encode_text(ids), iters=10)
            txt_plain = time_ms(lambda: plain.encode_text(ids), iters=10)
        host_x, host_ids = x.cpu().numpy(), ids.cpu().numpy().astype(np.int32)
        lat = {}
        for name, fn, arg in (("encode_image", engine.encode_image, host_x),
                              ("encode_text", engine.encode_text, host_ids)):
            samples = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn(arg)
                samples.append((time.perf_counter() - t0) * 1e3)
            lat[name] = statistics.median(samples)
        print(f"time tower bucket {b}: image {img_ms:.3f} ms per call (plain attention "
              f"{img_plain:.3f}), text {txt_ms:.3f} ms (plain {txt_plain:.3f}); request "
              f"latency p50 encode_image {lat['encode_image']:.3f} ms, encode_text "
              f"{lat['encode_text']:.3f} ms"
              f" [{CARD}]", flush=True)


def _attention_bwd_fp64(q, k, v, o, do, scale, causal):
    """The backward kernel's function in float64, rounded to the input dtype
    where ``_bwd_kernel`` rounds (P and dO for dV, dS): its distance from
    the kernel is the kernel's own rounding error."""
    import torch

    t = q.dtype
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(t).double().transpose(-1, -2), do.double())
    dp = torch.matmul(do.double(), v.double().transpose(-1, -2))
    delta = (do.double() * o.double()).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(t).double()
    return (torch.matmul(ds, k.double()) * scale, torch.matmul(ds.transpose(-1, -2), q.double())
            * scale, dv)


def bwd_cases():
    """Every backward case as (B, H, Lq, Lk, D, causal)."""
    return [(b, h, l, l, d, c) for b, h, l, d, c in KERNEL_CASES + TRAIN_CASES] + BWD_CASES


def check_bwd_case(b, h, lq, lk, d, causal, dtype, seed, qkv=None):
    """The backward kernel against its plain version and the float64 version
    at one case, with seeded inputs (or the given q, k, v). Prints one line;
    returns (max_abs_err vs plain, ok)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_bwd_reference, fused_attention_fwd,
    )

    name = str(dtype).split(".")[-1]
    q, k, v = qkv or _qkv(b, h, lq, d, dtype, seed=seed, lk=lk)
    do = _qkv(b, h, lq, d, dtype, seed=1000 + seed)[0]
    scale = d ** -0.5
    o = fused_attention_fwd(q, k, v, scale, causal)
    got = fused_attention_bwd(q, k, v, o, do, scale, causal)
    want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    exact = _attention_bwd_fp64(q, k, v, o, do, scale, causal)
    torch.cuda.synchronize()
    largest = max(w.float().abs().max().item() for w in want)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    err64 = max((g.double() - e).abs().max().item() for g, e in zip(got, exact))
    ok = (all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
          and max(err, err64) <= BWD_REL_TOL[name] * largest
          and all(bool(torch.isfinite(g.float()).all()) for g in got))
    print(f"kernel fused_attention_bwd {name} [{b},{h},{lq},{d}] x {lk} keys causal={causal}: "
          f"max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64, largest |grad| "
          f"{largest:.3e} (tol {BWD_REL_TOL[name]:g} x largest) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    return err, ok


def phase_kernels_bwd() -> dict:
    """Backward kernel vs its plain version (and float64) on the card;
    returns {dtype: max_abs_err vs plain}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention, fused_attention_reference,
    )

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, lq, lk, d, causal) in enumerate(bwd_cases()):
            err, ok = check_bwd_case(b, h, lq, lk, d, causal, dtype, seed=i)
            worst[name] = max(worst.get(name, 0.0), err)
            check(ok, f"fused_attention_bwd disagrees with its plain version at "
                      f"{name} [{b},{h},{lq},{d}] x {lk} keys causal={causal}: {err:.3e}")
    # the autograd Function against autograd through the plain forward, fp32
    for i, (b, h, l, d, causal) in enumerate(TRAIN_CASES):
        q, k, v = (x.requires_grad_() for x in _qkv(b, h, l, d, torch.float32, seed=50 + i))
        do = _qkv(b, h, l, d, torch.float32, seed=60 + i)[0]
        got = torch.autograd.grad(fused_attention(q, k, v, d ** -0.5, causal), (q, k, v), do)
        want = torch.autograd.grad(fused_attention_reference(q, k, v, d ** -0.5, causal),
                                   (q, k, v), do)
        largest = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"autograd fused_attention float32 [{b},{h},{l},{d}] causal={causal}: max_abs_err "
              f"{err:.3e} vs autograd of the plain forward (tol 1e-4 x {largest:.3e})", flush=True)
        check(err <= 1e-4 * largest, "the autograd Function disagrees with autograd")
    return worst


def _train_batch(tokenizer, n: int, device: str, model_name: str = MODEL, size=None,
                 seed: int = SEED + 10) -> dict:
    """Seeded random pixels (at the model's image size unless ``size``), n
    distinct captions through the port's tokenizer, seeded DINO features."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_model_config

    size = size or get_model_config(model_name)["vision_cfg"]["image_size"]
    rng = np.random.default_rng(seed)
    captions = [f"a photo of item {i}, a {['red', 'green', 'blue', 'grey'][i % 4]} thing "
                f"number {i * 7 + 3} in scene {i % 5}" for i in range(n)]
    return {
        "images": torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(np.float32)).to(device),
        "texts": torch.from_numpy(tokenizer(captions)).long().to(device),
        "dino_features": torch.from_numpy(
            rng.normal(size=(n, DINO_DIM)).astype(np.float32)).to(device),
    }


def _dino_setup(precision: str, attn_impl: str, steps: int = 3, model_name: str = MODEL,
                grad_checkpointing: bool = False, force_image_size=None, dino_teacher=None,
                **model_kw):
    """The model (ViT-B-16 by default) + the MLP DINO head (embed dim ->
    448 -> 384 for ViT-B-16) + default param groups + a cosine schedule, from
    the same seeds every time; returns (model, head, state, train_step,
    step_cfg). ``dino_teacher`` gives the step a live teacher; ``model_kw``
    go to ``create_model`` (``pretrained``, ``cache_dir``)."""
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

    model, _ = create_model(model_name, precision=precision, device=DEVICE, attn_impl=attn_impl,
                            seed=SEED, grad_checkpointing=grad_checkpointing,
                            force_image_size=force_image_size, **model_kw)
    model.train()
    torch.manual_seed(SEED + 1)
    head = DinoProjectionHead(model.text_projection.shape[1], DINO_DIM, "mlp").to(DEVICE)
    optimizer, _ = build_optimizer(train_parameters(model, head), OptimCfg(),
                                   cosine_lr(5e-4, 0, steps))
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"))
    state = TrainState(model, head, optimizer, 0, torch.Generator().manual_seed(SEED))
    return model, head, state, make_train_step(model, cfg, head, dino_teacher), cfg


def _loss_and_grads(model, head, cfg, batch):
    from refining_clip_via_dinov2_representations_torch.train.step import (
        make_loss_fn, train_parameters,
    )

    params = train_parameters(model, head)
    for p in params.values():
        p.grad = None
    loss, _ = make_loss_fn(model, cfg, head)(batch, 0)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    return float(loss.detach()), grads


def _grad_cosines(grads_a: dict, grads_b: dict):
    """Per-tensor gradient cosines, and the cosine of all tensors together."""
    import torch

    cos = {}
    for n in grads_a:
        a, b = grads_a[n].double().flatten(), grads_b[n].double().flatten()
        cos[n] = float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))
    a = torch.cat([grads_a[n].double().flatten() for n in grads_a])
    b = torch.cat([grads_b[n].double().flatten() for n in grads_a])
    return cos, float((a @ b) / (a.norm() * b.norm()))


@contextlib.contextmanager
def _plain_versions():
    """Run the flash and fused Functions through the kernels' plain versions
    on CUDA tensors (measurement only): a step through them against one
    through plain attention compares two plain PyTorch versions, no kernel."""
    from refining_clip_via_dinov2_representations_torch.ops import flash_attention as fm
    from refining_clip_via_dinov2_representations_torch.ops import fused_attention as fu

    kernels = fm.flash_attention_fwd, fu.fused_attention_fwd, fu.fused_attention_bwd
    fm.flash_attention_fwd = lambda q, k, v, scale, causal=False: fm.flash_attention_reference(
        q, k, v, scale, causal)
    fu.fused_attention_fwd = lambda q, k, v, scale, causal=False: fu.fused_attention_reference(
        q, k, v, scale, causal)
    fu.fused_attention_bwd = (lambda q, k, v, o, do, scale, causal=False:
                              fu.fused_attention_bwd_reference(q, k, v, o, do, scale, causal))
    try:
        yield
    finally:
        fm.flash_attention_fwd, fu.fused_attention_fwd, fu.fused_attention_bwd = kernels


def _compare_step(precision: str, batch, model_name: str = MODEL, impl: str = "auto",
                  grad_checkpointing: bool = False) -> None:
    """One loss and gradient through the kernels vs the plain attention.
    fp32: every tensor's gradient cosine is held to the minimum. bf16: the
    cosine of all tensors together is, as the bf16 train-step test does
    (``tests/test_torch_train_step.py``), and the per-tensor minimum is
    printed beside the same comparison between two plain versions (the
    kernels' and plain attention), no kernel involved: the bf16 noise floor
    of the step. In bf16 single tensors (``dino_head.fc1.bias``) fall below
    0.99 also between two plain versions, at 197 and at 577 tokens
    (``scripts/step_noise_floor.py``, PERF.md)."""
    import torch

    name = "bfloat16" if precision == "bf16" else "float32"
    loss_tol, min_cos = STEP_TOL[name]
    per_tensor = precision != "bf16"

    def run(attn):
        model, head, _, _, cfg = _dino_setup(precision, attn, model_name=model_name,
                                             grad_checkpointing=grad_checkpointing)
        result = _loss_and_grads(model, head, cfg, batch)
        del model, head
        torch.cuda.empty_cache()
        return result

    (loss_k, grads_k), (loss_p, grads_p) = run(impl), run("xla")
    check(grads_k.keys() == grads_p.keys(), "the two runs have different parameters")
    cos, together = _grad_cosines(grads_k, grads_p)
    worst = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    fp32_grads = all(g.dtype == torch.float32 for g in grads_k.values())
    held = cos[worst] if per_tensor else together
    print(f"train-step {model_name} {precision} impl={impl} grad_checkpointing="
          f"{grad_checkpointing}: loss {loss_k:.6f} through the kernels vs {loss_p:.6f} plain "
          f"(rel {rel:.2e}, tol {loss_tol:g}); gradient cosine, per tensor min {cos[worst]:.6f} "
          f"at {worst} ({sum(c < min_cos for c in cos.values())} of {len(cos)} tensors below "
          f"{min_cos}), all tensors together {together:.6f} (need "
          f"{'per tensor' if per_tensor else 'together'} >= {min_cos}); fp32 grads "
          f"{fp32_grads}", flush=True)
    if not per_tensor:
        with _plain_versions():
            loss_f, grads_f = run(impl)
        cos_f, together_f = _grad_cosines(grads_f, grads_p)
        worst_f = min(cos_f, key=cos_f.get)
        print(f"train-step {model_name} {precision} noise floor, impl={impl} through the "
              f"kernels' plain versions vs plain attention (no kernel): loss rel "
              f"{abs(loss_f - loss_p) / abs(loss_p):.2e}; gradient cosine, per tensor min "
              f"{cos_f[worst_f]:.6f} at {worst_f} ({sum(c < min_cos for c in cos_f.values())} "
              f"below {min_cos}), all tensors together {together_f:.6f}", flush=True)
    check(rel <= loss_tol and held >= min_cos and fp32_grads,
          f"{precision} step through the kernels disagrees with plain attention")


def host_step_ms(fn, steps: int = 5) -> float:
    """Mean host-clock time of one call over ``steps`` back-to-back calls
    that end in one device sync: what a training loop sees, host launch cost
    and device time overlapping."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_train_step():
    """The training main path at ViT-B-16 width, bf16 compute; returns
    (forward launches, backward launches, timing dict)."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )

    batch = _train_batch(get_tokenizer(MODEL), TRAIN_BATCH, DEVICE)
    _compare_step("bf16", batch)

    model, head, state, train_step, _ = _dino_setup("bf16", "auto")
    head_before = [p.detach().clone() for p in head.parameters()]
    steps = 3
    # ---- the main path: counts at 0 just before, read just after ----
    fused_attention_fwd.launches = fused_attention_bwd.launches = 0
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch)
        losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    fwd, bwd = fused_attention_fwd.launches, fused_attention_bwd.launches
    losses = [float(x) for x in losses]
    ln_scale = float(model.logit_scale.detach())
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(head.parameters(), head_before))
    print(f"train-step: {MODEL} bf16 DINO-soft (kl_teacher, lambda_soft 0.5, mlp head "
          f"{head.fc1.in_features}->{head.fc1.out_features}->{DINO_DIM}) batch {TRAIN_BATCH}: losses {losses}, ln logit scale {ln_scale:.6f}, head "
          f"moved by {moved:.3e}; launches fwd {fwd} bwd {bwd} over {steps} steps "
          f"(expected {24 * steps} each)", flush=True)
    check(all(math.isfinite(x) for x in losses), "a train-step loss is not finite")
    check(0.0 <= ln_scale <= math.log(100.0), "the logit scale left [0, ln 100]")
    check(moved > 0, "the DINO head did not move")
    check(fwd == 24 * steps and bwd == 24 * steps,
          f"expected {24 * steps} forward and backward launches, got {fwd} and {bwd}")

    # ---- step time and peak memory, kernels vs plain attention ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: train_step(state, batch), iters=5)
    host_ms = host_step_ms(lambda: train_step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    del model, head, state, train_step
    torch.cuda.empty_cache()
    _, _, p_state, p_step, _ = _dino_setup("bf16", "xla")
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=5)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch))
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {MODEL} bf16 batch {TRAIN_BATCH}: device {step_ms:.3f} ms with the "
          f"kernels, {plain_ms:.3f} ms with plain attention (CUDA events); host clock "
          f"{host_ms:.3f} ms ({TRAIN_BATCH / host_ms * 1e3:.1f} samples/s) with the kernels, "
          f"{plain_host_ms:.3f} ms ({TRAIN_BATCH / plain_host_ms * 1e3:.1f} samples/s) plain; "
          f"peak memory {peak / 2**30:.3f} GiB (plain {plain_peak / 2**30:.3f} GiB)"
              f" [{CARD}]", flush=True)

    _compare_step("fp32", batch)
    phase_fp32_step(batch)
    return fwd, bwd


def phase_fp32_step(batch) -> None:
    """The ViT-B-16 DINO-soft step in fp32 compute (what ``--precision amp``,
    the CLI's default, runs): launches over three steps, the kernels one step
    runs by the profiler (the split-TF32 ones, no scalar fp32 kernel), then
    the step's time and peak memory through the kernels and through plain
    attention."""
    import torch

    model, head, state, train_step, _ = _dino_setup("fp32", "auto")
    steps = 3
    _zero_counts()
    for _ in range(steps):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"train-step {MODEL} fp32: launches {counts} over {steps} steps (expected fused fwd "
          f"and bwd {24 * steps} each)", flush=True)
    check(counts["fused_attention_fwd"] == 24 * steps
          and counts["fused_attention_bwd"] == 24 * steps, f"fp32 step launches {counts}")
    check_fp32_route(lambda: train_step(state, batch), ("fwd", "dq", "dkdv"),
                     "one fp32 train step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: train_step(state, batch), iters=5)
    host_ms = host_step_ms(lambda: train_step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    del model, head, state, train_step
    torch.cuda.empty_cache()
    _, _, p_state, p_step, _ = _dino_setup("fp32", "xla")
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=5)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch))
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {MODEL} fp32 batch {TRAIN_BATCH}: device {step_ms:.3f} ms with the "
          f"kernels, {plain_ms:.3f} ms with plain attention (CUDA events); host clock "
          f"{host_ms:.3f} ms ({TRAIN_BATCH / host_ms * 1e3:.1f} samples/s) with the kernels, "
          f"{plain_host_ms:.3f} ms ({TRAIN_BATCH / plain_host_ms * 1e3:.1f} samples/s) plain; "
          f"peak memory {peak / 2**30:.3f} GiB (plain {plain_peak / 2**30:.3f} GiB) [{CARD}]",
          flush=True)


def phase_train_cli() -> None:
    """``train.main.main`` for one synthetic epoch; its checkpoint serves."""
    import json as _json
    import math
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.train.main import main as train_main

    # a temporary directory inside the checkout's (ignored) build tree
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    logs = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build)
    try:
        fused_attention_fwd.launches = fused_attention_bwd.launches = 0
        train_main(["--model", MODEL, "--dataset-type", "synthetic", "--use_dino_general",
                    "--soft_mode", "kl_teacher", "--lambda_soft", "0.5",
                    "--synthetic-dino-dim", str(DINO_DIM), "--precision", "bf16",
                    "--batch-size", str(CLI_BATCH), "--train-num-samples", str(CLI_SAMPLES),
                    "--epochs", "1", "--workers", "4", "--log-every-n-steps", "1",
                    "--logs", logs, "--name", "cli", "--seed", str(SEED), "--device", DEVICE])
        torch.cuda.synchronize()
        launches = fused_attention_fwd.launches + fused_attention_bwd.launches
        steps = CLI_SAMPLES // CLI_BATCH
        with open(os.path.join(logs, "cli", "loss_steps.json")) as f:
            records = _json.load(f)
        ckpt = os.path.join(logs, "cli", "checkpoints", "epoch_1.pt")
        print(f"train-cli: {len(records)} logged steps, total_loss "
              f"{[r['total_loss'] for r in records]}; kernel launches {launches} "
              f"(expected {48 * steps}); checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB",
              flush=True)
        check(len(records) == steps and all(math.isfinite(r["total_loss"]) for r in records),
              "loss_steps.json is not one finite record per step")
        check(launches == 48 * steps, f"the CLI run launched {launches} kernels")
        engine, _, tokenizer = create_engine(MODEL, checkpoint=ckpt, buckets=(1,), device=DEVICE)
        feats = engine.encode_text(tokenizer(["a photo of a cat"]))
        norm = float(np.linalg.norm(feats))
        print(f"train-cli: the checkpoint serves encode_text {feats.shape}, norm {norm:.6f}",
              flush=True)
        check(feats.shape[0] == 1 and abs(norm - 1) < 1e-4, "the checkpoint does not serve")
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(logs, ignore_errors=True)


@contextlib.contextmanager
def _timed(module, name: str, seconds: dict):
    """Wraps ``module.name`` so that each call adds its wall time (after a
    device sync) to ``seconds[name]``; restores it on exit."""
    import torch

    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            if DEVICE != "cpu":
                torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def _eval_cli_run(argv: list, timed=()) -> tuple:
    """One ``train.main.main`` run: (records, launch counts, wall seconds,
    seconds in train_one_epoch / evaluate / run_clip_blind_on_split and in
    each further (module, function name) of ``timed``)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import clip_blind
    from refining_clip_via_dinov2_representations_torch.train import evaluate as evaluate_mod
    from refining_clip_via_dinov2_representations_torch.train import main as main_mod

    seconds: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name in ((main_mod, "train_one_epoch"), (evaluate_mod, "evaluate"),
                             (clip_blind, "run_clip_blind_on_split"), *timed):
            stack.enter_context(_timed(module, name, seconds))
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        records = main_mod.main(argv)
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    return records, counts, wall, seconds


def phase_data(work: str) -> dict:
    """mini-Flickr at 224 px under ``work``: 160 train and 40 val images,
    five captions each, DINO-like features of 384 dims; returns its paths."""
    from scripts.mini_flickr import generate

    t0 = time.perf_counter()
    d = generate(os.path.join(work, "data"), n_train=EVAL_TRAIN_IMAGES, n_val=EVAL_VAL_IMAGES,
                 size_px=EVAL_SIZE_PX, dino_dim=DINO_DIM, seed=SEED)
    print(f"data: mini-Flickr {EVAL_TRAIN_IMAGES} + {EVAL_VAL_IMAGES} images at "
          f"{EVAL_SIZE_PX} px in {time.perf_counter() - t0:.2f} s", flush=True)
    return d


def _thesis_argv(d: dict, work: str, name: str) -> list:
    """The thesis protocol's CLI flags on mini-Flickr: the DINO-soft flags of
    ``scripts/dress_rehearsal.py:_common_flags``, ViT-B-16, ``--precision
    amp`` at batch 32, the precomputed features for training and the
    CLIP-blind check on both splits; the run under ``work/name``."""
    return ["--model", EVAL_MODEL, "--train-data", d["train_csv"], "--val-data",
            d["val_csv"], "--dataset-type", "csv", "--batch-size", str(EVAL_BATCH),
            "--precision", "amp", "--lr", "5e-4", "--warmup", "2", "--wd", "0.1",
            "--workers", "8", "--seed", str(SEED), "--use_dino_general", "--lambda_soft",
            "0.5", "--soft_mode", "kl_teacher", "--lambda_weighted", "0.2",
            "--dino_fts_path", d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
            "--dino_fts_path_val", d["dino_feats"], "--dino_index_map_path_val",
            d["dino_index_map"], "--run_clip_blind", "--clip_blind_val_key", "val",
            "--log-every-n-steps", "1", "--logs", work, "--name", name, "--device", DEVICE]


def _thesis_launches(args):
    """(train batches, val batches, CLIP-blind batches of both splits, and
    the expected launches of a run with ``evals`` evaluations: 48 a train
    step, 24 an eval batch, 12 a CLIP-blind batch) of the thesis flags."""
    from refining_clip_via_dinov2_representations_torch.train.data import (
        _clone_args, get_csv_dataset,
    )

    train_batches = get_csv_dataset(args, None, True).dataloader.num_batches
    val_batches = get_csv_dataset(args, None, False).dataloader.num_batches
    blind_info = get_csv_dataset(_clone_args(args, val_data=args.train_data), None, False)
    check(2 * args.clip_blind_max_images >= blind_info.dataloader.num_samples,
          "the CLIP-blind cap would cut the train split")
    blind_batches = val_batches + blind_info.dataloader.num_batches

    def expected(evals: int) -> dict:
        return {"flash_attention_fwd": 0,
                "fused_attention_fwd": 24 * train_batches + 24 * val_batches * evals
                + 12 * blind_batches,
                "fused_attention_bwd": 24 * train_batches}

    return train_batches, val_batches, blind_batches, expected


def phase_train_eval_cli(d: dict, work: str) -> dict:
    """The thesis protocol through ``train.main.main`` on the card: ViT-B-16
    at full width and depth, fp32 compute (``--precision amp``) through the
    split-TF32 fused kernels, on mini-Flickr (``phase_data``), with CSV data and
    the DINO join, pre-train and per-epoch evaluation, checkpoints and the
    CLIP-blind check on both splits; one epoch, then ``--resume latest
    --epochs 2``. Checks every artifact, the resumed step, and the fused
    launches against the loaders' batch counts (48 a train step, 24 an eval
    batch, 12 a CLIP-blind batch); by the profiler, that an eval call runs
    the split-TF32 forward; then the train loader's rate alone and the step's
    alone. Returns the launches of both runs."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model, get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.data import (
        get_csv_dataset, load_dino_index_map,
    )
    from refining_clip_via_dinov2_representations_torch.train.evaluate import evaluate
    from refining_clip_via_dinov2_representations_torch.train.main import build_transforms
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_torch.transform import image_transform_v2

    argv = _thesis_argv(d, work, "run")
    args = parse_args(argv)
    train_batches, val_batches, blind_batches, expected = _thesis_launches(args)

    run = os.path.join(work, "run")
    launches = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    first, counts1, wall1, sec1 = _eval_cli_run(argv + ["--epochs", "1"])
    saved_step = torch.load(os.path.join(run, "checkpoints", "epoch_1.pt"),
                            map_location="cpu", weights_only=True, mmap=True)["step"]
    second, counts2, wall2, sec2 = _eval_cli_run(argv + ["--epochs", "2", "--resume",
                                                         "latest"])
    resumed = second[len(first):]
    for label, counts, want, wall, sec, steps in (
            ("run 1 (--epochs 1)", counts1, expected(2), wall1, sec1, len(first)),
            ("run 2 (--resume latest --epochs 2)", counts2, expected(1), wall2, sec2,
             len(resumed))):
        train_s = sec.get("train_one_epoch", float("nan"))
        print(f"train-eval-cli {label}: {EVAL_MODEL} fp32 batch {EVAL_BATCH}: wall "
              f"{wall:.2f} s; train {train_s:.2f} s for {steps} steps "
              f"({steps * EVAL_BATCH / train_s:.1f} samples/s, data loading included); "
              f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
              f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s [{CARD}]", flush=True)
        print(f"train-eval-cli {label}: launches {counts}, expected {want} ({train_batches} "
              f"train steps x 48, {val_batches} eval batches x 24 per evaluation, "
              f"{blind_batches} CLIP-blind batches x 12)", flush=True)
        check(counts == want, f"train-eval-cli {label} launched {counts}, expected {want}")
        for k in launches:
            launches[k] += counts[k]

    with open(os.path.join(run, "loss_steps.json")) as f:
        records = json.load(f)
    print(f"train-eval-cli: loss_steps.json {len(records)} records, steps "
          f"{records[0]['step']}..{records[-1]['step']}; the resumed run's first step "
          f"{resumed[0]['step'] if resumed else None} after the saved step {saved_step}",
          flush=True)
    check([r["step"] for r in records] == list(range(1, 2 * train_batches + 1))
          and all(math.isfinite(r["total_loss"]) for r in records),
          "loss_steps.json is not one finite record per step of both runs")
    check(records == second, "loss_steps.json differs from the records main returned")
    check(saved_step == train_batches and resumed and resumed[0]["step"] == saved_step + 1,
          "the resumed run did not continue at the saved step")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        results = json.load(f)
    check([e["epoch"] for e in results] == [0, 1, 2],
          f"final_itm_results.json epochs {[e['epoch'] for e in results]}")
    keys = [f"{d}_R@{k}" for d in ("text_to_image", "image_to_text") for k in (1, 5, 10)]
    for e in results:
        m = {r["val_name"]: r["metrics"] for r in e["results"]}.get("val", {})
        print(f"train-eval-cli: epoch {e['epoch']} val "
              f"{ {k: m.get(k) for k in keys + ['clip_val_loss', 'modality_gap']} }",
              flush=True)
        check(all(isinstance(m.get(k), float) and math.isfinite(m[k])
                  for k in keys + ["clip_val_loss"]), f"epoch {e['epoch']}: {m}")
    with open(os.path.join(run, "best_metrics.json")) as f:
        best = json.load(f)
    print(f"train-eval-cli: best epoch {best['epoch']}, retrieval score "
          f"{best['score']:.4f}", flush=True)
    check(best["epoch"] in (1, 2), f"best_metrics.json names epoch {best['epoch']}")
    check(os.path.isfile(os.path.join(run, "itm_scores.csv")), "no itm_scores.csv")
    for split in ("val", "train"):
        path = os.path.join(run, "clip_blind", f"clip_blind_{split}.json")
        check(os.path.isfile(path), f"no {path}")
        with open(path) as f:
            stats = json.load(f)
        rel = {k: round(v["relative_percent"], 4) for k, v in stats["results"].items()}
        print(f"train-eval-cli: clip_blind_{split}.json: {stats['total_pairs']} pairs, "
              f"relative % {rel}", flush=True)
        check(len(stats["results"]) == 3, f"clip_blind_{split}.json thresholds")

    # ---- the fp32 route of one eval call, by the profiler ----
    model, pp = create_model(EVAL_MODEL, os.path.join(run, "checkpoints", "epoch_2.pt"),
                             precision="amp", device=DEVICE)
    info = get_csv_dataset(args, image_transform_v2(pp), False,
                           tokenizer=get_tokenizer(EVAL_MODEL))
    check_fp32_route(lambda: evaluate(model, {"val": info}, 2, args), ("fwd",),
                     "one eval call")
    del model
    # ---- the train loader alone, on the host: the rate the CLI's
    # samples/s would reach if the steps cost nothing ----
    loader = get_csv_dataset(args, build_transforms(args, pp)[0], True,
                             tokenizer=get_tokenizer(EVAL_MODEL),
                             dino_index_map=load_dino_index_map(d["dino_index_map"])
                             ).dataloader
    t0 = time.perf_counter()
    n = sum(len(b["images"]) for b in loader)
    host_s = time.perf_counter() - t0
    print(f"train-eval-cli: the train loader alone ({args.workers} threads: PNG decode, "
          f"random resized crop, tokenizer, DINO rows): {n} samples in {host_s:.2f} s, "
          f"{n / host_s:.1f} samples/s (host clock) [{CARD}]", flush=True)
    # ---- and the fp32 step alone at the CLI's batch, on one cached batch ----
    _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL)
    batch = _train_batch(get_tokenizer(EVAL_MODEL), EVAL_BATCH, DEVICE, model_name=EVAL_MODEL)
    step_ms = host_step_ms(lambda: train_step(state, batch))
    print(f"train-eval-cli: the fp32 DINO-soft step alone at batch {EVAL_BATCH} on one "
          f"cached batch: {step_ms:.3f} ms host clock ({EVAL_BATCH / step_ms * 1e3:.1f} "
          f"samples/s) [{CARD}]", flush=True)
    del state, train_step
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return launches


def _set_attn_impl(model, impl: str) -> None:
    """Every attention layer of ``model`` (CLIP or DINOv2) to ``impl``."""
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def _teacher_pixels(n: int, size: int = 224, seed: int = SEED + 20):
    """Seeded ImageNet-normalised-like NCHW pixels on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, size, size, generator=g).to(DEVICE)


def _teacher_vs_plain(model, x, launches_expected: int, what: str, min_cos: float) -> int:
    """One ``model(x)`` through ``"auto"`` against ``"xla"`` on the same
    weights: the ``"auto"`` call's launches (``launches_expected`` fused
    forward, no backward, no flash), finite CLS features [B, hidden] and the
    worst CLS cosine. Returns the fused forward launches."""
    import torch

    _set_attn_impl(model, "auto")
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    with torch.no_grad():
        got = model(x).float()
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    counts = _read_counts()
    _set_attn_impl(model, "xla")
    with torch.no_grad():
        want = model(x).float()
    _set_attn_impl(model, "auto")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    print(f"teacher {what}: features {tuple(got.shape)}, launches {counts} (expected fused "
          f"forward {launches_expected}, no backward); CLS cosine vs \"xla\" min {cos:.8f} "
          f"(need >= {min_cos})", flush=True)
    check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": launches_expected,
                     "fused_attention_bwd": 0}, f"teacher {what} launched {counts}")
    check(tuple(got.shape) == (x.shape[0], model.cfg.hidden_size)
          and bool(torch.isfinite(got).all()) and cos >= min_cos,
          f"teacher {what} disagrees with plain attention")
    return counts["fused_attention_fwd"]


def phase_teacher(work: str):
    """The DINOv2 teacher on the card: a seeded dinov2-small directory at the
    published config, loaded by ``load_dinov2_model``, fp32 and bf16 through
    the fused kernel against plain attention, with its time per batch; one
    fp32 forward of dinov2-large and dinov2-giant. Returns (teacher
    directory, fused forward launches of the ``"auto"`` calls)."""
    import dataclasses

    import torch

    from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
        Dinov2, Dinov2Cfg, dinov2_cfg_from_name, load_dinov2_model, save_hf_checkpoint,
    )

    t0 = time.perf_counter()
    path = save_hf_checkpoint(Dinov2(Dinov2Cfg(**DINOV2_SMALL)).init_weights(SEED),
                              os.path.join(work, "dinov2-small-seeded"))
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    print(f"teacher: seeded dinov2-small written to {path} in {time.perf_counter() - t0:.2f} s "
          f"(hidden {cfg['hidden_size']}, {cfg['num_hidden_layers']} layers, "
          f"{cfg['num_attention_heads']} heads, patch {cfg['patch_size']}, image_size "
          f"{cfg['image_size']}, layerscale {cfg['layerscale_value']}, LN eps "
          f"{cfg['layer_norm_eps']})", flush=True)
    x = _teacher_pixels(TEACHER_BATCH)
    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = load_dinov2_model(path, dtype=dtype, device=DEVICE, attn_impl="auto")
        check(model.embeddings.position_embeddings.shape[1] == 37 * 37 + 1,
              "dinov2-small's position table must hold 37 x 37 + 1 rows")
        launches += _teacher_vs_plain(model, x, 12, f"dinov2-small {name} batch "
                                      f"{TEACHER_BATCH} at 224 px", TEACHER_MIN_COS[name])
        ms = {}
        for impl in ("auto", "xla"):
            _set_attn_impl(model, impl)
            with torch.no_grad():
                ms[impl] = time_ms(lambda: model(x), iters=10)
        print(f"time teacher dinov2-small {name} batch {TEACHER_BATCH} at 224 px: "
              f"{ms['auto']:.3f} ms a batch through the fused kernel, {ms['xla']:.3f} ms "
              f"through plain attention (CUDA events) [{CARD}]", flush=True)
        del model
    for name in ("facebook/dinov2-large", "facebook/dinov2-giant"):
        cfg = dataclasses.replace(dinov2_cfg_from_name(name), native_image_size=518)
        model = Dinov2(cfg, attn_impl="auto").to(DEVICE).init_weights(SEED).eval()
        launches += _teacher_vs_plain(
            model, x[:TEACHER_BIG_BATCH], cfg.layers,
            f"{name.split('/')[-1]} float32 batch {TEACHER_BIG_BATCH} ({cfg.layers} x "
            f"{cfg.hidden_size}, {cfg.heads} heads, "
            f"{'SwiGLU' if cfg.use_swiglu_ffn else 'GELU'})", TEACHER_MIN_COS["float32"])
        del model
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    return path, launches


def phase_extract(d: dict, teacher: str, work: str):
    """The port's extractor (``eval/extract_dino_features.py``) on both
    mini-Flickr CSVs with the seeded teacher, fp32 on the card. Checks rows,
    the map, that ``DinoFeatureStore`` and ``CsvDataset`` accept them, and
    12 launches a batch of 64; returns ({split: (features, map)}, launches)."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.eval.extract_dino_features import (
        main as extract_main,
    )
    from refining_clip_via_dinov2_representations_torch.train.data import (
        CsvDataset, DinoFeatureStore, load_dino_index_map,
    )

    from refining_clip_via_dinov2_representations_torch.models import get_model_config

    # the live run's image size (224 for ViT-B-16), so the two see one crop
    size = get_model_config(EVAL_MODEL)["vision_cfg"]["image_size"]
    out, launches = {}, 0
    for split, csv, n in (("train", d["train_csv"], EVAL_TRAIN_IMAGES),
                          ("val", d["val_csv"], EVAL_VAL_IMAGES)):
        feats = os.path.join(work, f"extract_{split}.npy")
        index = os.path.join(work, f"extract_{split}.json")
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        extract_main(["--csv", csv, "--dino-model", teacher, "--image-size", str(size),
                      "--batch-size", "64", "--out-feats", feats, "--out-map", index]
                     + (["--force-cpu"] if DEVICE == "cpu" else []))
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        store, mapping = DinoFeatureStore(feats), load_dino_index_map(index)
        batches = math.ceil(n / 64)
        print(f"extract {split}: {store.shape} rows from {os.path.basename(csv)} in {wall:.2f} s "
              f"({n / wall:.1f} images/s, teacher load and PNG decode included), "
              f"{len(mapping)} map entries; launches {counts} (expected fused forward "
              f"{12 * batches}) [{CARD}]", flush=True)
        check(store.shape == (n, 384) and store.features.dtype == np.float32
              and bool(np.isfinite(store.features).all()), f"extract {split} rows {store.shape}")
        check(sorted(mapping.values()) == list(range(n)), f"extract {split}: the map")
        check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": 12 * batches,
                         "fused_attention_bwd": 0}, f"extract {split} launched {counts}")
        ds = CsvDataset(csv, lambda img: img, "filepath", "title", dino_index_map=mapping)
        check(len(ds) == 5 * n, f"CsvDataset read {len(ds)} rows of {csv}")
        out[split] = (np.asarray(store.features), mapping)
        launches += counts["fused_attention_fwd"]
    return out, launches


@contextlib.contextmanager
def _teacher_watch(record: list, captured: list):
    """Wraps ``LiveDinoTeacher.extract`` to record CUDA events around each
    call (``record``: (where, start, end), where "train" or "clip-blind")
    and ``clip_blind.encode_clip_and_dino_images`` to keep each pass's
    L2-normalised teacher rows and paths (``captured``, in call order)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import clip_blind
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )

    extract, encode = LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images
    where = ["train"]

    def timed(self, images):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = extract(self, images)
        end.record()
        record.append((where[0], start, end))
        return out

    def kept(model, teacher, loader, max_images=None):
        where[0] = "clip-blind"
        try:
            clip_z, dino_z, paths = encode(model, teacher, loader, max_images)
        finally:
            where[0] = "train"
        captured.append((dino_z, paths))
        return clip_z, dino_z, paths

    LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images = timed, kept
    try:
        yield
    finally:
        LiveDinoTeacher.extract, clip_blind.encode_clip_and_dino_images = extract, encode


def phase_train_live_cli(d: dict, teacher: str, work: str, extracted: dict) -> dict:
    """The live-teacher protocol through ``train.main.main``: ViT-B-16 fp32
    (``--precision amp``), batch 32, one epoch on mini-Flickr with pre-train
    and epoch evaluation and ``--run_clip_blind``; the seeded dinov2-small
    from ``--dino_model_name``, no ``--dino_fts_path``. Checks the soft loss,
    both CLIP-blind files, the launches, a checkpoint without the teacher,
    and the live check's val teacher rows against the extracted ones; times
    the teacher; then the live step alone. Returns the launch counts."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.data import (
        _clone_args, get_csv_dataset,
    )
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    argv = ["--model", EVAL_MODEL, "--train-data", d["train_csv"], "--val-data", d["val_csv"],
            "--dataset-type", "csv", "--batch-size", str(LIVE_BATCH), "--precision", "amp",
            "--lr", "5e-4", "--warmup", "2", "--wd", "0.1", "--workers", "8", "--seed",
            str(SEED), "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode",
            "kl_teacher", "--lambda_weighted", "0.2", "--dino_model_name", teacher,
            "--run_clip_blind", "--clip_blind_val_key", "val", "--log-every-n-steps", "1",
            "--logs", work, "--name", "live", "--device", DEVICE, "--epochs", "1"]
    args = parse_args(argv)
    train_batches = get_csv_dataset(args, None, True).dataloader.num_batches
    val_batches = get_csv_dataset(args, None, False).dataloader.num_batches
    blind = get_csv_dataset(_clone_args(args, val_data=args.train_data), None, False).dataloader
    check(2 * args.clip_blind_max_images >= blind.num_samples,
          "the CLIP-blind cap would cut the train split")
    blind_batches = val_batches + blind.num_batches
    want = {"flash_attention_fwd": 0,
            "fused_attention_fwd": 36 * train_batches + 24 * val_batches * 2 + 24 * blind_batches,
            "fused_attention_bwd": 24 * train_batches}

    record, captured = [], []
    with _teacher_watch(record, captured):
        records, counts, wall, sec = _eval_cli_run(argv)
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    teacher_s = {w: sum(s.elapsed_time(e) for x, s, e in record if x == w) / 1e3
                 for w in ("train", "clip-blind")}
    calls = {w: sum(x == w for x, _, _ in record) for w in ("train", "clip-blind")}
    run = os.path.join(work, "live")
    train_s = sec.get("train_one_epoch", float("nan"))
    soft = [r.get("soft_loss", 0.0) for r in records]
    print(f"train-live-cli: {EVAL_MODEL} fp32 batch {LIVE_BATCH}, live dinov2-small: wall "
          f"{wall:.2f} s; train {train_s:.2f} s for {len(records)} steps "
          f"({len(records) * LIVE_BATCH / train_s:.1f} samples/s, data loading included); "
          f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
          f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s; teacher (CUDA events around "
          f"extract) {teacher_s['train']:.3f} s in {calls['train']} train calls, "
          f"{teacher_s['clip-blind']:.3f} s in {calls['clip-blind']} CLIP-blind calls "
          f"[{CARD}]", flush=True)
    print(f"train-live-cli: launches {counts}, expected {want} ({train_batches} train steps x "
          f"(36 forward + 24 backward), {val_batches} eval batches x 24 in 2 evaluations, "
          f"{blind_batches} CLIP-blind batches x 24); soft_loss {soft[0]:.6f} .. "
          f"{soft[-1]:.6f}", flush=True)
    check(len(records) == train_batches and all(math.isfinite(r["total_loss"]) for r in records),
          "train-live-cli: not one finite record per step")
    check(all(x > 0 for x in soft), f"train-live-cli: soft_loss {soft}")
    check(counts == want, f"train-live-cli launched {counts}, expected {want}")
    check(calls == {"train": train_batches, "clip-blind": blind_batches},
          f"teacher calls {calls}")
    for split in ("val", "train"):
        path = os.path.join(run, "clip_blind", f"clip_blind_{split}.json")
        check(os.path.isfile(path), f"no {path}")
        with open(path) as f:
            stats = json.load(f)
        rel = {k: round(v["relative_percent"], 4) for k, v in stats["results"].items()}
        print(f"train-live-cli: clip_blind_{split}.json: {stats['total_pairs']} pairs, "
              f"relative % {rel}", flush=True)
        check(len(stats["results"]) == 3, f"clip_blind_{split}.json thresholds")
    saved = torch.load(os.path.join(run, "checkpoints", "epoch_1.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    check(not any(k.startswith(("embeddings.", "encoder.")) for k in saved["state_dict"])
          and saved["dino_head"]["fc2.weight"].shape[0] == 384,
          "the checkpoint holds teacher weights or a head of the wrong width")
    del saved

    # the live check's val teacher rows against the extractor's, same images
    check(len(captured) == 2, f"captured {len(captured)} CLIP-blind passes")
    live_z, live_paths = captured[0]
    feats, mapping = extracted["val"]
    ext = feats[[mapping[p] for p in live_paths]].astype(np.float64)
    ext /= np.linalg.norm(ext, axis=-1, keepdims=True)
    cos = (ext * live_z.astype(np.float64)).sum(-1)
    print(f"train-live-cli: extracted vs live teacher rows of {len(live_paths)} val images "
          f"(same paths): cosine min {cos.min():.8f} (need >= 0.9999)", flush=True)
    check(len(live_paths) == 5 * EVAL_VAL_IMAGES and cos.min() >= 0.9999,
          "extracted and live teacher rows disagree")

    # ---- the live fp32 step alone at batch 32 on one cached batch, beside
    # the step on cached teacher features and the teacher alone ----
    live_teacher = LiveDinoTeacher.from_pretrained(teacher, device=DEVICE)
    batch = _train_batch(get_tokenizer(EVAL_MODEL), LIVE_BATCH, DEVICE, model_name=EVAL_MODEL)
    times = {}
    for label, tch in (("live teacher", live_teacher), ("cached features", None)):
        _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL,
                                                 dino_teacher=tch)
        b = {k: v for k, v in batch.items() if tch is None or k != "dino_features"}
        times[label] = host_step_ms(lambda: train_step(state, b))
        del state, train_step
    alone = time_ms(lambda: live_teacher.extract(batch["images"]), iters=10)
    print(f"train-live-cli: the fp32 DINO-soft step alone at batch {LIVE_BATCH} on one cached "
          f"batch: {times['live teacher']:.3f} ms host clock with the live teacher "
          f"({LIVE_BATCH / times['live teacher'] * 1e3:.1f} samples/s), "
          f"{times['cached features']:.3f} ms on cached features; the teacher alone "
          f"{alone:.3f} ms (CUDA events), {alone / times['live teacher']:.1%} of the live step "
          f"[{CARD}]", flush=True)
    del live_teacher
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return counts


def _exactly(model, want: dict) -> bool:
    """Every tensor of ``model``'s state dict equals ``want``'s (on the CPU,
    reshaped to the model's shape, cast to its dtype)."""
    import torch

    return all(torch.equal(v.cpu(), want[k].reshape(v.shape).to(v.dtype))
               for k, v in model.state_dict().items())


def _kernel_vs_plain(model, inputs: dict, what: str, min_cos: float = MIN_COSINE) -> dict:
    """``model``'s features of ``inputs`` ({"image": NHWC pixels, "text":
    ids} on the card) through its attention impl against ``"xla"``: the
    launches of the first pass and the worst cosine, checked."""
    import torch

    impl = next(m.attn_impl for m in model.modules() if hasattr(m, "attn_impl"))
    fns = {"image": model.encode_image, "text": model.encode_text}
    # ---- the main path: counts at 0 just before, read just after ----
    _zero_counts()
    with torch.no_grad():
        got = {k: fns[k](x, normalize=True).float() for k, x in inputs.items()}
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    counts = _read_counts()
    _set_attn_impl(model, "xla")
    with torch.no_grad():
        want = {k: fns[k](x, normalize=True).float() for k, x in inputs.items()}
    _set_attn_impl(model, impl)
    cos = {k: torch.nn.functional.cosine_similarity(got[k].double(), want[k].double(),
                                                    dim=-1).min().item() for k in inputs}
    shapes = {k: tuple(v.shape) for k, v in got.items()}
    print(f"pretrained {what}: features {shapes} through {impl!r}, launches {counts}; cosine "
          f"vs plain attention min {cos} (need >= {min_cos})", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in got.values())
          and min(cos.values()) >= min_cos, f"pretrained {what} disagrees with plain attention")
    return counts


def phase_pretrained(work: str) -> dict:
    """Pretrained checkpoints at ViT-B-16's full width (phase 13): the
    seeded weights written in the hub-cache layout of the ``openai`` tag
    and as an fp16 OpenAI TorchScript archive, loaded three ways and checked
    exactly; the archive's features through the kernel against plain
    attention; the 224-px checkpoint at 384 px through the fused kernel and
    through flash. Returns the cache, the archive and the launches."""
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models.openai import (
        load_openai_model, save_openai_archive,
    )
    from refining_clip_via_dinov2_representations_torch.models.pretrained import (
        get_pretrained_cfg,
    )

    t0 = time.perf_counter()
    src, _ = create_model(EVAL_MODEL, device=DEVICE, seed=SEED + 30)
    sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    del src
    hub_id = get_pretrained_cfg(EVAL_MODEL, "openai")["hf_hub"].rstrip("/")
    cache = os.path.join(work, "hub")
    repo = os.path.join(cache, "models--" + hub_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", HUB_REV)
    os.makedirs(os.path.join(repo, "refs"))
    os.makedirs(snap)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REV)
    torch.save(sd, os.path.join(snap, "open_clip_pytorch_model.bin"))
    archive = save_openai_archive(sd, os.path.join(work, f"{EVAL_MODEL}-openai-seeded.pt"))
    print(f"pretrained: seeded {EVAL_MODEL} written in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.getsize(os.path.join(snap, 'open_clip_pytorch_model.bin')) / 2**20:.1f} MiB "
          f"open_clip layout in the hub cache of {hub_id}, {os.path.getsize(archive) / 2**20:.1f}"
          f" MiB fp16 TorchScript archive", flush=True)
    half = {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}

    t0 = time.perf_counter()
    tagged, pp = create_model(EVAL_MODEL, pretrained="openai", cache_dir=cache, device=DEVICE)
    tag_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    openai = load_openai_model(archive, device=DEVICE)
    archive_s = time.perf_counter() - t0
    by_path, _ = create_model(EVAL_MODEL, pretrained=archive, device=DEVICE)
    exact = {"pretrained='openai' (hub cache)": _exactly(tagged, sd),
             "load_openai_model(archive)": _exactly(openai, half),
             "pretrained=<archive> (--pretrained)": _exactly(by_path, half)}
    act = openai.visual.transformer.resblocks[0].mlp.act.__name__
    print(f"pretrained: loads {tag_s:.2f} s from the hub cache, {archive_s:.2f} s from the "
          f"archive; the written values exactly: {exact}; load_openai_model's activation "
          f"{act}; the tag's preprocess: mean {pp.mean}, interpolation {pp.interpolation}, "
          f"resize {pp.resize_mode}", flush=True)
    check(all(exact.values()), f"pretrained weights differ from the written ones: {exact}")
    check(act == "quick_gelu", "load_openai_model must build QuickGELU")
    del tagged, by_path

    rng = np.random.default_rng(SEED + 31)
    size = openai.visual.image_size[0]
    x = torch.from_numpy(rng.normal(size=(8, size, size, 3)).astype(np.float32)).to(DEVICE)
    ids = torch.from_numpy(get_tokenizer(EVAL_MODEL)(
        [f"a photo of pretrained item {i}" for i in range(8)])).long().to(DEVICE)
    launches = {"fused_attention_fwd": 0, "flash_attention_fwd": 0}
    counts = _kernel_vs_plain(openai, {"image": x, "text": ids}, "archive fp32 batch 8")
    check(counts == {"flash_attention_fwd": 0, "fused_attention_fwd": 24,
                     "fused_attention_bwd": 0}, f"the archive's towers launched {counts}")
    launches["fused_attention_fwd"] += counts["fused_attention_fwd"]
    del openai

    big, _ = create_model(EVAL_MODEL, pretrained="openai", cache_dir=cache, device=DEVICE,
                          force_image_size=384)
    pos = big.visual.positional_embedding
    tokens = (384 // big.visual.patch_size[0]) ** 2 + 1  # 577 at patch 16
    check(tuple(pos.shape) == (tokens, sd["visual.positional_embedding"].shape[1])
          and torch.equal(pos[0].cpu(), sd["visual.positional_embedding"][0]),
          f"the 384-px table {tuple(pos.shape)} is not the resized {size}-px one")
    x384 = torch.from_numpy(rng.normal(size=(4, 384, 384, 3)).astype(np.float32)).to(DEVICE)
    heads = big.visual.transformer.resblocks[0].attn.num_heads
    for impl, kernel in (("auto", "fused_attention_fwd"), ("flash", "flash_attention_fwd")):
        _set_attn_impl(big, impl)
        counts = _kernel_vs_plain(big, {"image": x384},
                                  f"384 px [4,{heads},{tokens},64] {impl}")
        check(counts[kernel] == 12 and sum(counts.values()) == 12,
              f"the 384-px tower through {impl!r} launched {counts}")
        launches[kernel] += counts[kernel]
    del big
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"cache": cache, "archive": archive, "launches": launches}


def phase_zero_shot(d: dict, pre: dict, work: str) -> dict:
    """Config 1 through ``train.main.main`` (phase 14): zero-shot Flickr
    retrieval and zero-shot ImageNet from ``--pretrained openai``, no train
    data, on a procedural ImageNet-V2-style folder. Checks the metrics and
    the launches (12 a text call of 10 classes x 80 templates, 12 an image
    batch, 24 a val batch); times the classifier; holds the first 10
    classes' classifier to plain attention's. Returns the launches and the
    val metrics."""
    import math

    import numpy as np
    import torch
    from PIL import Image

    from refining_clip_via_dinov2_representations_torch.eval._imagenet_metadata import (
        IMAGENET_CLASSNAMES, OPENAI_IMAGENET_TEMPLATES,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.train import zero_shot
    from refining_clip_via_dinov2_representations_torch.train.data import get_csv_dataset
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    folder = os.path.join(work, "imagenet-v2")
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    for c in range(ZS_IMAGES):
        os.makedirs(os.path.join(folder, str(c)))
        Image.fromarray(rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)).save(
            os.path.join(folder, str(c), "0.png"))
    print(f"zero-shot: {ZS_IMAGES} class folders of one 96-px image each in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    argv = ["--model", EVAL_MODEL, "--pretrained", "openai", "--cache-dir", pre["cache"],
            "--val-data", d["val_csv"], "--dataset-type", "csv", "--imagenet-val", folder,
            "--batch-size", str(EVAL_BATCH), "--precision", "amp", "--workers", "8",
            "--seed", str(SEED), "--logs", work, "--name", "zero-shot", "--device", DEVICE]
    val_batches = get_csv_dataset(parse_args(argv), None, False).dataloader.num_batches
    text_calls = math.ceil(len(IMAGENET_CLASSNAMES) / ZS_CLASSES_PER_CALL)
    image_batches = math.ceil(ZS_IMAGES / EVAL_BATCH)
    want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
            "fused_attention_fwd": 12 * (text_calls + image_batches) + 24 * val_batches}
    results, counts, wall, sec = _eval_cli_run(argv, timed=(
        (zero_shot, "build_zero_shot_classifier"), (zero_shot, "run")))
    (entry,) = results
    m = entry["metrics"]
    keys = [f"{k}_R@{r}" for k in ("text_to_image", "image_to_text") for r in (1, 5, 10)]
    zs = {k: m.get(k) for k in ("imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5")}
    print(f"zero-shot Config 1: {EVAL_MODEL} fp32 (--precision amp), eval only: wall "
          f"{wall:.2f} s; classifier {sec.get('build_zero_shot_classifier', 0.0):.2f} s "
          f"({len(IMAGENET_CLASSNAMES)} classes x {len(OPENAI_IMAGENET_TEMPLATES)} templates in "
          f"{text_calls} text calls, tokenizer included); ImageNet images "
          f"{sec.get('run', 0.0):.2f} s ({ZS_IMAGES} images, {image_batches} batches, decode "
          f"included); evaluate {sec.get('evaluate', 0.0):.2f} s [{CARD}]", flush=True)
    print(f"zero-shot Config 1: val retrieval { {k: m.get(k) for k in keys} }, clip_val_loss "
          f"{m.get('clip_val_loss')}; ImageNet {zs}; launches {counts}, expected {want}",
          flush=True)
    check(counts == want, f"zero-shot launched {counts}, expected {want}")
    check(all(isinstance(v, float) and 0.0 <= v <= 1.0 for v in zs.values())
          and all(math.isfinite(m.get(k, float("nan"))) for k in keys + ["clip_val_loss"]),
          f"zero-shot metrics {m}")

    model, _ = create_model(EVAL_MODEL, "openai", precision="amp", cache_dir=pre["cache"],
                            device=DEVICE)
    tok = get_tokenizer(EVAL_MODEL)
    first = IMAGENET_CLASSNAMES[:ZS_CLASSES_PER_CALL]
    got = zero_shot.build_zero_shot_classifier(model, tok, first, OPENAI_IMAGENET_TEMPLATES)
    _set_attn_impl(model, "xla")
    plain = zero_shot.build_zero_shot_classifier(model, tok, first, OPENAI_IMAGENET_TEMPLATES)
    cos = torch.nn.functional.cosine_similarity(got.double(), plain.double(), dim=0).min().item()
    print(f"zero-shot: the classifier of the first {len(first)} classes {tuple(got.shape)} "
          f"through the kernel vs plain attention: weight cosine min {cos:.8f} (need >= "
          f"{MIN_COSINE})", flush=True)
    check(cos >= MIN_COSINE, "the zero-shot classifier disagrees with plain attention")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"counts": counts, "metrics": m}


def phase_finetune(d: dict, pre: dict, zs: dict, work: str) -> dict:
    """Config 2 (phase 15): the thesis flags with ``--pretrained openai`` for
    one epoch. Checks the launches, that the pre-train evaluation equals
    Config 1's retrieval on the same weights, every epoch's metrics; times
    the run and the fp32 step alone from the pretrained weights. Returns
    the launches and the checkpoint."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args

    argv = _thesis_argv(d, work, "finetune") + ["--pretrained", "openai", "--cache-dir",
                                                pre["cache"], "--epochs", "1"]
    train_batches, _, _, expected = _thesis_launches(parse_args(argv))
    want = expected(2)
    records, counts, wall, sec = _eval_cli_run(argv)
    run = os.path.join(work, "finetune")
    train_s = sec.get("train_one_epoch", float("nan"))
    print(f"finetune Config 2: {EVAL_MODEL} from the pretrained weights, fp32 batch "
          f"{EVAL_BATCH}: wall {wall:.2f} s; train {train_s:.2f} s for {len(records)} steps "
          f"({len(records) * EVAL_BATCH / train_s:.1f} samples/s, data loading included); "
          f"evaluate {sec.get('evaluate', 0.0):.2f} s; CLIP-blind "
          f"{sec.get('run_clip_blind_on_split', 0.0):.2f} s; launches {counts}, expected "
          f"{want} [{CARD}]", flush=True)
    check(counts == want, f"finetune launched {counts}, expected {want}")
    check(len(records) == train_batches and all(math.isfinite(r["total_loss"]) for r in records),
          "finetune: not one finite record per step")
    with open(os.path.join(run, "final_itm_results.json")) as f:
        results = json.load(f)
    check([e["epoch"] for e in results] == [0, 1], f"finetune epochs {results}")
    keys = [f"{k}_R@{r}" for k in ("text_to_image", "image_to_text") for r in (1, 5, 10)]
    for e in results:
        m = {r["val_name"]: r["metrics"] for r in e["results"]}["val"]
        print(f"finetune: epoch {e['epoch']} val { {k: m.get(k) for k in keys} }, "
              f"clip_val_loss {m.get('clip_val_loss')}", flush=True)
        check(all(math.isfinite(m[k]) for k in keys + ["clip_val_loss"]), f"epoch {e}: {m}")
    m0 = {r["val_name"]: r["metrics"] for r in results[0]["results"]}["val"]
    same = all(m0[k] == zs["metrics"][k] for k in keys) and abs(
        m0["clip_val_loss"] - zs["metrics"]["clip_val_loss"]) <= 1e-5
    print(f"finetune: the pre-train evaluation equals Config 1's on the same weights: {same}",
          flush=True)
    check(same, "the fine-tune did not start from the pretrained weights")

    _, _, state, train_step, _ = _dino_setup("fp32", "auto", model_name=EVAL_MODEL,
                                             pretrained="openai", cache_dir=pre["cache"])
    batch = _train_batch(get_tokenizer(EVAL_MODEL), EVAL_BATCH, DEVICE, model_name=EVAL_MODEL)
    step_ms = host_step_ms(lambda: train_step(state, batch))
    print(f"finetune: the fp32 DINO-soft step alone from the pretrained weights at batch "
          f"{EVAL_BATCH} on one cached batch: {step_ms:.3f} ms host clock "
          f"({EVAL_BATCH / step_ms * 1e3:.1f} samples/s) [{CARD}]", flush=True)
    del state, train_step
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"counts": counts, "checkpoint": os.path.join(run, "checkpoints", "epoch_1.pt")}


def phase_offline(d: dict, pre: dict, ft: dict, work: str) -> dict:
    """The offline acceptance suite (phase 16): ``run_all_evals`` on both
    mini-Flickr CSVs from the fine-tune's checkpoint (bf16 extraction, 12
    launches a batch of 256 rows), ``clip_blinds_cli`` on the val CSV with
    mini-Flickr's DINO features and map (12 launches a batch of 128
    images); results and each stage's seconds; the extracted val features
    against plain attention's (cosine >= 0.999). Returns the launches."""
    import math

    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.eval import (
        clip_blinds_cli, offline, run_all_evals,
    )
    from refining_clip_via_dinov2_representations_torch.eval._batching import (
        encode_images_padded,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, load_checkpoint,
    )
    from refining_clip_via_dinov2_representations_torch.train.data import _read_csv
    from refining_clip_via_dinov2_representations_torch.transform import image_transform_v2

    cpu = ["--force-cpu"] if DEVICE == "cpu" else []
    rows = {s: len(_read_csv(d[f"{s}_csv"], ",", ("filepath",))["filepath"])
            for s in ("train", "val")}
    out = os.path.join(work, "evals")
    sec: dict = {}
    with contextlib.ExitStack() as stack:
        for name in ("extract_features", "knn_top1", "eval_geometry", "linear_probe"):
            stack.enter_context(_timed(offline, name, sec))
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        t0 = time.perf_counter()
        results = run_all_evals.main(
            ["--train-csv", d["train_csv"], "--val-csv", d["val_csv"], "--model", EVAL_MODEL,
             "--pretrained", "openai", "--cache-dir", pre["cache"], "--checkpoint",
             ft["checkpoint"], "--out-dir", out, "--batch-size", str(EXTRACT_BATCH)] + cpu)
        if DEVICE != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
            "fused_attention_fwd": 12 * sum(math.ceil(n / EXTRACT_BATCH) for n in rows.values())}
    print(f"offline run_all_evals: {EVAL_MODEL} bf16 from {os.path.basename(ft['checkpoint'])}: "
          f"{results}; wall {wall:.2f} s: extract {sec.get('extract_features', 0.0):.2f} s "
          f"({rows['train']} + {rows['val']} rows, model builds and decode included), kNN "
          f"{sec.get('knn_top1', 0.0):.3f} s, geometry {sec.get('eval_geometry', 0.0):.3f} s, "
          f"probe {sec.get('linear_probe', 0.0):.3f} s; launches {counts}, expected {want} "
          f"[{CARD}]", flush=True)
    check(counts == want, f"run_all_evals launched {counts}, expected {want}")
    check(set(results) == {"knn_top1", "linear_probe_top1", "uniformity", "pc1", "pc10",
                           "pc100"} and all(math.isfinite(v) for v in results.values()),
          f"all_evals.json {results}")
    with open(os.path.join(out, "all_evals.json")) as f:
        check(json.load(f) == results, "all_evals.json differs from the returned results")

    blind_out = os.path.join(work, "clip-blinds")
    images = len(dict.fromkeys(_read_csv(d["val_csv"], ",", ("filepath",))["filepath"]))
    _zero_counts()
    t0 = time.perf_counter()
    stats = clip_blinds_cli.main(
        ["--csv", d["val_csv"], "--model", EVAL_MODEL, "--pretrained", "openai", "--cache-dir",
         pre["cache"], "--checkpoint", ft["checkpoint"], "--dino-feats", d["dino_feats"],
         "--dino-index-map", d["dino_index_map"], "--out-dir", blind_out, "--save-pairs"] + cpu)
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    blind_s = time.perf_counter() - t0
    blind_counts = _read_counts()
    blind_want = {"flash_attention_fwd": 0, "fused_attention_bwd": 0,
                  "fused_attention_fwd": 12 * math.ceil(images / 128)}
    print(f"offline clip_blinds_cli: {images} val images, {stats['total_pairs']} pairs, "
          f"{stats['results']} in {blind_s:.2f} s; launches {blind_counts}, expected "
          f"{blind_want} [{CARD}]", flush=True)
    check(blind_counts == blind_want, f"clip_blinds_cli launched {blind_counts}")
    check(stats["total_pairs"] == images * (images - 1) // 2
          and all(os.path.isfile(os.path.join(blind_out, f))
                  for f in ("summary.txt", "summary.json", "pairs.csv")),
          "clip_blinds_cli did not write its summaries")

    # the extracted val rows against plain attention's on the same weights
    model, pp = create_model(EVAL_MODEL, "openai", precision="bf16", force_quick_gelu=True,
                             cache_dir=pre["cache"], device=DEVICE, attn_impl="xla")
    load_checkpoint(model, ft["checkpoint"], strict=False)

    def encode(batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model.encode_image(torch.from_numpy(batch).to(DEVICE),
                                      normalize=True).float().cpu().numpy()

    plain = encode_images_padded(encode, _read_csv(d["val_csv"], ",", ("filepath",))["filepath"],
                                 image_transform_v2(pp), EXTRACT_BATCH)
    got = offline.load_feats(os.path.join(out, "val_feats.npz"))[0].astype(np.float64)
    cos = (got * plain).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(plain, axis=-1))
    print(f"offline: extracted val features {got.shape} (bf16, kernel) vs plain attention: "
          f"cosine min {cos.min():.8f} (need >= {TEACHER_MIN_COS['bfloat16']})", flush=True)
    check(cos.min() >= TEACHER_MIN_COS["bfloat16"], "the extracted features disagree")
    del model
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    return {"fused_attention_fwd": counts["fused_attention_fwd"]
            + blind_counts["fused_attention_fwd"]}


def attention_bwd_work(b, h, l, d, causal, dtype_name):
    """(FLOPs, bytes) of the attention backward: 10 pairs D FLOPs per head
    (S recomputed, dV, dP, dQ, dK); 8 L D elements per head moved (q, k, v,
    o, dO in; dq, dk, dv out)."""
    elem = 4 if dtype_name == "float32" else 2
    pairs = l * (l + 1) // 2 if causal else l * l
    return 10.0 * b * h * pairs * d, 8.0 * b * h * l * d * elem


def phase_bwd_times(dtype_name: str) -> dict:
    """Backward kernel, its plain version and SDPA forward+backward minus
    its forward (yardstick only) at ``BWD_TIMED``."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_bwd_reference, fused_attention_fwd,
    )

    dtype = getattr(torch, dtype_name)
    rows = {}
    for b, h, l, d, causal in BWD_TIMED:
        q, k, v = _qkv(b, h, l, d, dtype, seed=200)
        do = _qkv(b, h, l, d, dtype, seed=201)[0]
        scale = d ** -0.5
        o = fused_attention_fwd(q, k, v, scale, causal)
        ms = time_ms(lambda: fused_attention_bwd(q, k, v, o, do, scale, causal), iters=20)
        plain = time_ms(lambda: fused_attention_bwd_reference(q, k, v, o, do, scale, causal),
                        iters=20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=scale)
            torch.autograd.grad(out, (qg, kg, vg), do)

        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale), iters=20)
        lib = time_ms(sdpa_fwd_bwd, iters=20) - sdpa_fwd
        work = attention_bwd_work(b, h, l, d, causal, dtype_name)
        bound, by = _bound(*work, dtype_name)
        rows[(b, h, l, d, causal)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                          bound_ms=bound, bound_by=by)
        scalar = SCALAR_BWD_MS.get((dtype_name, (b, h, l, d, causal)))
        print(f"time fused_attention_bwd {dtype_name} [{b},{h},{l},{d}] causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa fwd+bwd minus fwd {lib:.4f} ms, "
              f"bound {bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound"
              f"{'' if scalar is None else '; ' + _beside_scalar(scalar, ms)} [{CARD}]",
              flush=True)
    return rows


def _flash_fp64(q, k, v, scale, causal):
    """The flash kernel's function in float64 with its rounding points: Q
    pre-scaled in the input dtype, P rounded to V's dtype for the PV product,
    normalised after it. Its distance from the kernel is the kernel's own
    rounding error."""
    import torch

    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).double()
    s = torch.matmul(qs, k.double().transpose(-1, -2))
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype).double(), v.double()) / p.sum(dim=-1, keepdim=True)


def phase_kernels_flash() -> dict:
    """The flash kernel vs its plain version and float64 on the card;
    returns {dtype: max_abs_err vs plain}."""
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention, flash_attention_fwd, flash_attention_reference,
    )

    worst, worst_case = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (b, h, lq, lk, d, causal) in enumerate(FLASH_CASES):
            q, k, v = _qkv(b, h, lq, d, dtype, seed=300 + i, lk=lk)
            scale = d ** -0.5
            got = flash_attention_fwd(q, k, v, scale, causal)
            want = flash_attention_reference(q, k, v, scale, causal)
            exact = _flash_fp64(q, k, v, scale, causal)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"flash output {tuple(got.shape)} {got.dtype} at {(b, h, lq, lk, d)}")
            err = (got.float() - want.float()).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            if max(err, err64) >= worst_case.get(name, (-1.0,))[0]:
                worst_case[name] = (max(err, err64), (b, h, lq, lk, d, causal))
            worst[name] = max(worst.get(name, 0.0), err)
            ok = max(err, err64) <= TOL[name] and bool(torch.isfinite(got.float()).all())
            print(f"kernel flash_attention_fwd {name} [{b},{h},{lq},{d}] x {lk} keys "
                  f"causal={causal}: max_abs_err {err:.3e} vs plain, {err64:.3e} vs float64 "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"flash_attention_fwd disagrees with its plain version at {name} "
                      f"[{b},{h},{lq},{lk},{d}] causal={causal}: {err:.3e} / {err64:.3e}")
        err, (b, h, lq, lk, d, causal) = worst_case[name]
        print(f"kernel flash_attention_fwd {name}: worst case [{b},{h},{lq},{d}] x {lk} keys "
              f"causal={causal}, {err:.3e} vs plain or float64 (tol {TOL[name]:g})", flush=True)
    # the autograd Function against autograd through the plain version, fp32
    for causal in (False, True):
        q, k, v = (x.requires_grad_() for x in _qkv(2, 4, 577, 64, torch.float32,
                                                     seed=400 + causal))
        do = _qkv(2, 4, 577, 64, torch.float32, seed=410 + causal)[0]
        got = torch.autograd.grad(flash_attention(q, k, v, 0.125, causal), (q, k, v), do)
        want = torch.autograd.grad(flash_attention_reference(q, k, v, 0.125, causal),
                                   (q, k, v), do)
        largest = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"autograd flash_attention float32 [2,4,577,64] causal={causal}: max_abs_err "
              f"{err:.3e} vs autograd of the plain version (tol 1e-4 x {largest:.3e})",
              flush=True)
        check(err <= 1e-4 * largest, "the flash autograd Function disagrees with autograd")
    return worst


def _launch_counters():
    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )

    return {"flash_attention_fwd": flash_attention_fwd,
            "fused_attention_fwd": fused_attention_fwd,
            "fused_attention_bwd": fused_attention_bwd}


def _zero_counts() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def phase_train_long() -> int:
    """The long-sequence training path: ViT-L-14-336 at full width and depth,
    bf16 compute, ``attn_impl="flash"``, three steps without and three with
    grad checkpointing; returns the flash launches of the six steps."""
    import math

    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    batch = _train_batch(get_tokenizer(LONG_MODEL), LONG_BATCH, DEVICE, model_name=LONG_MODEL)
    _compare_step("bf16", batch, model_name=LONG_MODEL, impl="flash")

    # a schedule long enough that the learning rate is not 0 in any step here
    model, head, state, train_step, _ = _dino_setup("bf16", "flash", steps=40,
                                                    model_name=LONG_MODEL)
    n_vis = len(model.visual.transformer.resblocks)
    print(f"train-long: {LONG_MODEL} (vision {n_vis}x{model.visual.width}, "
          f"{model.visual.positional_embedding.shape[0]} tokens; text "
          f"{len(model.transformer.resblocks)}x{model.ln_final.weight.numel()}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params) bf16 DINO-soft "
          f"(kl_teacher, lambda_soft 0.5, mlp head {head.fc1.in_features}->"
          f"{head.fc1.out_features}->{DINO_DIM}) batch {LONG_BATCH}", flush=True)
    check(n_vis == 24 and model.visual.positional_embedding.shape[0] == 577,
          "ViT-L-14-336 must have 24 vision layers over 577 tokens")
    head_before = [p.detach().clone() for p in head.parameters()]
    steps, flash_total, losses = 3, 0, []
    for remat in (False, True):
        model.set_grad_checkpointing(remat)
        # ---- the main path: counts at 0 just before, read just after ----
        _zero_counts()
        for _ in range(steps):
            state, metrics = train_step(state, batch)
            losses.append(metrics["total_loss"])
        torch.cuda.synchronize()
        counts = _read_counts()
        per_step = 48 if remat else 24
        print(f"train-long grad_checkpointing={remat}: launches {counts} over {steps} steps "
              f"(expected flash {per_step * steps}, fused 0)", flush=True)
        check(counts["flash_attention_fwd"] == per_step * steps,
              f"expected {per_step * steps} flash launches, got {counts}")
        check(counts["fused_attention_fwd"] == 0 and counts["fused_attention_bwd"] == 0,
              f"the flash path launched a fused kernel: {counts}")
        flash_total += counts["flash_attention_fwd"]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: train_step(state, batch), iters=3)
        host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
        peak = torch.cuda.max_memory_allocated()
        print(f"time train step {LONG_MODEL} bf16 batch {LONG_BATCH} flash grad_checkpointing="
              f"{remat}: device {step_ms:.3f} ms (CUDA events), host clock {host_ms:.3f} ms "
              f"({LONG_BATCH / host_ms * 1e3:.1f} samples/s), peak memory "
              f"{peak / 2**30:.3f} GiB [{CARD}]", flush=True)
    losses = [float(x) for x in losses]
    ln_scale = float(model.logit_scale.detach())
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(head.parameters(), head_before))
    print(f"train-long: losses {losses}, ln logit scale {ln_scale:.6f}, head moved by "
          f"{moved:.3e}", flush=True)
    check(all(math.isfinite(x) for x in losses), "a train-long loss is not finite")
    check(0.0 <= ln_scale <= math.log(100.0), "the logit scale left [0, ln 100]")
    check(moved > 0, "the DINO head did not move")
    del model, head, state, train_step
    torch.cuda.empty_cache()

    # plain attention's step, for scale (no checkpointing)
    _, _, p_state, p_step, _ = _dino_setup("bf16", "xla", model_name=LONG_MODEL)
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(lambda: p_step(p_state, batch), iters=3)
    plain_host_ms = host_step_ms(lambda: p_step(p_state, batch), steps=3)
    plain_peak = torch.cuda.max_memory_allocated()
    del p_state, p_step
    torch.cuda.empty_cache()
    print(f"time train step {LONG_MODEL} bf16 batch {LONG_BATCH} plain attention "
          f"grad_checkpointing=False: device {plain_ms:.3f} ms (CUDA events), host clock "
          f"{plain_host_ms:.3f} ms ({LONG_BATCH / plain_host_ms * 1e3:.1f} samples/s), peak "
          f"memory {plain_peak / 2**30:.3f} GiB [{CARD}]", flush=True)

    # fp32 (TF32 off) with checkpointing: its activations would not fit without
    _compare_step("fp32", batch, model_name=LONG_MODEL, impl="flash", grad_checkpointing=True)
    return flash_total + phase_long_fp32_step(batch)


def phase_long_fp32_step(batch) -> int:
    """The ViT-L-14-336 DINO-soft step in fp32 compute with grad
    checkpointing (what ``--precision amp --attn-impl flash
    --grad-checkpointing`` runs): three steps' launches through flash (48 a
    step, no fused), the kernels a step runs by the profiler, then the step's
    time and peak memory through flash, through ``"auto"`` (at 577 tokens the
    fused fp32 kernels, forward and backward: the CLI's default) and through
    plain attention, all checkpointed; returns the flash launches."""
    import torch

    routes = {"flash": ("flash",), "auto": ("fwd", "dq", "dkdv"), "xla": ()}
    times, flash = {}, 0
    for impl, parts in routes.items():
        model, head, state, train_step, _ = _dino_setup("fp32", impl, steps=40,
                                                        model_name=LONG_MODEL,
                                                        grad_checkpointing=True)
        steps = 3 if impl == "flash" else 1
        # ---- the main path (flash): counts at 0 just before, read just after ----
        _zero_counts()
        for _ in range(steps):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        counts = _read_counts()
        print(f"train-long {LONG_MODEL} fp32 impl={impl} grad_checkpointing=True: launches "
              f"{counts} over {steps} step(s)", flush=True)
        if impl == "flash":
            check(counts == {"flash_attention_fwd": 48 * steps, "fused_attention_fwd": 0,
                             "fused_attention_bwd": 0},
                  f"expected {48 * steps} flash launches and no fused one, got {counts}")
            flash = counts["flash_attention_fwd"]
        if parts:
            check_fp32_route(lambda: train_step(state, batch), parts,
                             f"one fp32 {LONG_MODEL} step, impl={impl}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: train_step(state, batch), iters=3)
        host_ms = host_step_ms(lambda: train_step(state, batch), steps=3)
        times[impl] = (step_ms, host_ms, torch.cuda.max_memory_allocated())
        del model, head, state, train_step
        torch.cuda.empty_cache()
    print(f"time train step {LONG_MODEL} fp32 batch {LONG_BATCH} grad_checkpointing=True: "
          + "; ".join(f"{impl} device {ms:.3f} ms (CUDA events), host clock {host:.3f} ms "
                      f"({LONG_BATCH / host * 1e3:.2f} samples/s), peak memory "
                      f"{peak / 2**30:.3f} GiB" for impl, (ms, host, peak) in times.items())
          + f" [{CARD}]", flush=True)
    return flash


def phase_train_cli_long() -> int:
    """The CLI on ViT-L-14-336 with ``--grad-checkpointing --attn-impl
    flash`` (its checkpoint loads strictly), then one step of ViT-B-16 at
    ``--force-image-size 384``; returns the flash launches of both runs."""
    import json as _json
    import math
    import os
    import shutil
    import tempfile

    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train.main import main as train_main

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    logs = tempfile.mkdtemp(prefix="chip_smoke_train_long_", dir=build)
    common = ["--dataset-type", "synthetic", "--use_dino_general", "--soft_mode", "kl_teacher",
              "--lambda_soft", "0.5", "--synthetic-dino-dim", str(DINO_DIM), "--precision",
              "bf16", "--batch-size", str(LONG_BATCH), "--epochs", "1", "--workers", "4",
              "--log-every-n-steps", "1", "--logs", logs, "--seed", str(SEED), "--device", DEVICE,
              "--attn-impl", "flash"]
    try:
        _zero_counts()
        train_main(["--model", LONG_MODEL, "--grad-checkpointing", "--name", "long",
                    "--train-num-samples", str(CLI_LONG_SAMPLES), *common])
        torch.cuda.synchronize()
        counts = _read_counts()
        steps = CLI_LONG_SAMPLES // LONG_BATCH
        with open(os.path.join(logs, "long", "loss_steps.json")) as f:
            records = _json.load(f)
        ckpt = os.path.join(logs, "long", "checkpoints", "epoch_1.pt")
        print(f"train-cli-long: {LONG_MODEL} --grad-checkpointing --attn-impl flash: "
              f"{len(records)} logged steps, total_loss {[r['total_loss'] for r in records]}; "
              f"launches {counts} (expected flash {48 * steps}, fused 0); checkpoint "
              f"{os.path.getsize(ckpt) / 2**20:.1f} MiB", flush=True)
        check(len(records) == steps and all(math.isfinite(r["total_loss"]) for r in records),
              "loss_steps.json is not one finite record per step")
        check(counts == {"flash_attention_fwd": 48 * steps, "fused_attention_fwd": 0,
                         "fused_attention_bwd": 0}, f"the CLI run launched {counts}")
        flash = counts["flash_attention_fwd"]
        model, _ = create_model(LONG_MODEL, pretrained=ckpt, device=DEVICE)  # strict
        saved = torch.load(ckpt, map_location="cpu", weights_only=True, mmap=True)["state_dict"]
        same = all(torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())
        print(f"train-cli-long: the checkpoint loads strictly with create_model(pretrained=...), "
              f"every tensor equal to the saved one: {same}", flush=True)
        check(same and len(saved) == len(model.state_dict()), "the checkpoint does not load")
        del model, saved
        torch.cuda.empty_cache()

        _zero_counts()
        train_main(["--model", MODEL, "--force-image-size", "384", "--name", "b16_384",
                    "--train-num-samples", str(LONG_BATCH), "--stop-after-steps", "1",
                    "--save-frequency", "0", *common])
        torch.cuda.synchronize()
        counts = _read_counts()
        with open(os.path.join(logs, "b16_384", "loss_steps.json")) as f:
            records = _json.load(f)
        print(f"train-cli-long: {MODEL} --force-image-size 384 --attn-impl flash: one step, "
              f"total_loss {[r['total_loss'] for r in records]}; launches {counts} (expected "
              f"flash 12, fused 0)", flush=True)
        check(len(records) == 1 and math.isfinite(records[0]["total_loss"]),
              "the forced-size run did not log one finite step")
        check(counts == {"flash_attention_fwd": 12, "fused_attention_fwd": 0,
                         "fused_attention_bwd": 0}, f"the forced-size run launched {counts}")
        return flash + counts["flash_attention_fwd"]
    finally:
        shutil.rmtree(logs, ignore_errors=True)


def phase_flash_times() -> dict:
    """Flash kernel, its plain version and SDPA (yardstick only) at the
    training shapes, beside the bound."""
    import torch
    import torch.nn.functional as F

    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference,
    )

    rows = {}
    for b, h, lq, lk, d, causal, dtype_name in FLASH_TIMED:
        q, k, v = _qkv(b, h, lq, d, getattr(torch, dtype_name), seed=500, lk=lk)
        scale = d ** -0.5
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, scale, causal), iters=20)
        plain = time_ms(lambda: flash_attention_reference(q, k, v, scale, causal), iters=20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), iters=20)
        work = attention_work(b, h, lq, d, causal, dtype_name, lk=lk)
        bound, by = _bound(*work, dtype_name)
        rows[(b, h, lq, lk, d, causal, dtype_name)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"time flash_attention_fwd {dtype_name} [{b},{h},{lq},{d}] causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}){_fp32_cuda_core(work, dtype_name)}, kernel at "
              f"{bound / ms:.1%} of bound; "
              f"{_beside_scalar(SCALAR_FLASH_MS.get((b, h, lq, lk, d, causal, dtype_name)), ms)} "
              f"[{CARD}]", flush=True)
    return rows


def main() -> None:
    import shutil
    import tempfile

    import torch

    phase_device()
    phase_build()
    worst = phase_kernels()
    worst_bwd = phase_kernels_bwd()
    engine, plain, serve_launches = phase_serve()
    rows = phase_kernel_times("float32")
    rows_bf16 = phase_kernel_times("bfloat16")
    phase_serving_times(engine, plain)
    check(serve_launches > 0, "the served run launched no fused_attention_fwd")
    del engine, plain
    torch.cuda.empty_cache()
    train_fwd, train_bwd = phase_train_step()
    check(train_fwd > 0 and train_bwd > 0, "the train steps launched no kernel")
    phase_train_cli()
    # a work directory inside the checkout's (ignored) build tree, for the
    # mini-Flickr set, the runs and the seeded teacher
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_work_", dir=build)
    try:
        data = phase_data(work)
        eval_cli = phase_train_eval_cli(data, work)
        teacher_dir, teacher_launches = phase_teacher(work)
        extracted, extract_launches = phase_extract(data, teacher_dir, work)
        live = phase_train_live_cli(data, teacher_dir, work, extracted)
        pre = phase_pretrained(work)
        zs = phase_zero_shot(data, pre, work)
        ft = phase_finetune(data, pre, zs, work)
        off = phase_offline(data, pre, ft, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bwd_rows = phase_bwd_times("bfloat16")
    bwd_rows32 = phase_bwd_times("float32")
    worst_flash = phase_kernels_flash()
    long_launches = phase_train_long()
    phase_train_cli_long()
    flash_rows = phase_flash_times()

    t = rows[MAIN_PATH_CASE]
    t16 = rows_bf16[TRAIN_CASES[0]]  # the training image call, bf16
    tb = bwd_rows[TRAIN_CASES[0]]
    tb32 = bwd_rows32[TRAIN_CASES[0]]
    tf = flash_rows[FLASH_TIMED[0]]
    tf32 = flash_rows[FLASH_TIMED[1]]  # the ViT-L-14-336 vision call, fp32
    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd", "route": "cuda", "source": FUSED_SRC,
        "replaces": FUSED_TPU,
        "launches": serve_launches + train_fwd + eval_cli["fused_attention_fwd"]
        + teacher_launches + extract_launches + live["fused_attention_fwd"]
        + pre["launches"]["fused_attention_fwd"] + zs["counts"]["fused_attention_fwd"]
        + ft["counts"]["fused_attention_fwd"] + off["fused_attention_fwd"],
        "max_abs_err": worst["float32"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "bf16_shape": list(TRAIN_CASES[0][:4]), "bf16_ms": t16["ms"],
        "bf16_plain_ms": t16["plain_ms"], "bf16_bound_ms": t16["bound_ms"],
        "bf16_library_ms": t16["library_ms"],
        "teacher": [{"shape": list(case[:4]), "dtype": dtype_name, **by_case[case]}
                    for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                    for case in TEACHER_CASES],
        "evaluation": [{"shape": list(case[:4]), "dtype": dtype_name, **by_case[case]}
                       for dtype_name, by_case in (("float32", rows), ("bfloat16", rows_bf16))
                       for case in SLICE10_CASES],
    }, {
        "name": "fused_attention_bwd", "route": "cuda", "source": BWD_SRC,
        "replaces": BWD_TPU,
        "launches": train_bwd + eval_cli["fused_attention_bwd"] + live["fused_attention_bwd"]
        + ft["counts"]["fused_attention_bwd"],
        "max_abs_err": worst_bwd["bfloat16"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "fp32_shape": list(TRAIN_CASES[0][:4]), "fp32_max_abs_err": worst_bwd["float32"],
        "fp32_ms": tb32["ms"], "fp32_plain_ms": tb32["plain_ms"],
        "fp32_bound_ms": tb32["bound_ms"], "fp32_bound_by": tb32["bound_by"],
        "fp32_library_ms": tb32["library_ms"],
    }, {
        "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU,
        "launches": long_launches + pre["launches"]["flash_attention_fwd"],
        "max_abs_err": worst_flash["bfloat16"], "ms": tf["ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"], "library_ms": tf["library_ms"],
        "fp32_shape": list(FLASH_TIMED[1][:3]) + [FLASH_TIMED[1][4]],
        "fp32_max_abs_err": worst_flash["float32"], "fp32_ms": tf32["ms"],
        "fp32_plain_ms": tf32["plain_ms"], "fp32_bound_ms": tf32["bound_ms"],
        "fp32_bound_by": tf32["bound_by"], "fp32_library_ms": tf32["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
