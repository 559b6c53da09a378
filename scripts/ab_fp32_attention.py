#!/usr/bin/env python3
"""Time two trees of the repo on one card, in turns: parent, change, change, parent.

    python3 scripts/ab_fp32_attention.py PARENT_DIR CHANGE_DIR

Each turn is a fresh process that imports the package and ``chip_smoke.py``
of its tree (so it builds and runs that tree's kernels) and measures, with
only what both trees have:

* the fused kernels in fp32 at the serving and training shapes (forward) and
  the training shapes (backward), by CUDA events after a queued sleep
  (``chip_smoke.time_ms``);
* the flash forward in fp32 at the ViT-L-14-336 and ViT-B-16@384 vision
  calls (``[32,16,577,64]``, ``[32,12,577,64]``), and the fused fp32
  forward at the same shapes (its gate admits 577 tokens);
* the bf16 kernels as the control: the fused forward and backward at the
  training shapes and the flash forward at ``[32,16,577,64]``;
* the ViT-B-16 DINO-soft train step in fp32 at batch 64: CUDA events, the
  host clock over back-to-back steps, and the profiler's device busy time
  and idle share (``scripts/profile_torch_serving.profile_calls``);
* one serving bucket, the fp32 image tower at batch 32: CUDA events per
  tower call, and the profiler's busy time and latency per engine call;
* the ViT-L-14-336 DINO-soft train step in fp32 at batch 32 through the
  flash kernel with grad checkpointing (what ``--precision amp --attn-impl
  flash --grad-checkpointing`` runs): CUDA events, the host clock, busy
  time and idle share.

``--child TREE`` runs one turn of one tree and prints its JSON line. Prints
one line per turn and metric, each beside the parent's own spread, then the
table as one JSON object on its last line. Exits non-zero if a turn fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

FWD_SHAPES = [(8, 12, 197, 64, False), (32, 12, 197, 64, False), (64, 12, 197, 64, False),
              (8, 8, 77, 64, True), (32, 8, 77, 64, True), (64, 8, 77, 64, True)]
TRAIN_SHAPES = [(64, 12, 197, 64, False), (64, 8, 77, 64, True)]
FLASH_SHAPE = (32, 16, 577, 64)
FLASH_FP32_SHAPES = [(32, 16, 577, 64), (32, 12, 577, 64)]
ORDER = ("parent", "change", "change", "parent")


def child(tree: str) -> None:
    """One turn: every measurement of one tree, as one JSON line."""
    sys.path[:0] = [tree, os.path.join(tree, "scripts")]
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from profile_torch_serving import profile_calls
    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
    from refining_clip_via_dinov2_representations_torch.ops import native
    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_fwd,
    )

    cs.phase_device()
    native.build()
    out = {}
    for dtype_name, shapes in (("float32", FWD_SHAPES), ("bfloat16", TRAIN_SHAPES)):
        for b, h, l, d, causal in shapes:
            q, k, v = cs._qkv(b, h, l, d, getattr(torch, dtype_name), seed=100)
            ms = cs.time_ms(lambda: fused_attention_fwd(q, k, v, d ** -0.5, causal))
            out[f"fwd {dtype_name} [{b},{h},{l},{d}]{' causal' if causal else ''}"] = ms
    for dtype_name in ("float32", "bfloat16"):
        for b, h, l, d, causal in TRAIN_SHAPES:
            q, k, v = cs._qkv(b, h, l, d, getattr(torch, dtype_name), seed=200)
            do = cs._qkv(b, h, l, d, getattr(torch, dtype_name), seed=201)[0]
            o = fused_attention_fwd(q, k, v, d ** -0.5, causal)
            ms = cs.time_ms(lambda: fused_attention_bwd(q, k, v, o, do, d ** -0.5, causal),
                            iters=20)
            out[f"bwd {dtype_name} [{b},{h},{l},{d}]{' causal' if causal else ''}"] = ms
    q, k, v = cs._qkv(*FLASH_SHAPE, torch.bfloat16, seed=500)
    out[f"flash bfloat16 {list(FLASH_SHAPE)}"] = cs.time_ms(
        lambda: flash_attention_fwd(q, k, v, 0.125, False), iters=20)
    for shape in FLASH_FP32_SHAPES:
        q, k, v = cs._qkv(*shape, torch.float32, seed=500)
        out[f"flash float32 {list(shape)}"] = cs.time_ms(
            lambda: flash_attention_fwd(q, k, v, 0.125, False), iters=20)
        out[f"fwd float32 {list(shape)}"] = cs.time_ms(
            lambda: fused_attention_fwd(q, k, v, 0.125, False), iters=20)
    del q, k, v, do, o

    batch = cs._train_batch(get_tokenizer(cs.MODEL), cs.TRAIN_BATCH, "cuda")
    _, _, state, train_step, _ = cs._dino_setup("fp32", "auto")

    def step(_):
        train_step(state, batch)
        torch.cuda.synchronize()

    out["fp32 step events ms"] = cs.time_ms(lambda: train_step(state, batch), iters=5)
    out["fp32 step host ms"] = cs.host_step_ms(lambda: train_step(state, batch))
    prof = profile_calls(step, None, 3)
    out["fp32 step busy ms"] = prof["device_busy_ms"]
    out["fp32 step idle share"] = prof["idle_share"]
    del state, train_step
    torch.cuda.empty_cache()

    engine, _, _ = create_engine(cs.MODEL, device="cuda", buckets=(32,), seed=cs.SEED)
    h, w = engine.image_size
    pixels = np.random.default_rng(cs.SEED + 2).normal(size=(32, h, w, 3)).astype(np.float32)
    x = torch.from_numpy(pixels).cuda()
    with torch.inference_mode():
        out["serve image b32 tower events ms"] = cs.time_ms(
            lambda: engine.model.encode_image(x), iters=10)
    prof = profile_calls(engine.encode_image, pixels, 5)
    out["serve image b32 busy ms"] = prof["device_busy_ms"]
    out["serve image b32 latency ms"] = prof["latency_ms"]
    del engine, x
    torch.cuda.empty_cache()

    batch = cs._train_batch(get_tokenizer(cs.LONG_MODEL), cs.LONG_BATCH, "cuda",
                            model_name=cs.LONG_MODEL)
    _, _, state, train_step, _ = cs._dino_setup("fp32", "flash", steps=40,
                                                model_name=cs.LONG_MODEL,
                                                grad_checkpointing=True)

    def long_step(_):
        train_step(state, batch)
        torch.cuda.synchronize()

    out["ViT-L fp32 flash step events ms"] = cs.time_ms(lambda: train_step(state, batch),
                                                        iters=3)
    out["ViT-L fp32 flash step host ms"] = cs.host_step_ms(lambda: train_step(state, batch),
                                                           steps=3)
    prof = profile_calls(long_step, None, 2)
    out["ViT-L fp32 flash step busy ms"] = prof["device_busy_ms"]
    out["ViT-L fp32 flash step idle share"] = prof["idle_share"]
    print(json.dumps({"card": cs.CARD, "results": out}), flush=True)


def _beside_spread(turns, values) -> str:
    """The change's mean against the parent's: the parent's own spread (its
    two turns' difference over their mean), the change's shift, and whether
    both change turns lie within the parent's two."""
    parent = [v for (n, _), v in zip(turns, values) if n == "parent"]
    change = [v for (n, _), v in zip(turns, values) if n == "change"]
    p_mean, c_mean = sum(parent) / len(parent), sum(change) / len(change)
    if p_mean == 0:
        return "parent 0"
    spread = (max(parent) - min(parent)) / abs(p_mean)
    inside = all(min(parent) <= c <= max(parent) for c in change)
    return (f"parent spread {spread:.2%}, change {c_mean / p_mean - 1:+.2%} of the parent's mean, "
            f"{'within' if inside else 'outside'} the parent's spread")


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": os.path.abspath(sys.argv[2])}
    turns = []
    for name in ORDER:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", trees[name]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"ab: the {name} turn failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((name, result))
        print(f"turn {len(turns)} ({name}) done on {result['card']}", flush=True)
    table = {}
    for metric in turns[0][1]["results"]:
        table[metric] = [r["results"][metric] for _, r in turns]
        print(f"{metric}: " + " / ".join(f"{n} {v:.4f}" for (n, _), v in zip(turns, table[metric]))
              + f"; {_beside_spread(turns, table[metric])} [{turns[0][1]['card']}]", flush=True)
    print(json.dumps({"order": list(ORDER), "card": turns[0][1]["card"], "table": table}),
          flush=True)


if __name__ == "__main__":
    main()
