"""ConvNeXt's memory format on the card: convnext_base_w (seeded, full width)
with its tower in channels-last against NCHW-contiguous memory, each in a
fresh process (the first call pays what the convolution libraries build
once a process): the fp32 image tower at batch 8 and the bf16 CLIP loss and
backward at 64 under ``--grad-checkpointing``, each first call by the host
clock with a sync, then the steady call by CUDA events (``chip_smoke.
time_ms``); the card's name and power limit beside the numbers.

    python3 scripts/convnext_memory_format.py      # on the card
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(channels_last: bool) -> dict:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as c
    from refining_clip_via_dinov2_representations_torch.models import create_model
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _ = create_model("convnext_base_w", device="cuda", seed=0)
    if not channels_last:
        model.visual.memory_format = torch.contiguous_format
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 256, 256, 3)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(1, 49405, (64, 77))).cuda()
    out = {}

    def first(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        fwd = lambda: model.encode_image(x[:8])  # noqa: E731
        out["fp32 image b8 first ms"] = first(fwd)
        out["fp32 image b8 ms"] = c.time_ms(fwd, iters=10)
    model.train().set_grad_checkpointing(True)
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.bfloat16
    loss_fn = make_loss_fn(model, StepCfg(loss_type="clip"))

    def step():
        model.zero_grad(set_to_none=True)
        loss_fn({"images": x, "texts": ids}, 0)[0].backward()

    out["bf16 step 64 first ms"] = first(step)
    out["bf16 step 64 ms"] = c.time_ms(step, iters=3)
    out["card"] = c.CARD
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print("CHILD " + json.dumps(child(sys.argv[2] == "channels_last")), flush=True)
        sys.exit(0)
    sys.path.insert(0, ROOT)
    import chip_smoke as c

    c.phase_device()
    rows = {}
    for fmt in ("channels_last", "contiguous", "contiguous", "channels_last"):
        proc = subprocess.run([sys.executable, __file__, "--child", fmt], capture_output=True,
                              text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("CHILD ")]
        if proc.returncode or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            sys.exit(1)
        r = json.loads(line[0][6:])
        r["card"] = c.CARD
        rows.setdefault(fmt, []).append(r)
        print(f"convnext_base_w {fmt}: {r}", flush=True)
    print(json.dumps(rows))
