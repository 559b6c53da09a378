"""The host cost of the attention kernels' dispatch, on the card: ViT-B-16's
served b1 tower call and its bf16 DINO-soft train step at batch 64, by host
clock, as ``chip_smoke.py`` measures them (``phase_serving_times``,
``phase_train_step``).

    python3 scripts/dispatch_cost.py [--root CHECKOUT] [--label NAME] [--profile FILE]

``--root`` imports the port and ``chip_smoke.py`` from another checkout (an
unpacked ``git archive`` of a parent commit), so that two versions are timed
by the same script; run them in turns in one call (parent, change, change,
parent), one process each. Prints the card's name and power limit and one
``DISPATCH`` JSON line: the b1 image request's latency (p50 of 50, numpy in
and out, as ``engine.encode_image``), the b1 image tower call's host clock
(median of 50 calls on a device tensor, each ending in a sync) and the step's
host clock (``chip_smoke.host_step_ms``: the mean of 5 back-to-back steps,
7 repeats), and the host's cost of one call of the attention entry point
(``ops.fused_attention.fused_attention`` on ``[1,1,1,64]`` fp32, where the
kernel takes a few microseconds: the mean of 2000 calls under ``no_grad``
and of 2000 with autograd recording, each series ending in one sync), and
the host clock of phase train-long's checkpointed step (ViT-L-14-336 with
``chip_smoke.LONG_LAYERS`` vision blocks, bf16, batch 32, through flash,
every block recomputed: three repeats of ``host_step_ms`` over 3 steps).
``--profile FILE`` writes the host's time by function over two of those
steps (``cProfile``, sorted by own time) to FILE.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), help="the checkout whose port and chip_smoke.py are timed")
    parser.add_argument("--label", default="", help="a name for this run in the output")
    parser.add_argument("--profile", default=None,
                        help="write cProfile's table of two checkpointed steps here")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import chip_smoke as cs
    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    if not torch.cuda.is_available():
        sys.exit("dispatch_cost.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    cs.phase_build()

    def median_ms(fn, n=50):
        samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    engine, _, _ = create_engine(cs.MODEL, device="cuda", buckets=(1,), seed=cs.SEED)
    x = np.random.default_rng(cs.SEED + 2).normal(size=(1, 224, 224, 3)).astype(np.float32)
    xd = torch.from_numpy(x).cuda().to(engine.dtype)
    with torch.inference_mode():
        tower = median_ms(lambda: engine.model.encode_image(xd))
    request = median_ms(lambda: engine.encode_image(x))
    del engine
    torch.cuda.empty_cache()

    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention,
    )

    def per_call_us(grad: bool, n: int = 2000) -> float:
        q = torch.randn(1, 1, 1, 64, device="cuda", requires_grad=grad)
        with torch.set_grad_enabled(grad):
            for _ in range(50):
                fused_attention(q, q, q, 0.125, False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fused_attention(q, q, q, 0.125, False)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    call_us = {"no_grad": per_call_us(False), "grad": per_call_us(True)}

    batch = cs._train_batch(get_tokenizer(cs.MODEL), cs.TRAIN_BATCH, "cuda")
    _, _, state, train_step, _ = cs._dino_setup("bf16", "auto")
    step = [cs.host_step_ms(lambda: train_step(state, batch)) for _ in range(7)]
    del state, train_step
    torch.cuda.empty_cache()

    cs._cut_vision_depth(cs.LONG_MODEL, cs.LONG_LAYERS)
    long_batch = cs._train_batch(get_tokenizer(cs.LONG_MODEL), cs.LONG_BATCH, "cuda",
                                 model_name=cs.LONG_MODEL)
    model, _, long_state, long_step, _ = cs._dino_setup("bf16", "flash", steps=40,
                                                        model_name=cs.LONG_MODEL)
    model.set_grad_checkpointing(True)
    long_ms = [cs.host_step_ms(lambda: long_step(long_state, long_batch), steps=3)
               for _ in range(3)]
    if args.profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2):
            long_step(long_state, long_batch)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(40)
        with open(args.profile, "w") as f:
            f.write(out.getvalue())
    print("DISPATCH " + json.dumps({
        "label": args.label, "root": os.path.abspath(args.root), "card": card,
        "b1_request_p50_ms": request, "b1_image_tower_host_ms": tower,
        "bf16_step_host_ms": step, "fused_attention_call_us": call_us,
        "long_ckpt_step_host_ms": long_ms}), flush=True)


if __name__ == "__main__":
    main()
