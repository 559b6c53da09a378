"""chip_smoke.py's SigLIP pieces alone, for a short card run after a SigLIP
change: the fused kernels at SigLIP's shapes (``SIGLIP_CASES``: the MAP
head's one probe query over 196 keys, the non-causal 64-token text, the
vision blocks) forward and backward against their plain versions, their
times, then the ``siglip`` phase on a mini-Flickr cut of 14 + 7 images.

    python3 scripts/chip_siglip_phase.py        # on the card; about 2 min
"""
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402

t0 = time.perf_counter()
c.phase_device()
c.phase_build()
print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)
for name in ("KERNEL_CASES", "TEACHER_CASES", "SLICE10_CASES", "GIANT_CASES", "TP_CASES",
             "TRAIN_CASES", "TP_BWD_CASES", "BWD_CASES", "TIMED_CASES", "BWD_TIMED",
             "COCA_CASES"):
    setattr(c, name, [])
c.phase_kernels()
c.phase_kernels_bwd()
c.phase_kernel_times("float32")
c.phase_kernel_times("bfloat16")
c.phase_bwd_times("bfloat16")
c.phase_bwd_times("float32")
print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)
c.EVAL_TRAIN_IMAGES, c.EVAL_VAL_IMAGES = 14, 7
build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
os.makedirs(build, exist_ok=True)
work = tempfile.mkdtemp(dir=build)
try:
    d = c.phase_data(work)
    out = c.phase_siglip(work, d)
    print("RESULT", out, flush=True)
finally:
    shutil.rmtree(work, ignore_errors=True)
print(f"elapsed {time.perf_counter() - t0:.1f}", flush=True)
