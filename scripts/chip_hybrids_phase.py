"""chip_smoke.py's hybrid-tower and model-axis pieces alone, for a short card
run after a change to them: the fused kernels at their shapes
(``HYBRID_CASES``, ``HYBRID_BWD_CASES``: ViTamin-L's vision and text,
576 queries through the fused forward, Swin's text, the local heads of
EVA02-L/E-14, Swin and ViTamin-L at a model axis of 2) against their plain
versions and their times, the flash forward at ViTamin-L-384's
``[8,16,576,64]`` (every flash case checked, ``FLASH_TIMED`` timed); the
``hybrids`` phase (13e: ViTamin-L by its ``datacomp1b`` tag, its
checkpointed bf16 step, ViTamin-L-384 under "flash" and "auto", Swin's
features and bf16 step); then the tp pair's towers parts (e)-(g) alone in
two ``--dist-child tp`` ranks on the card over gloo (EVA02-L-14 and
EVA02-E-14 cut in depth, the relative-position ViT, Swin and ViTamin-L split
over the model axis against one process; ``chip_smoke.run_subset``).

    python3 scripts/chip_hybrids_phase.py        # on the card
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, _cut):
    seconds = {}
    t0 = time.perf_counter()
    c.phase_kernels_flash()
    flash = {str(k): v for k, v in c.phase_flash_times().items() if k[2] == 576}
    seconds["flash"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {"hybrids": c.phase_hybrids(work), "flash": flash}
    seconds["hybrids"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    ranks = c._children("tp", {"parts": ["towers"]}, c.TP_AXIS, timeout=600)
    c.tp_towers_report(ranks, add)
    seconds["tp towers (two ranks, with their start)"] = time.perf_counter() - t0
    print(f"seconds {seconds} [{c.CARD}]", flush=True)
    out.update(tp_towers=total, seconds=seconds)
    return out


c.run_subset(("HYBRID_CASES", "HYBRID_TIMED", "HYBRID_BWD_CASES", "HYBRID_FLASH_CASES"), phases)
