"""chip_smoke.py's MobileCLIP pieces alone, for a short card run after a change
to them: the fused kernels at their new shapes (``MOBILECLIP_CASES``,
``MOBILECLIP_BWD_CASES``: the S towers' non-causal text at 8 and 64, S1's
text at a model axis of 2) against their plain versions and their times; the
``mobileclip`` phase (13f: MobileCLIP-S2 by its ``datacompdr`` tag, its
deploy form, its bf16 step with BatchNorm training, MobileCLIP-B from a file
in Apple's layout and its bf16 step); then the tp pair's towers part (i)
alone in two ``--dist-child tp`` ranks on the card over gloo (MobileCLIP-B
cut in depth and MobileCLIP-S1 whole, split over the model axis against one
process; ``chip_smoke.run_subset``). Every figure is printed beside the
card's name and power limit.

    python3 scripts/chip_mobileclip_phase.py        # on the card
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, _cut):
    seconds = {}
    t0 = time.perf_counter()
    out = {"mobileclip": c.phase_mobileclip(work)}
    seconds["mobileclip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    names = [c.MC_B, c.MC_S1]
    ranks = c._children("tp", {"parts": ["towers"], "towers": names}, c.TP_AXIS, timeout=600)
    c.tp_towers_report(ranks, add, names)
    seconds["tp towers (i) (two ranks, with their start)"] = time.perf_counter() - t0
    print(f"seconds {seconds} [{c.CARD}]", flush=True)
    out.update(tp_towers=total, seconds=seconds)
    return out


c.run_subset(("MOBILECLIP_CASES", "MOBILECLIP_BWD_CASES"), phases)
