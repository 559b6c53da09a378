"""chip_smoke.py's multi-process pieces alone, for a short card run after a
change to them: phase 13 (the seeded ``openai`` tag in a hub cache) and
phase 17 (Config 2 through ``train.main``) on mini-Flickr at its full size,
then ``phase_processes``: every process of phases 20 (dist) and 21 (tp) and
Config 2's preempted run started at once, then ``--resume latest``
(``chip_smoke.run_subset``, no kernel case list kept). Prints the seconds of
each piece.

    python3 scripts/chip_processes_phase.py        # on the card; about 6 min
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, _cut):
    c.EVAL_TRAIN_IMAGES, c.EVAL_VAL_IMAGES = 160, 40  # Config 2's batches need the full set
    d = c.phase_data(work)
    seconds = {}
    t0 = time.perf_counter()
    pre = c.phase_pretrained(work)
    seconds["pretrained"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c2 = c.phase_config2(d, pre, work)
    seconds["config2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist, tp, run = c.phase_processes(work, None, d, pre, c2)
    seconds["processes (with the gloo probes)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.phase_config2_resume(work, c2, run)
    seconds["config2 resume"] = time.perf_counter() - t0
    print(f"seconds {seconds} [{c.CARD}]", flush=True)
    return {"seconds": seconds, "dist": dist, "tp": tp["launches"],
            "config2": c2["launches"]}


c.run_subset((), phases)
