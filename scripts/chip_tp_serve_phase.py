"""chip_smoke.py's serving pieces alone, for a short card run after a change
to the int8 engine, the follower protocol, the model axis of SigLIP and
CoCa or the deployable artifact: the fused kernels at the new local-head
shapes (``TP_SERVE_CASES``) forward and backward against their plain
versions and their times; phase 4b (the seeded ViT-B-16 fp32 engine's
artifact); on a mini-Flickr cut of 14 + 7 images (``chip_smoke.run_subset``)
phase 13 (the seeded ``openai`` tag in a hub cache) and 13b (int8 serving);
then one pair
of ``--dist-child tp`` ranks (phase 21 (a), (c) and (d)-(h): the served
split ViT-B-16, the serve CLI on two ranks, the SigLIP and CoCa steps split
over the model group, a CoCa caption, the split engine's artifact exported
and reloaded with ``load_exported_sharded``), without 21 (b)'s EVA01 runs.
Phases 13 and 13b export and reload their engines' artifacts (the 384-px
tower under flash, the int8 engine) as in the full run.

    python3 scripts/chip_tp_serve_phase.py        # on the card; about 5 min
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, d):
    from refining_clip_via_dinov2_representations_torch.inference import create_engine

    engine, _, _ = create_engine(c.MODEL, device=c.DEVICE, buckets=c.BUCKETS, seed=c.SEED)
    out = {"export": c.phase_export(engine)}
    del engine
    pre = c.phase_pretrained(work)
    out["int8"] = c.phase_int8(d, pre)
    t_tp = time.perf_counter()
    ranks = c.tp_pair(d, pre)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    c.tp_serve_report(ranks, add)
    print(f"tp pair (a), (c), (d)-(h): {time.perf_counter() - t_tp:.1f} s; launches of (d)-(h) "
          f"{total}", flush=True)
    out["tp rank 0"] = {k: v for k, v in ranks[0].items() if k != "teacher"}
    return out


c.run_subset(("TP_SERVE_CASES",), phases)
