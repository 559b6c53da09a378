"""chip_smoke.py's loss-zoo and ViT-variant pieces alone, for a short card
run after a change to them: the fused kernels at their new shapes
(``ZOO_CASES``: the ViT-L-14 teacher's causal text, CLIPA's vision and
non-causal text, the GAP ViT, head dim 104; ``ZOO_BWD_CASES``: head dim
104's backward) against their plain versions, their times, then the ``zoo``
phase (distillation
under a full-width ViT-L-14 teacher, CyCLIP, ViT-L-14-CLIPA served from its
tag, the GAP and relative-position ViTs) on a mini-Flickr cut of 14 + 7
images with its own hub cache (``chip_smoke.run_subset``).

    python3 scripts/chip_zoo_phase.py        # on the card
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402

c.run_subset(("ZOO_CASES", "ZOO_BWD_CASES"),
             lambda work, d: c.phase_zoo(work, d, {"cache": os.path.join(work, "hub")}))
