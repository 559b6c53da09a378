"""chip_smoke.py's SigLIP pieces alone, for a short card run after a SigLIP
change: the fused kernels at SigLIP's shapes (``SIGLIP_CASES``: the MAP
head's one probe query over 196 keys, the non-causal 64-token text, the
vision blocks) forward and backward against their plain versions, their
times, then the ``siglip`` phase on a mini-Flickr cut of 14 + 7 images
(``chip_smoke.run_subset``).

    python3 scripts/chip_siglip_phase.py        # on the card; about 2 min
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402

c.run_subset(("SIGLIP_CASES", "SIGLIP_TIMED"), c.phase_siglip)
