"""chip_smoke.py's CoCa pieces alone, for a short card run after a CoCa
change: the fused kernels at the CoCa decoder's shapes (``COCA_CASES``)
forward and backward against their plain versions, their times, then the
``coca`` phase on a mini-Flickr cut of 14 + 7 images
(``chip_smoke.run_subset``).

    python3 scripts/chip_coca_phase.py        # on the card; about 2 min
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402

c.run_subset(("COCA_CASES",), c.phase_coca)
