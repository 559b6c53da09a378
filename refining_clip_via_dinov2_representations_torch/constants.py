"""Dataset normalisation constants and the CLIP logit-scale init.

The port's own copy of the JAX package's ``constants.py`` values (OpenAI CLIP
RGB mean/std) and ``models/clip.py``'s ``DEFAULT_INIT_LOGIT_SCALE``.
"""

import math

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

# log(1 / 0.07): the contrastive temperature CLIP starts from
DEFAULT_INIT_LOGIT_SCALE = math.log(1 / 0.07)
