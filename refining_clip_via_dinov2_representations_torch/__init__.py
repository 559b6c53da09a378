"""PyTorch/CUDA port of the CLIP serving path.

Beside the JAX package ``refining_clip_via_dinov2_representations_tpu``,
which stays the reference: the same module names, open_clip's parameter
layout, and hand-written Hopper kernels (``csrc/``) where the JAX package has
Pallas kernels. Imports ``torch``, never JAX. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from .inference import (
    ClipInferenceEngine,
    create_engine,
    load_exported,
    load_exported_sharded,
)
from .models import (
    CLIP,
    CoCa,
    build_model,
    coca_generate,
    coca_generate_beam,
    create_model,
    create_model_and_transforms,
    create_model_from_pretrained,
    get_model_config,
    get_tokenizer,
    list_models,
    list_pretrained,
    load_openai_model,
    parse_model_cfg,
    register_model_config,
)
from .tokenizer import HFTokenizer, SigLipTokenizer, SimpleTokenizer, decode, tokenize
from .transform import PreprocessCfg, image_transform_v2
