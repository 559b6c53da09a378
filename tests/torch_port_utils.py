"""Shared helpers of the ``test_torch_*`` files: one set of weights in both
the JAX package and its PyTorch port.

A JAX CLIP is initialised from a seed, every parameter is then perturbed by
seeded numpy noise (so LayerNorm scales, biases and every other leaf differ
from their init constants), and the tree is carried into the port through
``jax_params_to_state_dict`` with ``strict=True``. JAX is imported inside the
functions, so test files stay importable where JAX is absent.
"""

from __future__ import annotations

import numpy as np

TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 32,
                   "layers": 2, "head_width": 16},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32,
                 "heads": 4, "layers": 2},
}


def jax_clip(cfg_dict, attn_impl: str = "fused", seed: int = 0, noise: float = 0.02):
    """(flax module, variables) with seeded, perturbed fp32 params."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model, parse_model_cfg,
    )

    cfg = parse_model_cfg(cfg_dict)
    model = build_model(cfg, attn_impl=attn_impl)
    size = cfg.vision_cfg.image_size
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32),
    )
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) if "logit_scale" in jax.tree_util.keystr(path)
        else np.asarray(x) + rng.normal(0.0, noise, np.shape(x)).astype(np.float32),
        jax.device_get(variables["params"]),
    )
    return model, {"params": params}


def port_clip(cfg_dict, params, attn_impl: str = "auto"):
    """The port's CLIP on the CPU holding the JAX params."""
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, jax_params_to_state_dict, parse_model_cfg,
    )

    model = build_model(parse_model_cfg(cfg_dict), attn_impl=attn_impl)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def images(n: int, size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def token_ids(n: int, context_length: int, seed: int = 2) -> np.ndarray:
    """Random CLIP-framed rows: SOT, random ids, EOT (the max id), zero pad."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, context_length), np.int32)
    for i in range(n):
        length = int(rng.integers(1, context_length - 1))
        out[i, 0] = 49406
        out[i, 1:1 + length] = rng.integers(1, 49405, length)
        out[i, 1 + length] = 49407
    return out
