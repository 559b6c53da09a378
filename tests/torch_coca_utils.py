"""Shared helpers of the ``test_torch_coca*`` files: one tiny CoCa in both
the JAX package and its PyTorch port.

``TINY_COCA`` is the tiny CoCa of ``tests/test_coca.py`` (copied). The JAX
model's parameters are seeded numpy draws on its tree's shapes (so that no
JAX function is compiled for them), and the decoder's EOT column is raised
along its ``ln_final`` bias so that beam searches end some hypotheses early
and fill their pools; the tree is carried into the port through
``jax_params_to_state_dict`` with ``strict=True``.
JAX is imported inside the functions.
"""

from __future__ import annotations

import numpy as np

TINY_COCA = {
    "embed_dim": 32,
    "vision_cfg": {
        "image_size": 32, "patch_size": 8, "width": 32, "layers": 2, "head_width": 16,
        "attentional_pool": True, "attn_pooler_queries": 8, "attn_pooler_heads": 2,
        "output_tokens": True,
    },
    "text_cfg": {
        "context_length": 12, "vocab_size": 64, "width": 32, "heads": 4, "layers": 2,
        "embed_cls": True, "output_tokens": True,
    },
    "multimodal_cfg": {
        "context_length": 12, "vocab_size": 64, "width": 32, "heads": 4, "layers": 2,
        "attn_pooler_heads": 2,
    },
    "custom_text": True,
}
# the tiny CoCa with the CLIP BPE vocabulary (serving, the CLI)
BPE_COCA = {**TINY_COCA, "text_cfg": {**TINY_COCA["text_cfg"], "vocab_size": 49408},
            "multimodal_cfg": {**TINY_COCA["multimodal_cfg"], "vocab_size": 49408}}
SOT, EOT, PAD = 62, 63, 0
IDS = dict(sot_token_id=SOT, eot_token_id=EOT, pad_token_id=PAD)
# how far the EOT logit is raised (along the decoder's ln_final bias)
EOT_BOOST = 1.25


def jax_coca(cfg_dict=TINY_COCA, attn_impl: str = "xla", seed: int = 0, noise: float = 0.3,
             params=None, eot: int = EOT):
    """(flax CoCa, variables): seeded fp32 params with the EOT boost,
    drawn with numpy on the tree's shapes (``jax.eval_shape``, nothing
    compiled): LayerNorm scales 1 + N(0, noise), other vectors N(0, noise),
    matrices and kernels N(0, fan_in^-1/2), the logit scale at its init;
    ``params`` reuses a tree (another ``attn_impl`` on the same weights)."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model, parse_model_cfg,
    )

    cfg = parse_model_cfg(cfg_dict)
    model = build_model(cfg, attn_impl=attn_impl)
    if params is None:
        size = cfg.vision_cfg.image_size
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                                jnp.zeros((1, size, size, 3)),
                                jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))
        rng = np.random.default_rng(seed)

        def draw(path, leaf):
            name = jax.tree_util.keystr(path)
            if "logit_scale" in name:
                return np.asarray(np.log(1 / 0.07), np.float32)
            shape = leaf.shape
            std = noise if len(shape) < 2 else float(np.prod(shape[:-1])) ** -0.5
            x = rng.normal(0.0, std, shape).astype(np.float32)
            return x + 1.0 if name.endswith("['scale']") else x

        params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
        dec = params["text_decoder"]
        beta = dec["ln_final"]["bias"]
        dec["text_projection"][:, eot] += EOT_BOOST * beta / (beta @ beta)
    return model, {"params": params}


def port_coca(params, cfg_dict=TINY_COCA, attn_impl: str = "auto", **kw):
    """The port's CoCa on the CPU holding the JAX params."""
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, jax_params_to_state_dict, parse_model_cfg,
    )

    model = build_model(parse_model_cfg(cfg_dict), attn_impl=attn_impl, **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def coca_images(n: int, size: int = 32, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def coca_texts(n: int, length: int = 12, seed: int = 2) -> np.ndarray:
    """Rows of SOT, random ids below SOT, EOT, zero pad; lengths vary."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, length), np.int32)
    for i in range(n):
        k = int(rng.integers(2, length - 1))
        out[i, 0] = SOT
        out[i, 1:k] = rng.integers(1, SOT, k - 1)
        out[i, k] = EOT
    return out
