"""The port's weight-only int8 (``inference.py``) against the JAX engine's.

* The state dict: the JAX ``quantize_variables_int8`` ->
  ``dequantize_variables(..., float32)`` -> ``flax_params_to_torch_state_dict``
  against the port's ``quantize_state_dict_int8`` -> ``dequantize`` of the
  exported fp32 state dict, bit for bit, for a tiny CLIP, SigLIP and CoCa,
  at a least size that splits each model's matrices into both sets (and at
  the JAX default). The set of int8 tensors is the JAX set: each flax leaf
  is marked 1 where the JAX rule quantizes it, 0 where not, and the markers
  go through the same exporter.
* The engine: ``quantize="int8"`` keeps the quantized tensors as int8 on
  its device; its features equal the JAX int8 engine's within 1e-5 (fp32
  compute, the images rounded to bf16 in both) and the fp32 engine's at
  cosine > 0.999 (``tests/test_inference.py:121``); ``resident_bytes``
  counts the int8 storage.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.inference import (
    _QUANT_MIN_SIZE, ClipInferenceEngine, Int8Weight, dequantize, quantize_state_dict_int8,
    resident_bytes,
)

from .test_torch_siglip import TINY_DIMS, TINY_SIGLIP
from .torch_coca_utils import TINY_COCA, jax_coca
from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids


@pytest.fixture
def tiny_siglip_dims(monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import siglip as tsiglip
    from refining_clip_via_dinov2_representations_tpu.models import siglip as jsiglip

    monkeypatch.setitem(jsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    monkeypatch.setitem(tsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)


def _params(family):
    if family == "clip":
        return jax_clip(TINY_CFG, attn_impl="xla", seed=3)[1]["params"]
    if family == "siglip":
        return jax_clip(TINY_SIGLIP, attn_impl="xla", seed=4, noise=0.05, jit=True)[1]["params"]
    return jax_coca(TINY_COCA, seed=6)[1]["params"]


def _export(params):
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    return {k: torch.as_tensor(np.asarray(v)) for k, v in
            flax_params_to_torch_state_dict(params).items()}


@pytest.mark.parametrize("min_size", [256, _QUANT_MIN_SIZE])
@pytest.mark.parametrize("family", ["clip", "siglip", "coca"])
def test_int8_state_dict_is_bit_equal_to_the_jax_quantizer(tiny_siglip_dims, family, min_size):
    import jax

    from refining_clip_via_dinov2_representations_tpu.inference import (
        dequantize_variables, quantize_variables_int8,
    )

    params = _params(family)
    jq = quantize_variables_int8({"params": params}, min_size)["params"]
    want = _export(jax.device_get(dequantize_variables(jq, np.float32)))
    is_q = lambda x: isinstance(x, dict) and set(x) == {"_q", "_s"}  # noqa: E731
    marks = jax.tree.map(lambda x: np.ones(x["_q"].shape, np.float32) if is_q(x)
                         else np.zeros(np.shape(x), np.float32), jq, is_leaf=is_q)
    jax_int8 = {k for k, v in _export(marks).items() if v.numel() and bool((v == 1).all())}

    ours = quantize_state_dict_int8(_export(params), min_size)
    got = dequantize(ours)
    assert {k for k, v in ours.items() if isinstance(v, Int8Weight)} == jax_int8
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for k in jax_int8:
        assert ours[k].q.dtype == torch.int8 and ours[k].scale.dtype == torch.float32
        assert int(ours[k].q.abs().max()) <= 127
    if min_size == 256:  # the small size quantizes the families' distinctive tensors
        need = {"clip": ("visual.proj", "visual.conv1.weight"),
                "siglip": ("visual.trunk.attn_pool.q.weight", "visual.trunk.attn_pool.kv.weight",
                           "visual.trunk.patch_embed.proj.weight", "visual.trunk.pos_embed"),
                "coca": ("visual.attn_pool.attn.in_proj_weight", "visual.attn_pool.query",
                         "text_decoder.text_projection")}[family]
        assert set(need) <= jax_int8
        assert not any(k.endswith(("token_embedding.weight", "positional_embedding"))
                       for k in jax_int8)


def test_int8_engine_matches_the_jax_int8_engine_and_stays_int8():
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )

    min_size = 512
    jmodel, variables = jax_clip(TINY_CFG, attn_impl="xla", seed=7, noise=0.05)
    jax_int8 = JaxEngine(jmodel, variables, (16, 16), 12, buckets=(2, 4), quantize="int8",
                         quantize_min_size=min_size)
    fp32 = ClipInferenceEngine(port_clip(TINY_CFG, variables["params"], attn_impl="xla"),
                               (16, 16), 12, buckets=(2, 4))
    model = port_clip(TINY_CFG, variables["params"], attn_impl="xla")
    before = resident_bytes(model)
    engine = ClipInferenceEngine(model, (16, 16), 12, buckets=(2, 4), quantize="int8",
                                 quantize_min_size=min_size)
    after = resident_bytes(model)
    want_q = {k for k, v in quantize_state_dict_int8(
        port_clip(TINY_CFG, variables["params"]).state_dict(), min_size).items()
        if isinstance(v, Int8Weight)}
    stored = {n.replace("parametrizations.", "").replace(".original", ""): p
              for n, p in model.named_parameters()}
    assert {n for n, p in stored.items() if p.dtype == torch.int8} == want_q
    n_q = sum(stored[n].numel() for n in want_q)
    assert before["int8"] == 0 and after["int8"] == n_q
    scales = sum(b.numel() for n, b in model.named_buffers() if n.endswith(".0.scale"))
    assert after["total"] == before["total"] - 3 * n_q + 4 * scales  # fp32 -> int8 + scales
    x, ids = images(5, 16, seed=8), token_ids(3, 12, seed=9)
    for got, want, ref in ((engine.encode_image(x), jax_int8.encode_image(x),
                            fp32.encode_image(x)),
                           (engine.encode_text(ids), jax_int8.encode_text(ids),
                            fp32.encode_text(ids))):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert (got * ref).sum(-1).min() > 0.999
        assert np.abs(got - ref).max() > 1e-6  # the int8 rounding is visible
