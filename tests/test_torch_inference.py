"""The port's serving engine against the JAX engine on the same weights (CPU).

Both engines round images to bf16 before the fp32 towers, pad requests to
their buckets and chunk past the top bucket; features are compared at 1e-4
absolute (fp32 summation order), logits at 1e-3 (the logit scale is ~14).
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.inference import (
    ClipInferenceEngine, create_engine,
)
from refining_clip_via_dinov2_representations_torch.models import (
    create_model, register_model_config,
)

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

TOL = 1e-4
BUCKETS = (2, 4)
register_model_config("tiny-torch-engine", TINY_CFG)


@pytest.fixture(scope="module")
def engines():
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )

    jmodel, variables = jax_clip(TINY_CFG, seed=11)
    jax_engine = JaxEngine(jmodel, variables, image_size=(16, 16), context_length=12,
                           buckets=BUCKETS)
    model = port_clip(TINY_CFG, variables["params"])
    engine = ClipInferenceEngine(model, image_size=(16, 16), context_length=12,
                                 buckets=BUCKETS)
    return jax_engine, engine


@pytest.mark.parametrize("n", [3, 4, 9])  # not a bucket, a bucket, past the top bucket
def test_encode_image_matches_jax(engines, n):
    jax_engine, engine = engines
    x = images(n, 16, seed=n)
    got = engine.encode_image(x)
    assert got.shape == (n, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_engine.encode_image(x), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5])
def test_encode_text_matches_jax(engines, n):
    jax_engine, engine = engines
    ids = token_ids(n, 12, seed=n)
    np.testing.assert_allclose(engine.encode_text(ids), jax_engine.encode_text(ids),
                               atol=TOL, rtol=0)


def test_similarity_and_logit_terms_match_jax(engines):
    jax_engine, engine = engines
    scale, bias = engine.logit_terms()
    want_scale, want_bias = jax_engine.logit_terms()
    assert scale == pytest.approx(want_scale, rel=1e-6) and bias == want_bias == 0.0
    x, ids = images(3, 16, seed=7), token_ids(2, 12, seed=7)
    np.testing.assert_allclose(engine.similarity(x, ids), jax_engine.similarity(x, ids),
                               atol=1e-3, rtol=0)


def test_pixels_are_rounded_to_bf16_before_the_tower(engines):
    """Pixels that bf16 cannot hold: the engine's features are those of the
    bf16-rounded pixels, not of the raw ones, as in the JAX engine."""
    jax_engine, engine = engines
    x = (1.0 + np.random.default_rng(3).uniform(0, 2 ** -8, (2, 16, 16, 3))).astype(np.float32)
    x *= np.random.default_rng(4).choice([-1.0, 1.0], x.shape).astype(np.float32)
    rounded = torch.from_numpy(x).to(torch.bfloat16).float()
    assert not torch.equal(rounded, torch.from_numpy(x))
    with torch.no_grad():
        want = torch.nn.functional.normalize(engine.model.encode_image(rounded), dim=-1)
        raw = torch.nn.functional.normalize(engine.model.encode_image(torch.from_numpy(x)),
                                            dim=-1)
    got = engine.encode_image(x)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)
    assert np.abs(got - raw.numpy()).max() > 1e-5  # the rounding is visible
    np.testing.assert_allclose(got, jax_engine.encode_image(x), atol=TOL, rtol=0)


def test_warmup_and_caption_refusal(engines):
    _, engine = engines
    engine.warmup()
    with pytest.raises(TypeError, match="CoCa"):
        engine.caption_tokens(images(1, 16))


def test_create_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        create_engine("tiny-torch-engine", warm=False)


def test_create_engine_on_cpu_with_checkpoint(tmp_path):
    """A local state-dict checkpoint serves the same features as the model
    it was saved from."""
    from refining_clip_via_dinov2_representations_torch.models import jax_params_to_state_dict

    _, variables = jax_clip(TINY_CFG, seed=5)
    path = tmp_path / "tiny.pt"
    torch.save(jax_params_to_state_dict(variables["params"]), path)
    engine, preprocess, tokenizer = create_engine(
        "tiny-torch-engine", checkpoint=str(path), device="cpu", buckets=(2,))
    assert engine.device.type == "cpu" and tuple(preprocess.image_size) == (16, 16)
    model = port_clip(TINY_CFG, variables["params"])
    ids = tokenizer(["a cat", "a dog", "a bird"])
    want = ClipInferenceEngine(model, (16, 16), 12, buckets=(2,)).encode_text(ids)
    np.testing.assert_array_equal(engine.encode_text(ids), want)
    with pytest.raises(RuntimeError, match="local checkpoint"):
        create_model("tiny-torch-engine", pretrained="openai", device="cpu")
