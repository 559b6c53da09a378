"""The port's DINOv2 teacher model against the JAX package's.

Seeded JAX ``Dinov2`` parameters (perturbed off their init constants) are
carried into the port with ``jax_dinov2_params_to_state_dict``; HF
checkpoints (``transformers.Dinov2Model`` with a seeded random init, saved
with ``save_pretrained``) are read by both ``load_dinov2_model``s. Nothing
is downloaded. Tolerances: CLS features and tokens within 2e-4 absolute and
relative in fp32 (``tests/test_dinov2.py``'s HF tolerance); the bicubic
position-table resizes within 1e-5 of ``jax.image.resize`` (fp32 rounding
of the same antialiased kernel); the 384 -> 378 image resize within 2e-5:
on normal pixels (up to about 5) each fp32 resize, the port's and JAX's,
lies 2.5e-4 from torch's float64 one, and the two agree to 1.4e-5 at worst
of 857k values. The ``cuda``-marked test holds the fused kernel path
against the plain one on the card.
"""

import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models.dinov2 import (
    Dinov2,
    Dinov2Cfg,
    load_dinov2_model,
    resize_position_table,
    save_hf_checkpoint,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention_bwd,
    fused_attention_fwd,
)
from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
    resize_for_teacher,
)

from .torch_port_utils import DINO_TINY, jax_dinov2, port_dinov2

TOL = dict(atol=2e-4, rtol=2e-4)
TINY = {k: v for k, v in DINO_TINY.items() if k != "native_image_size"}


def _hf_dir(path, use_swiglu: bool, safetensors: bool, image_size: int = 42) -> str:
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(0)
    hf = Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                  mlp_ratio=2, patch_size=14, image_size=image_size,
                                  use_swiglu_ffn=use_swiglu))
    hf.save_pretrained(path, safe_serialization=safetensors)
    return str(path)


def _pixels(n: int, size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("size", [28, 42], ids=["resized-table", "native-table"])
@pytest.mark.parametrize("use_swiglu", [False, True], ids=["gelu", "swiglu"])
def test_port_matches_jax_dinov2_on_seeded_params(use_swiglu, size):
    import jax.numpy as jnp

    jmodel, variables = jax_dinov2(use_swiglu)
    model = port_dinov2(variables["params"], use_swiglu)
    x = _pixels(3, size)
    want_cls, want_tok = jmodel.apply(variables, jnp.asarray(x), output_tokens=True)
    with torch.no_grad():
        cls, tok = model(torch.from_numpy(x), output_tokens=True)
        nhwc = model(torch.from_numpy(x).permute(0, 2, 3, 1))
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), **TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), **TOL)
    torch.testing.assert_close(nhwc, cls, atol=0, rtol=0)


@pytest.mark.parametrize("safetensors", [False, True], ids=["bin", "safetensors"])
@pytest.mark.parametrize("use_swiglu", [False, True], ids=["gelu", "swiglu"])
def test_hf_directory_loads_into_both_packages(tmp_path, use_swiglu, safetensors):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.dinov2 import (
        load_dinov2_model as jax_load,
    )

    path = _hf_dir(tmp_path / "hf", use_swiglu, safetensors)
    weights = "model.safetensors" if safetensors else "pytorch_model.bin"
    assert os.path.isfile(os.path.join(path, weights))
    model = load_dinov2_model(path, device="cpu", attn_impl="xla")
    assert not model.training and model.cfg.native_image_size == 42
    assert model.cfg.norm_eps == 1e-6 and model.cfg.use_swiglu_ffn == use_swiglu
    jmodel, variables = jax_load(path)
    for size in (28, 42):
        x = _pixels(2, size, seed=size)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        want = jmodel.apply(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hub_cache_snapshot_loads_by_name(tmp_path):
    repo = tmp_path / "hub" / "models--facebook--dinov2-small"
    _hf_dir(repo / "snapshots" / "abc123", False, False)
    model = load_dinov2_model("facebook/dinov2-small", cache_dir=str(tmp_path / "hub"),
                              device="cpu")
    assert model.cfg.hidden_size == 32 and model.encoder.layer[0].attention.attn_impl == "auto"


def test_missing_checkpoint_raises_naming_the_paths(tmp_path):
    with pytest.raises(FileNotFoundError) as err:
        load_dinov2_model("facebook/dinov2-small", cache_dir=str(tmp_path), device="cpu")
    msg = str(err.value)
    assert "'facebook/dinov2-small'" in msg and "does not download" in msg
    assert os.path.join(str(tmp_path), "models--facebook--dinov2-small", "snapshots") in msg


def test_saved_checkpoint_reads_in_transformers(tmp_path):
    """``save_hf_checkpoint`` (what ``chip_smoke.py`` writes at dinov2-small's
    config) is an HF directory: transformers reads it and computes the same
    CLS features at the native grid."""
    from transformers import Dinov2Model

    model = Dinov2(Dinov2Cfg(**TINY, native_image_size=28)).init_weights(seed=3).eval()
    path = save_hf_checkpoint(model, str(tmp_path / "seeded"))
    hf = Dinov2Model.from_pretrained(path).eval()
    x = torch.from_numpy(_pixels(2, 28))
    with torch.no_grad():
        torch.testing.assert_close(model(x), hf(x).last_hidden_state[:, 0], **TOL)
    again = load_dinov2_model(path, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("n,m", [(37, 16), (16, 24)], ids=["37to16", "16to24"])
def test_position_table_resize_matches_jax(n, m):
    import jax
    import jax.numpy as jnp

    table = np.random.default_rng(n).normal(size=(n, n, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(table), (m, m, 8), method="cubic")
    got = resize_position_table(torch.from_numpy(table), (m, m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_resize_for_teacher_matches_jax_at_384():
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.train.dino_teacher import (
        resize_for_teacher as jax_resize,
    )

    x = np.random.default_rng(4).normal(size=(2, 384, 384, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x)))
    got = resize_for_teacher(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == tuple(got.shape) == (2, 378, 378, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    same = torch.zeros(1, 3, 224, 224)
    assert resize_for_teacher(same) is same


def test_fused_impl_matches_xla_on_the_cpu():
    """``"fused"`` on CPU tensors runs the kernel's plain version."""
    _, variables = jax_dinov2()
    out = {}
    for impl in ("xla", "fused", "auto"):
        model = port_dinov2(variables["params"], attn_impl=impl)
        with torch.no_grad():
            out[impl] = model(torch.from_numpy(_pixels(2, 42)))
    torch.testing.assert_close(out["fused"], out["xla"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out["auto"], out["xla"], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,min_cos", [(torch.float32, 0.9999), (torch.bfloat16, 0.999)])
def test_cuda_teacher_runs_the_fused_forward_only(dtype, min_cos):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Dinov2Cfg(native_image_size=518)  # dinov2-small
    model = Dinov2(cfg, dtype=dtype, attn_impl="auto").cuda().init_weights(0).eval()
    plain = Dinov2(cfg, dtype=dtype, attn_impl="xla").cuda().eval()
    plain.load_state_dict(model.state_dict())
    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(0)).cuda()
    before = fused_attention_fwd.launches, fused_attention_bwd.launches
    with torch.no_grad():
        got = model(x).float()
        want = plain(x).float()
    torch.cuda.synchronize()
    assert fused_attention_fwd.launches == before[0] + 12
    assert fused_attention_bwd.launches == before[1]
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= min_cos
