"""OpenAI checkpoints in the port against the JAX package: the architecture
inferred from an archive's shapes (the registry's ViTs and a tiny one), and a
tiny OpenAI-layout TorchScript archive of fp16 weights (with the
``input_resolution``, ``context_length`` and ``vocab_size`` scalars) loaded
by ``load_openai_model`` in both packages: ``encode_image`` and
``encode_text`` within 1e-5 in fp32, the weights the archive's fp16 values
exactly. Nothing is downloaded."""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    get_model_config,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models.clip import CLIP
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.models.openai import (
    infer_openai_config,
    list_openai_models,
    load_openai_model,
    load_openai_state_dict,
    save_openai_archive,
)

from .torch_port_utils import OPENAI_TINY_CFG, images, jax_clip, token_ids

TOL = 1e-5
TINY = "tiny-openai-archive-test"
register_model_config(TINY, OPENAI_TINY_CFG)


def _meta_state_dict(cfg_dict):
    """The state dict's shapes of a config, without memory."""
    cfg = parse_model_cfg(cfg_dict)
    with torch.device("meta"):
        model = CLIP(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg, quick_gelu=cfg.quick_gelu)
    return model.state_dict()


@pytest.mark.parametrize("name", ["ViT-B-16", "ViT-B-32", "ViT-L-14-336", TINY])
def test_infer_openai_config_matches_jax(name):
    from refining_clip_via_dinov2_representations_tpu.models.openai import (
        infer_openai_config as jax_infer,
    )

    cfg_dict = get_model_config(name)
    sd = _meta_state_dict(cfg_dict)
    got = infer_openai_config(sd)
    assert got == jax_infer(sd)
    got_cfg, want_cfg = parse_model_cfg(got), parse_model_cfg(cfg_dict)
    for tower in ("vision_cfg", "text_cfg"):
        g, w = getattr(got_cfg, tower), getattr(want_cfg, tower)
        assert (g.width, g.layers, g.heads) == (w.width, w.layers, w.heads)
    assert got_cfg.vision_cfg.image_size == want_cfg.vision_cfg.image_size
    assert got_cfg.quick_gelu


def test_openai_model_list_matches_jax():
    from refining_clip_via_dinov2_representations_tpu.models.openai import (
        list_openai_models as jax_list,
    )

    assert list_openai_models() == jax_list() and "ViT-B-16" in list_openai_models()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny OpenAI-layout archive of seeded weights in fp16, and the JAX
    params it came from."""
    _, variables = jax_clip(OPENAI_TINY_CFG, seed=11)
    path = str(tmp_path_factory.mktemp("openai") / "tiny-openai.pt")
    save_openai_archive(jax_params_to_state_dict(variables["params"]), path)
    return path


def test_archive_holds_openai_scalars_and_fp16_weights(archive):
    raw = torch.jit.load(archive, map_location="cpu").state_dict()
    assert {k: int(raw[k]) for k in ("input_resolution", "context_length", "vocab_size")} == {
        "input_resolution": 16, "context_length": 12, "vocab_size": 49408}
    assert raw["visual.proj"].dtype == torch.float16
    sd = load_openai_state_dict(archive)
    assert not {"input_resolution", "context_length", "vocab_size"} & set(sd)
    model = load_openai_model(archive, device="cpu")
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, sd[k].float().reshape(v.shape), atol=0, rtol=0)


def test_load_openai_model_matches_jax(archive):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.openai import (
        load_openai_model as jax_load,
    )

    jmodel, jvars = jax_load(archive)
    model = load_openai_model(archive, device="cpu")
    assert model.visual.transformer.resblocks[0].mlp.act.__name__ == "quick_gelu"
    x, ids = images(3, 16), token_ids(4, 12)
    want_img = np.asarray(jmodel.apply(jvars, jnp.asarray(x), method="encode_image",
                                       normalize=True))
    want_txt = np.asarray(jmodel.apply(jvars, jnp.asarray(ids), method="encode_text",
                                       normalize=True))
    with torch.no_grad():
        got_img = model.encode_image(torch.from_numpy(x), normalize=True).numpy()
        got_txt = model.encode_text(torch.from_numpy(ids).long(), normalize=True).numpy()
    np.testing.assert_allclose(got_img, want_img, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_txt, want_txt, atol=TOL, rtol=0)


def test_archive_by_path_through_create_model(archive):
    """``create_model(name, pretrained=<archive>)``: the TorchScript branch of
    ``load_state_dict``, the same weights as ``load_openai_model``."""
    model, _ = create_model(TINY, archive, device="cpu")
    want = load_openai_model(archive, device="cpu").state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0)


def test_openai_name_without_the_archive_raises_naming_the_url_and_path(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        load_openai_model("ViT-B-16", device="cpu", cache_dir=str(tmp_path))
    msg = str(e.value)
    assert str(tmp_path / "ViT-B-16.pt") in msg and "openaipublic" in msg
    with pytest.raises(RuntimeError, match="available openai models"):
        load_openai_model("no-such-model", device="cpu", cache_dir=str(tmp_path))


def test_without_a_card_the_openai_model_raises(archive):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        load_openai_model(archive)


@pytest.mark.cuda
def test_cuda_openai_model_runs_the_fused_forward(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from refining_clip_via_dinov2_representations_torch.models import build_model
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    path = save_openai_archive(build_model(parse_model_cfg(OPENAI_TINY_CFG), seed=3).state_dict(),
                               str(tmp_path / "seeded.pt"))
    x, ids = images(3, 16), token_ids(4, 12)
    out = {}
    for device in ("cuda", "cpu"):
        model = load_openai_model(path, device=device)
        before = fused_attention_fwd.launches
        with torch.no_grad():
            out[device] = (model.encode_image(torch.from_numpy(x).to(device), normalize=True),
                           model.encode_text(torch.from_numpy(ids).long().to(device),
                                             normalize=True))
        if device == "cuda":
            torch.cuda.synchronize()
            assert fused_attention_fwd.launches == before + 4  # two layers a tower
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
