"""Pretrained checkpoints in the port against the JAX package: the tag
registry, the offline resolver (the hub-cache layout picks the file
``huggingface_hub.try_to_load_from_cache`` picks, the URL layout checks the
sha256 as the JAX ``_sha_ok`` does, a missing file raises naming its paths
with the network blocked), the safetensors reader against the package,
``load_state_dict``'s four formats, and ``load_checkpoint``'s positional
resizing (vision 7 -> 4 and 4 -> 7 grids, text truncation and linear
growth) against the JAX ``load_checkpoint`` within 1e-5, with the same
missing and unexpected keys under ``strict=False``."""

import logging
import os
import socket
import urllib.request

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    create_model,
    create_model_and_transforms,
    create_model_from_pretrained,
    load_checkpoint,
    load_state_dict,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import pretrained
from refining_clip_via_dinov2_representations_torch.models._safetensors import (
    read_safetensors,
)
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.models.openai import save_openai_archive

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

TOL = 1e-5
HUB_ID = "timm/vit_base_patch16_clip_224.openai"


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to reach a host fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"network access attempted: {args[:2]}")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)


def _cfg(**vision):
    return {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], **vision}}


def test_registry_equals_jax():
    from refining_clip_via_dinov2_representations_tpu.models import pretrained as jp

    assert pretrained._PRETRAINED == jp._PRETRAINED
    assert len(pretrained._PRETRAINED) == 99 and len(pretrained.list_pretrained()) == 180
    assert pretrained.list_pretrained(as_str=True) == jp.list_pretrained(as_str=True)
    for tag in ("openai", "laion2b-s34b-b88k", "OPENAI"):
        got = pretrained.list_pretrained_models_by_tag(tag)
        assert got == jp.list_pretrained_models_by_tag(tag)
    for model, tag in jp.list_pretrained():
        assert pretrained.get_pretrained_cfg(model, tag) == jp.get_pretrained_cfg(model, tag)
        assert pretrained.is_pretrained_cfg(model, tag.replace("_", "-"))
        assert pretrained.get_pretrained_url(model, tag) == jp.get_pretrained_url(model, tag)
    assert pretrained.list_pretrained_tags_by_model("ViT-B-16") == (
        jp.list_pretrained_tags_by_model("ViT-B-16"))
    assert pretrained.get_pretrained_cfg("no-such-model", "openai") == {}


def _hub_repo(cache, files, revision="abc123", other=("old999",)):
    """The hub-cache layout of ``HUB_ID``: ``refs/main`` naming
    ``revision``, which holds ``files``; older snapshots hold every file."""
    repo = cache / ("models--" + HUB_ID.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(revision)
    for rev, names in [(revision, files)] + [(o, ("open_clip_model.safetensors",
                                                   "open_clip_pytorch_model.bin")) for o in other]:
        snap = repo / "snapshots" / rev
        snap.mkdir(parents=True)
        for name in names:
            (snap / name).write_bytes(f"{rev}/{name}".encode())
    return repo


@pytest.mark.parametrize("files", [("open_clip_pytorch_model.bin",),
                                   ("open_clip_model.safetensors",),
                                   ("open_clip_pytorch_model.bin", "open_clip_model.safetensors")],
                         ids=["bin", "safetensors", "both"])
def test_hub_cache_resolution_picks_what_huggingface_hub_picks(tmp_path, files, no_network):
    from huggingface_hub import try_to_load_from_cache

    _hub_repo(tmp_path, files)
    cfg = pretrained.get_pretrained_cfg("ViT-B-16", "openai")
    got = pretrained.resolve_pretrained(cfg, cache_dir=str(tmp_path))
    # the JAX package asks for the safetensors alternative first
    want = next(p for p in (try_to_load_from_cache(HUB_ID, name, cache_dir=str(tmp_path))
                            for name in ("open_clip_model.safetensors",
                                         "open_clip_pytorch_model.bin"))
                if isinstance(p, str))
    assert got == want and "/snapshots/abc123/" in got


def test_hub_cache_without_refs_takes_the_snapshots_in_order(tmp_path):
    snap = tmp_path / ("models--" + HUB_ID.replace("/", "--")) / "snapshots"
    for rev in ("b", "a"):
        (snap / rev).mkdir(parents=True)
    (snap / "b" / "open_clip_pytorch_model.bin").write_bytes(b"x")
    assert pretrained.resolve_hf_file(HUB_ID, cache_dir=str(tmp_path)) == str(
        snap / "b" / "open_clip_pytorch_model.bin")
    assert pretrained.hub_snapshot_dirs(HUB_ID, str(tmp_path)) == [str(snap / "a"),
                                                                    str(snap / "b")]


def test_url_layout_checks_the_sha_as_jax(tmp_path, no_network):
    import hashlib

    from refining_clip_via_dinov2_representations_tpu.models import pretrained as jp

    path = tmp_path / "tiny.pt"
    path.write_bytes(b"seeded archive bytes")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    url = f"https://openaipublic.azureedge.net/clip/models/{digest}/tiny.pt"
    got = pretrained.resolve_url_file(url, cache_dir=str(tmp_path))
    assert got == jp.download_pretrained_from_url(url, cache_dir=str(tmp_path)) == str(path)
    bad = f"https://openaipublic.azureedge.net/clip/models/{'0' * 64}/tiny.pt"
    assert pretrained.sha_ok(str(path), digest[:10]) == jp._sha_ok(str(path), digest[:10])
    assert pretrained.sha_ok(str(path), "0" * 64) == jp._sha_ok(str(path), "0" * 64) is False
    with pytest.raises(FileNotFoundError, match="sha256 does not start with") as e:
        pretrained.resolve_url_file(bad, cache_dir=str(tmp_path))
    assert str(path) in str(e.value) and bad in str(e.value)
    plain = "https://example.org/weights/tiny.pt"  # no digest in the URL: no check
    assert pretrained.resolve_url_file(plain, cache_dir=str(tmp_path)) == str(path)


def test_missing_files_raise_naming_their_paths_without_the_network(tmp_path, no_network,
                                                                    monkeypatch):
    cache = str(tmp_path / "cache")
    with pytest.raises(FileNotFoundError) as e:
        create_model("ViT-B-16", pretrained="openai", cache_dir=cache, device="cpu")
    msg = str(e.value)
    assert HUB_ID in msg and os.path.join(cache, "models--timm--vit_base_patch16_clip_224."
                                          "openai", "snapshots", "*") in msg
    _hub_repo(tmp_path / "cache", ("README.md",))
    with pytest.raises(FileNotFoundError) as e:
        create_model_from_pretrained("ViT-B-16", "openai", cache_dir=cache, device="cpu")
    snap = os.path.join(cache, "models--timm--vit_base_patch16_clip_224.openai", "snapshots",
                        "abc123")
    for name in ("open_clip_model.safetensors", "open_clip_pytorch_model.bin"):
        assert os.path.join(snap, name) in str(e.value)
    # without a cache_dir: the JAX package's cache and huggingface_hub's
    monkeypatch.setattr(pretrained, "CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hf_cache"))
    with pytest.raises(FileNotFoundError) as e:
        pretrained.resolve_pretrained(pretrained.get_pretrained_cfg("ViT-B-16", "openai"))
    assert str(tmp_path / "jax_cache") in str(e.value) and str(tmp_path / "hf_cache") in str(
        e.value)
    with pytest.raises(FileNotFoundError, match="ViT-B-16.pt"):
        pretrained.resolve_pretrained(pretrained.get_pretrained_cfg("ViT-B-16", "openai"),
                                      prefer_hf_hub=False)
    with pytest.raises(RuntimeError, match="not one of its tags"):
        create_model("ViT-B-16", pretrained="no-such-tag", device="cpu")


@pytest.mark.parametrize("packaged", [True, False], ids=["package", "own-reader"])
def test_safetensors_reader_equals_the_package(tmp_path, packaged, monkeypatch):
    from safetensors.torch import load_file, save_file

    from refining_clip_via_dinov2_representations_torch.models import _safetensors

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, generator=g).bfloat16(),
               "f64": torch.randn(4, generator=g).double(), "i64": torch.arange(-3, 6),
               "i32": torch.arange(5, dtype=torch.int32), "u8": torch.arange(9, dtype=torch.uint8),
               "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
               "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    if not packaged:
        monkeypatch.setitem(__import__("sys").modules, "safetensors.torch", None)
    got = _safetensors.load_safetensors(path)
    assert set(got) == set(want) == set(read_safetensors(path))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)


def test_load_state_dict_reads_every_format_as_jax(tmp_path):
    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        load_state_dict as jax_load_state_dict,
    )
    from safetensors.torch import save_file

    _, variables = jax_clip(TINY_CFG, seed=4)
    sd = jax_params_to_state_dict(variables["params"])
    paths = {"bin": str(tmp_path / "w.bin"), "epoch": str(tmp_path / "epoch_1.pt"),
             "safetensors": str(tmp_path / "w.safetensors"), "npz": str(tmp_path / "w.npz"),
             "torchscript": str(tmp_path / "ts.pt")}
    torch.save(sd, paths["bin"])
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "step": 3},
               paths["epoch"])
    save_file(sd, paths["safetensors"])
    np.savez(paths["npz"], **{k: v.numpy() for k, v in sd.items()})
    save_openai_archive(sd, paths["torchscript"], dtype=torch.float32)
    for fmt, path in paths.items():
        got, want = load_state_dict(path), jax_load_state_dict(path)
        assert set(got) == set(want) == set(sd), fmt
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=fmt)
            np.testing.assert_array_equal(np.asarray(want[k]), v.numpy(), err_msg=fmt)


@pytest.mark.parametrize("src,dst", [((56, 12), (32, 8)), ((32, 8), (56, 16))],
                         ids=["grid7to4-text-truncate", "grid4to7-text-linear"])
def test_load_checkpoint_resizes_positions_as_jax(tmp_path, src, dst):
    """A checkpoint of one (image size, context length) into a model of
    another: vision grids 7 <-> 4 at patch 8, text 12 -> 8 (truncated) and
    8 -> 16 (linear); the checkpoint lacks ``logit_scale`` and adds
    ``logit_bias``, so ``strict=False`` reports both as in JAX."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        load_checkpoint as jax_load_checkpoint,
    )

    def cfg(size, ctx):
        return {**_cfg(image_size=size), "text_cfg": {**TINY_CFG["text_cfg"],
                                                      "context_length": ctx}}

    _, src_vars = jax_clip(cfg(*src), seed=6)
    sd = jax_params_to_state_dict(src_vars["params"])
    sd.pop("logit_scale")
    sd["logit_bias"] = torch.tensor([-1.5])
    path = str(tmp_path / "src.bin")
    torch.save(sd, path)

    jmodel, dst_vars = jax_clip(cfg(*dst), seed=7)
    new_vars, (jmissing, junexpected) = jax_load_checkpoint(jmodel, dst_vars, path, strict=False)
    model = port_clip(cfg(*dst), dst_vars["params"])
    missing, unexpected = load_checkpoint(model, path, strict=False)
    assert (missing, unexpected) == (jmissing, junexpected) == (["logit_scale"], ["logit_bias"])
    params = jax.device_get(new_vars["params"])
    got = model.state_dict()
    for key, want in (("visual.positional_embedding", params["visual"]["positional_embedding"]),
                      ("positional_embedding", params["text"]["positional_embedding"])):
        assert tuple(got[key].shape) == np.shape(want)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want), atol=TOL, rtol=0,
                                   err_msg=key)
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        load_checkpoint(model, path, strict=True)


def test_pretrained_tag_from_the_hub_cache_serves_the_written_weights(tmp_path, caplog,
                                                                      monkeypatch, no_network):
    """A tag of a tiny registered model resolved from the hub cache: the
    weights are the file's, the tag's preprocess statistics are merged, a
    tag that expects QuickGELU under a GELU config gets the JAX warning and
    keeps GELU; the JAX package on the same file by path gives the same
    features within 1e-5."""
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import create_model as jax_create
    from refining_clip_via_dinov2_representations_tpu.models import (
        register_model_config as jax_register,
    )

    name = "tiny-torch-pretrained-test"
    register_model_config(name, TINY_CFG)
    jax_register(name, TINY_CFG)
    tag = {"hf_hub": "example/tiny-clip/", "quick_gelu": True, "mean": (0.5, 0.5, 0.5),
           "std": (0.25, 0.25, 0.25), "interpolation": "bilinear", "url": ""}
    monkeypatch.setitem(pretrained._PRETRAINED, name, {"demo": tag})
    _, variables = jax_clip(TINY_CFG, seed=8)
    snap = tmp_path / "models--example--tiny-clip" / "snapshots" / "r1"
    snap.mkdir(parents=True)
    torch.save(jax_params_to_state_dict(variables["params"]),
               snap / "open_clip_pytorch_model.bin")
    with caplog.at_level(logging.WARNING):
        model, pp = create_model(name, pretrained="demo", cache_dir=str(tmp_path), device="cpu")
    assert "expects QuickGELU" in caplog.text
    assert model.visual.transformer.resblocks[0].mlp.act.__name__ == "gelu"
    assert (pp.mean, pp.std, pp.interpolation, pp.size) == ((0.5,) * 3, (0.25,) * 3,
                                                           "bilinear", 16)
    # the transforms keep the tag's statistics unless an image_* argument is
    # given (the reference's rule; the JAX package's create_model_and_transforms
    # resets them to OpenAI's: ROADMAP Queue 3)
    _, val = create_model_and_transforms(name, "demo", cache_dir=str(tmp_path), device="cpu")
    assert (tuple(val.mean), tuple(val.std)) == ((0.5,) * 3, (0.25,) * 3)
    _, val = create_model_and_transforms(name, "demo", cache_dir=str(tmp_path), device="cpu",
                                         image_mean=(0.1, 0.2, 0.3))
    assert (tuple(val.mean), tuple(val.std)) == ((0.1, 0.2, 0.3), (0.25,) * 3)
    jmodel, jvars, _ = jax_create(name, pretrained=str(snap / "open_clip_pytorch_model.bin"))
    x, ids = images(2, 16), token_ids(3, 12)
    with torch.no_grad():
        got = (model.encode_image(torch.from_numpy(x), normalize=True).numpy(),
               model.encode_text(torch.from_numpy(ids).long(), normalize=True).numpy())
    want = (np.asarray(jmodel.apply(jvars, jnp.asarray(x), method="encode_image", normalize=True)),
            np.asarray(jmodel.apply(jvars, jnp.asarray(ids), method="encode_text",
                                    normalize=True)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_hf_hub_model_name_reads_its_config_and_weights_from_the_cache(tmp_path, no_network):
    """``hf-hub:<org>/<name>``: the model config and preprocess config from
    the cached ``open_clip_config.json``, the weights from the same
    snapshot; the tokenizer takes the config's context length."""
    import json

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    _, variables = jax_clip(TINY_CFG, seed=9)
    snap = tmp_path / "models--example--hub-clip" / "snapshots" / "r2"
    snap.mkdir(parents=True)
    sd = jax_params_to_state_dict(variables["params"])
    torch.save(sd, snap / "open_clip_pytorch_model.bin")
    (snap / "open_clip_config.json").write_text(json.dumps(
        {"model_cfg": TINY_CFG, "preprocess_cfg": {"mean": [0.5, 0.5, 0.5],
                                                   "interpolation": "bilinear"}}))
    model, pp = create_model("hf-hub:example/hub-clip", cache_dir=str(tmp_path), device="cpu")
    assert (pp.mean, pp.interpolation, pp.size) == ([0.5, 0.5, 0.5], "bilinear", 16)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k].reshape(v.shape), atol=0, rtol=0)
    tok = get_tokenizer("hf-hub:example/hub-clip", cache_dir=str(tmp_path))
    assert tok.context_length == TINY_CFG["text_cfg"]["context_length"]
