"""The port's SigLIP against the JAX package's, on the CPU.

* The tower (``models/siglip.py``): a tiny ``SiglipVisionTower`` (width 32,
  2 layers, 4 heads, MLP 64, patch 8) loaded strictly from the JAX
  exporter's timm layout, at its native 16 tokens and at a 48-px input
  (positions resized bicubically), with and without ``output_tokens``,
  under ``"fused"`` against the JAX tower with its Pallas kernel
  interpreted: fp32 within 1e-5 of the largest |value|.
* The fused calls: every one takes contiguous q, k and v; the MAP head's
  one probe query over the tokens (Lq = 1) takes the fused route; a
  checkpointed step makes 2L + 1 forward calls, 2L recomputed (the blocks
  only, not the head, as the JAX remat scope) and 2L + 1 backward.
* The text tower's SigLIP options, one by one, against the JAX tower.
* The whole model, its ``_SIGLIP_FAMILY_DIMS`` patched in both packages at
  run time: loaded strictly from ``flax_params_to_torch_state_dict``; the
  features, ``logit_scale``, ``logit_bias``, the SigLIP loss and every
  gradient against the JAX model's (plain attention, the kernel's
  reference) within 1e-5 (of the largest |gradient| for the gradients).
* The registry: every ``*-SigLIP*`` name builds (on the meta device) with
  the JAX tower dims and text config; ``_gap`` trunks and the ``nllb``
  names raise naming their ROADMAP items.
* A hub checkpoint by tag, ``create_engine`` serving, and Config 4's flags
  through both CLIs at fp32 (per-step losses within 1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    get_model_config,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import siglip as tsiglip
from refining_clip_via_dinov2_representations_torch.models.clip import (
    CLIP,
    _build_text_tower,
    build_model,
)
from refining_clip_via_dinov2_representations_torch.models.config import CLIPTextCfg
from refining_clip_via_dinov2_representations_torch.models.convert import (
    _emit_text,
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.ops import attention
from refining_clip_via_dinov2_representations_torch.ops import fused_attention as fused_mod

from .torch_port_utils import images, jax_clip, offline, seed_hub_snapshot  # noqa: F401

TINY_DIMS = (32, 2, 4, 64)  # width, layers, heads, mlp_dim for the "base" family
# ViT-B-16-SigLIP's config at tiny widths: the same tower family, text options
# and tokenizer, a 32-px image (16 tokens at patch 8), 16 text tokens
TINY_SIGLIP = {
    "embed_dim": 32, "custom_text": True, "init_logit_bias": -10,
    "vision_cfg": {"image_size": 32, "timm_model_name": "vit_base_patch8_siglip_32",
                   "timm_model_pretrained": False, "timm_pool": "map", "timm_proj": "none"},
    "text_cfg": {"context_length": 16, "vocab_size": 256, "width": 32, "heads": 4,
                 "layers": 2, "hf_tokenizer_name": "timm/ViT-B-16-SigLIP",
                 "tokenizer_kwargs": {"clean": "canonicalize"}, "no_causal_mask": True,
                 "norm_kwargs": {"eps": 1e-6}, "pool_type": "last", "proj_bias": True},
}
MODEL = "tiny-torch-siglip-test"
SIGLIP_NAMES = sorted(n for n in __import__(
    "refining_clip_via_dinov2_representations_tpu.models._registry_data",
    fromlist=["MODEL_CONFIGS"]).MODEL_CONFIGS if "siglip" in n.lower())


@pytest.fixture
def tiny_dims(monkeypatch):
    """The "base" SigLIP family at tiny dims in both packages (a runtime
    patch of each module's dict)."""
    from refining_clip_via_dinov2_representations_tpu.models import siglip as jsiglip

    monkeypatch.setitem(jsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    monkeypatch.setitem(tsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _perturbed(variables, seed, noise=0.05):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, noise, np.shape(x)).astype(
        np.float32), jax.device_get(variables["params"]))


def _ids(n, length, vocab=256, seed=2):
    return np.random.default_rng(seed).integers(3, vocab, (n, length)).astype(np.int32)


# ---------------------------------------------------------------- the tower

def _tower_pair(output_tokens: bool):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.siglip import (
        SiglipVisionCfg as JaxCfg, SiglipVisionTower as JaxTower,
        siglip_vision_params_to_timm_state_dict,
    )

    dims = dict(width=32, layers=2, heads=4, mlp_dim=64, patch_size=8, image_size=32)
    jtower = JaxTower(cfg=JaxCfg(**dims), output_tokens=output_tokens, attn_impl="fused")
    params = _perturbed(jax.jit(jtower.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
                        seed=3)
    tower = tsiglip.SiglipVisionTower(tsiglip.SiglipVisionCfg(**dims),
                                      output_tokens=output_tokens, attn_impl="fused")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          siglip_vision_params_to_timm_state_dict(params, prefix="trunk.").items()}
    tower.load_state_dict(sd, strict=True)
    return jtower, params, tower.eval()


@pytest.mark.parametrize("size", [32, 48])
@pytest.mark.parametrize("output_tokens", [False, True])
def test_tower_matches_jax(size, output_tokens):
    """16 tokens at 32 px; 36 at 48 px through positions resized from the
    4 x 4 table; fp32 within 1e-5."""
    import jax.numpy as jnp

    jtower, params, tower = _tower_pair(output_tokens)
    x = images(3, size, seed=4)
    want = jtower.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    if not output_tokens:
        got, want = (got,), (want,)
    else:
        assert tuple(got[1].shape) == (3, (size // 8) ** 2, 32)
    assert tuple(got[0].shape) == (3, 32)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    with torch.no_grad():  # NCHW at the boundary, as the JAX tower takes it
        nchw = tower(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(nchw if not output_tokens else nchw[0], got[0])


def test_fused_calls_are_contiguous_and_the_probe_takes_the_fused_route(monkeypatch):
    """Every fused call's q, k and v are contiguous, as the CUDA wrappers
    require; the MAP head's [b, 4, 1, 8] probe over 16 keys reaches the
    fused kernel's route (the kernels' plain versions on the CPU)."""
    _, _, tower = _tower_pair(False)
    shapes, kernel_call = [], attention.fused_attention

    def contiguous_only(q, k, v, scale, causal):
        assert all(t.is_contiguous() for t in (q, k, v))
        shapes.append((tuple(q.shape), tuple(k.shape), causal))
        return kernel_call(q, k, v, scale, causal)

    monkeypatch.setattr(attention, "fused_attention", contiguous_only)
    with torch.no_grad():
        tower(torch.from_numpy(images(2, 32, seed=5)))
    block = ((2, 4, 16, 8), (2, 4, 16, 8), False)
    assert shapes == [block, block, ((2, 4, 1, 8), (2, 4, 16, 8), False)]


# --------------------------------------------------------- the text options

TEXT_OPTIONS = {
    "clip default": {},
    "no_causal_mask, last": {"no_causal_mask": True, "pool_type": "last"},
    "first": {"pool_type": "first"},
    "proj_bias": {"proj_bias": True},
    "proj_type none": {"proj_type": "none"},
    "norm eps": {"norm_kwargs": {"eps": 1e-6}},
    "tanh gelu in fp32": {"act_kwargs": {"approximate": "tanh"}},
    "ViT-B-16-SigLIP's": {"no_causal_mask": True, "pool_type": "last", "proj_bias": True,
                          "norm_kwargs": {"eps": 1e-6}},
}


@pytest.mark.parametrize("option", list(TEXT_OPTIONS))
def test_text_option_matches_jax(option):
    """Each option through the JAX ``_build_text_tower`` and the port's,
    one set of weights (``models/convert.py:_emit_text``): fp32 within 1e-5
    of the largest |value|; a non-causal tower reaches the fused route with
    ``causal=False``."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import clip as jclip
    from refining_clip_via_dinov2_representations_tpu.models.config import (
        CLIPTextCfg as JaxTextCfg,
    )

    opts = dict(context_length=12, vocab_size=64, width=32, heads=4, layers=2,
                **TEXT_OPTIONS[option])
    jtower = jclip._build_text_tower(24, JaxTextCfg(**opts), False, jnp.float32, "fused", False)
    ids = _ids(3, 12, vocab=64, seed=6)
    params = _perturbed(jax.jit(jtower.init)(jax.random.PRNGKey(1), jnp.asarray(ids)), seed=7)
    tower = _build_text_tower(24, CLIPTextCfg(**opts), False, torch.float32, "fused")
    sd = {}
    _emit_text(sd, params, "")
    tower.load_state_dict(sd, strict=True)
    calls = []
    real = attention.fused_attention
    try:
        attention.fused_attention = lambda *a: calls.append(a[4]) or real(*a)
        with torch.no_grad():
            got = tower.eval()(torch.from_numpy(ids).long())
    finally:
        attention.fused_attention = real
    want = jtower.apply({"params": params}, jnp.asarray(ids))
    assert tuple(got.shape) == (3, 32 if option == "proj_type none" else 24)
    assert _rel(got, want) <= 1e-5
    assert calls == [not opts.get("no_causal_mask", False)] * 2


# -------------------------------------------------------- the whole model

def _jax_siglip(cfg=TINY_SIGLIP, seed=0):
    """The JAX SigLIP with plain attention (the Pallas kernel's reference;
    the tower tests above hold the interpreted kernel), init compiled."""
    return jax_clip(cfg, attn_impl="xla", seed=seed, noise=0.05, jit=True)


def _port_from_jax_exporter(params, cfg=TINY_SIGLIP, **kw):
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    model = build_model(parse_model_cfg(cfg), attn_impl="fused", **kw)
    model.load_state_dict(flax_params_to_torch_state_dict(params), strict=True)
    return model


def test_model_loads_the_jax_export_and_matches_features_loss_and_gradients(tiny_dims):
    """The JAX exporter's open_clip layout (``visual.trunk.*``, ``text.*``,
    ``logit_scale``, ``logit_bias``) loads strictly and equals the port's
    own converter key for key; features, the scalars, the SigLIP loss and
    every gradient match the JAX model's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.contrastive import (
        siglip_loss as jax_siglip_loss,
    )
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

    jmodel, variables = _jax_siglip()
    params = variables["params"]
    exported = flax_params_to_torch_state_dict(params)
    ours = jax_params_to_state_dict(params)
    assert exported.keys() == ours.keys()
    assert all(torch.equal(torch.as_tensor(exported[k]).float(), ours[k]) for k in ours)
    model = _port_from_jax_exporter(params).train()
    x, ids = images(4, 32, seed=8), _ids(4, 16, seed=9)

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(ids))
        return jax_siglip_loss(out["image_features"], out["text_features"], out["logit_scale"],
                               out["logit_bias"]), out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "logit_scale", "logit_bias"):
        assert _rel(got[k].detach(), want[k]) <= 1e-5, k
    loss, _ = make_loss_fn(model, StepCfg(loss_type="siglip"))(
        {"images": torch.from_numpy(x), "texts": torch.from_numpy(ids).long()}, 0)
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want_grads = jax_params_to_state_dict(jax.device_get(want_grads))
    largest = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        err = float((p.grad - want_grads[name].reshape(p.shape)).abs().max())
        assert err <= 1e-5 * largest, (name, err, largest)


def test_checkpointed_step_makes_the_predicted_fused_calls(tiny_dims, monkeypatch):
    """Under ``--grad-checkpointing`` a SigLIP step's fused calls are the
    forward's 2L + 1 (vision blocks, the MAP head, text blocks), the
    recompute's 2L (the blocks only: the JAX tower remats its blocks, not
    its head, and the text transformer its blocks) and the backward's
    2L + 1: at ViT-B-16-SigLIP 25, 24 and 25. The loss equals the step
    without recompute."""
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

    _, variables = _jax_siglip()
    counts = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = attention.fused_attention, fused_mod.fused_attention_bwd

    def fwd(*a):
        counts["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        counts["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(attention, "fused_attention", fwd)
    monkeypatch.setattr(fused_mod, "fused_attention_bwd", bwd)
    batch = {"images": torch.from_numpy(images(4, 32, seed=10)),
             "texts": torch.from_numpy(_ids(4, 16, seed=11)).long()}
    losses = []
    for remat in (True, False):
        model = _port_from_jax_exporter(variables["params"], grad_checkpointing=remat).train()
        counts.update(fwd=0, bwd=0)
        loss, _ = make_loss_fn(model, StepCfg(loss_type="siglip"))(batch, 0)
        forward = counts["fwd"]
        loss.backward()
        losses.append(float(loss))
        layers = TINY_DIMS[1]
        assert forward == 2 * layers + 1
        assert counts["fwd"] - forward == (2 * layers if remat else 0)
        assert counts["bwd"] == 2 * layers + 1
    assert losses[0] == losses[1]


# ------------------------------------------------------------ the registry

@pytest.mark.parametrize("name", SIGLIP_NAMES)
def test_every_siglip_registry_name_builds_with_the_jax_dims(name):
    """On the meta device (no full-width weights on the CPU): the tower's
    dims are the JAX ``parse_siglip_timm_name``'s at the config's image
    size, the text tower the config's; the ``nllb`` names' HF text towers
    raise naming item 14."""
    from refining_clip_via_dinov2_representations_tpu.models import (
        get_model_config as jax_get_model_config,
    )
    from refining_clip_via_dinov2_representations_tpu.models.siglip import (
        parse_siglip_timm_name as jax_parse_name,
    )

    raw = get_model_config(name)
    assert raw == jax_get_model_config(name)
    cfg = parse_model_cfg(raw)
    if cfg.text_cfg.hf_model_name:
        with pytest.raises(NotImplementedError, match="item 14"), torch.device("meta"):
            CLIP(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg)
        return
    with torch.device("meta"):
        model = CLIP(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg,
                     init_logit_bias=cfg.init_logit_bias)
    dims = jax_parse_name(cfg.vision_cfg.timm_model_name)
    c = model.visual.cfg
    assert (c.width, c.layers, c.heads, c.mlp_dim, c.patch_size) == (
        dims["width"], dims["layers"], dims["heads"], dims["mlp_dim"], dims["patch_size"])
    assert c.image_size == raw["vision_cfg"]["image_size"]
    text = model.text
    t = raw["text_cfg"]
    assert (text.context_length, text.token_embedding.num_embeddings,
            text.token_embedding.embedding_dim, len(text.transformer.resblocks)) == (
        t["context_length"], t["vocab_size"], t["width"], t["layers"])
    assert text.causal is False and text.pool_type == "last"
    assert text.ln_final.eps == t["norm_kwargs"]["eps"]
    assert isinstance(text.text_projection,
                      type(None) if t.get("proj_type") == "none" else torch.nn.Linear)
    assert model.logit_bias is not None
    if name == "ViT-B-16-SigLIP":
        assert sum(p.numel() for p in model.parameters()) == 203_155_970


@pytest.mark.parametrize("timm_name", ["vit_base_patch16_siglip_gap_224",
                                       "vit_so400m_patch14_siglip_gap_384"])
def test_gap_trunks_raise_as_jax(timm_name):
    from refining_clip_via_dinov2_representations_tpu.models.siglip import (
        parse_siglip_timm_name as jax_parse_name,
    )

    with pytest.raises(NotImplementedError, match="_gap"):
        jax_parse_name(timm_name)
    with pytest.raises(NotImplementedError, match="item 2-3"):
        tsiglip.parse_siglip_timm_name(timm_name)
    assert tsiglip.parse_siglip_timm_name("eva_giant_patch14_224") is None


# -------------------------------------- checkpoints, serving, the CLI (Config 4)

def test_hub_checkpoint_by_tag_serves_through_create_engine(tiny_dims, tmp_path, monkeypatch,
                                                             offline):
    """Seeded weights in the hub cache of ``timm/ViT-B-16-SigLIP`` load by the
    ``webli`` tag exactly; ``create_engine`` serves them with the config's
    HF tokenizer from the same cache (``HF_HUB_CACHE``): unit-norm features
    equal to the model's own."""
    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer, pretrained,
    )

    register_model_config(MODEL, TINY_SIGLIP)
    monkeypatch.setitem(pretrained._PRETRAINED, MODEL,
                        {"webli": pretrained.get_pretrained_cfg("ViT-B-16-SigLIP", "webli")})
    src = build_model(parse_model_cfg(TINY_SIGLIP), seed=12)
    sd = src.state_dict()
    seed_hub_snapshot(str(tmp_path), state_dict=sd)
    model, _ = create_model(MODEL, pretrained="webli", cache_dir=str(tmp_path), device="cpu")
    assert model.state_dict().keys() == sd.keys()
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    engine, preprocess, tokenizer = create_engine(MODEL, pretrained="webli", device="cpu",
                                                  buckets=(1, 4), warm=False)
    assert type(tokenizer).__name__ == "HFTokenizer" and engine.context_length == 16
    ids = tokenizer(["a photo of a cat", "a dog on the beach"])
    assert ids.shape == (2, 16) and ids[0, 5:].tolist() == [1] * 11  # 5 pieces, </s>, pad
    x = images(2, 32, seed=13)
    feats_i, feats_t = engine.encode_image(x), engine.encode_text(ids)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x).to(torch.bfloat16).float(),
                            torch.from_numpy(ids).long())
    np.testing.assert_allclose(np.linalg.norm(feats_i, axis=-1), 1, atol=1e-5)
    assert _rel(feats_i, want["image_features"]) <= 1e-5
    assert _rel(feats_t, want["text_features"]) <= 1e-5
    assert get_tokenizer(MODEL, cache_dir=str(tmp_path))(["a cat"]).tolist() == \
        tokenizer(["a cat"]).tolist()


def _write_config4_shards(d: str, n_shards: int = 4, per_shard: int = 6) -> str:
    """Tar shards of JPEG + ``.txt`` samples, one ``.json``-captioned."""
    import io
    import tarfile

    from PIL import Image

    rng = np.random.default_rng(0)
    words = ["a photo of a cat", "the dog on a beach", "a red car", "an image of a boat"]
    os.makedirs(d, exist_ok=True)
    for s in range(n_shards):
        with tarfile.open(os.path.join(d, f"shards-{s:05d}.tar"), "w") as tf:
            for i in range(per_shard):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                    buf, format="JPEG")
                members = [("jpg", buf.getvalue())]
                caption = f"{words[(s + i) % 4]} number {s * per_shard + i}"
                members.append(("json", json.dumps({"caption": caption}).encode())
                               if (s, i) == (1, 2) else ("txt", caption.encode()))
                for ext, data in members:
                    info = tarfile.TarInfo(f"{s:02d}{i:04d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(d, "shards-{00000..00003}.tar")


def _losses(run_dir):
    with open(os.path.join(run_dir, "loss_steps.json")) as f:
        return [r["total_loss"] for r in json.load(f)]


BATCH = 8


def _config4_argv(tmp_path, flags=("--siglip",)):
    """Config 4's flags (``docs/REPRODUCE.md:54-67``) at fp32 on the tiny
    SigLIP: four seeded tar shards, three steps of 8, the tokenizer from the
    config's hub repo under ``--cache-dir``, the JAX-exported weights as
    ``--pretrained`` and a full-image crop (the train transform's draws
    differ between the two CLIs' processes)."""
    _, variables = jax_clip(TINY_SIGLIP, seed=5, jit=True)
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    weights = str(tmp_path / "weights.bin")
    torch.save(flax_params_to_torch_state_dict(variables["params"]), weights)
    seed_hub_snapshot(str(tmp_path / "hub"))
    feats = str(tmp_path / "feats.npy")
    np.save(feats, np.random.default_rng(1).normal(size=(24, 12)).astype(np.float32))
    return ["--model", MODEL, *[feats if f == "FEATS" else f for f in flags],
            "--precision", "fp32", "--dataset-type", "webdataset",
            "--train-data", _write_config4_shards(str(tmp_path / "shards")),
            "--loss-dist-impl", "bidir", "--grad-checkpointing", "--pretrained", weights,
            "--train-num-samples", str(3 * BATCH), "--epochs", "1", "--workers", "1",
            "--seed", "3", "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1",
            "--save-frequency", "0", "--cache-dir", str(tmp_path / "hub"),
            "--aug-cfg", "scale=(1.0,1.0)", "--logs", str(tmp_path)]


def test_config4_flags_train_and_resume_mid_epoch_in_the_port(tiny_dims, tmp_path, offline):
    """Config 4's flags through the port's ``train.main``: three steps of
    finite losses, the first equal to the SigLIP loss of the loader's first
    batch on the loaded weights; ``--stop-after-steps 1`` then ``--resume
    latest`` continues inside the epoch (the tar loader's
    ``skip_next_batches``) and gives the uninterrupted run's losses."""
    import math
    from types import SimpleNamespace

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.train.main import (
        build_transforms, main,
    )
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn
    from refining_clip_via_dinov2_representations_torch.train.webdataset import get_wds_dataset

    register_model_config(MODEL, TINY_SIGLIP)
    argv = _config4_argv(tmp_path) + ["--batch-size", str(BATCH), "--force-cpu"]
    main(argv + ["--name", "full"])
    full = _losses(tmp_path / "full")
    assert len(full) == 3 and all(math.isfinite(x) for x in full)
    args = parse_args(argv)
    model, pp_cfg = create_model(MODEL, args.pretrained, device="cpu")
    batch = next(iter(get_wds_dataset(args, build_transforms(args, pp_cfg)[0], True,
                                      get_tokenizer(MODEL, cache_dir=args.cache_dir)).dataloader))
    with torch.no_grad():
        first, _ = make_loss_fn(model, StepCfg(loss_type="siglip"))(
            {"images": torch.from_numpy(batch["images"]),
             "texts": torch.from_numpy(batch["texts"]).long()}, 0)
    assert float(first) == pytest.approx(full[0], rel=1e-6)
    main(argv + ["--name", "resumed", "--stop-after-steps", "1"])
    assert (tmp_path / "resumed" / "checkpoints" / "epoch_0_preempt.pt").exists()
    main(argv + ["--name", "resumed", "--resume", "latest"])
    assert _losses(tmp_path / "resumed") == pytest.approx(full, rel=1e-6)


@pytest.mark.parametrize("flags", [["--siglip"],
                                   ["--use_dino_general", "--dino_fts_path", "FEATS"]])
def test_config4_flags_match_the_jax_cli(tiny_dims, tmp_path, offline, flags):
    """Config 4's flags through both CLIs (``_config4_argv``): the port's
    per-step losses within 1e-5 of the JAX CLI's. With the DINO flags in
    place of ``--siglip``, both CLIs load the feature store and train on tar
    batches that carry no features (no index joins them to a sample), so
    both take the losses that need none: the same losses again."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.models import (
        register_model_config as jax_register,
    )
    from refining_clip_via_dinov2_representations_tpu.train.main import main as jax_main
    from refining_clip_via_dinov2_representations_torch.train.main import main

    jax_register(MODEL, TINY_SIGLIP)
    register_model_config(MODEL, TINY_SIGLIP)
    argv = _config4_argv(tmp_path, flags)
    main(argv + ["--name", "port", "--batch-size", str(BATCH), "--force-cpu"])
    # the JAX CLI's --batch-size is per device: its CPU devices share one host batch
    jax_main(argv + ["--name", "jax", "--batch-size", str(BATCH // jax.device_count())])
    got, want = _losses(tmp_path / "port"), _losses(tmp_path / "jax")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
