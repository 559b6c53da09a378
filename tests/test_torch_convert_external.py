"""The MobileCLIP weights in their other forms and placements against the JAX
package's on the CPU: the external layouts (``models/convert_external.py``,
``models/factory.py:load_checkpoint``), the deploy fold, int8 and the model axis,
at the tiny sizes of ``test_torch_fastvit.py`` (its numpy-drawn JAX
weights) and a tiny SigLIP (``_SIGLIP_FAMILY_DIMS["base"]`` patched in both
packages):

* Apple's MobileCLIP files, S (FastViT, the flat ``network.N`` list) and B
  (MCi), written from the port's state dict by the JAX-free
  ``scripts/mobileclip_apple_layout.py``: ``load_checkpoint`` gives the
  written tensors exactly (the bias-free projection read as a zero bias),
  and features at 1e-5 against the JAX model loaded from the same file by
  the JAX ``load_checkpoint``;
* a big_vision SigLIP ``.npz`` built as ``tests/test_convert_external.py``
  builds it: the port's load equals the JAX load's features at 1e-5 and its
  ``logit_scale``/``logit_bias``; without ``img/`` a strict load fails in
  both and a loose one takes the text tower;
* a BatchNorm tower's file without running statistics fails ``strict`` in
  both; Apple's text renames give the JAX renames' keys;
* ``create_model("MobileCLIP-S2"-style tiny, pretrained="datacompdr")``
  from a seeded hub cache loads the JAX exporter's file exactly, with the
  tag's preprocessing (mean 0, std 1, ``shortest``, ``bilinear``: the
  port's recorded departure from the JAX factory's);
* the deploy form: ``fuse_fastvit_state_dict`` gives the JAX
  ``fuse_fastvit_variables`` tower's features at 1e-5 (and the training
  form's at 2e-4, the JAX test's bound), with fewer tensors and no
  BatchNorm;
* int8 quantizes the JAX quantizer's leaves bit for bit (FastViT's RepCPE
  kernel per output channel; MCi's ``pos_embed``, the JAX
  ``positional_embedding``, skipped) and the int8 engine stores them;
* split over the model group of two gloo ranks, each tower's CLIP step
  (BatchNorm training) equals the one-process step: loss 1e-5 relative,
  every gradient at cosine >= 0.99999, the running statistics within 1e-6;
  only the text tower splits beside a FastViT tower, the MCi blocks split.
"""

import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models import convert_external as tce
from refining_clip_via_dinov2_representations_torch.models import fastvit as tfastvit
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.models.factory import load_checkpoint
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn
from scripts.mobileclip_apple_layout import to_apple_layout

from .test_torch_fastvit import (
    CFGS, FAMILIES, MCI, SIZE, TINY, TINY_NAME, _batch, _cosine, _jax, _patch_tables, _port,
    _stats, _torch,
)
from .torch_dist_utils import run_ranks
from .torch_port_utils import images, offline, one_thread, token_ids  # noqa: F401

CTX = 12
SIGLIP_DIMS = (32, 2, 4, 64)
SIGLIP_CFG = {"embed_dim": 32, "custom_text": True, "init_logit_bias": -10,
              "text_cfg": {"context_length": CTX, "vocab_size": 64, "width": 32, "heads": 4,
                           "layers": 2, "mlp_ratio": 2.0, "no_causal_mask": True,
                           "pool_type": "last", "proj_bias": True},
              "vision_cfg": {"image_size": 16, "timm_model_name": "vit_base_patch8_siglip_16",
                             "timm_model_pretrained": False, "timm_pool": "map",
                             "timm_proj": "none"}}
TAG_MODEL = "tiny-torch-mobileclip"


@pytest.fixture(autouse=True, scope="module")
def tiny_trunks():
    undo = _patch_tables()
    yield
    undo()


@pytest.fixture
def tiny_siglip(monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import siglip as tsiglip
    from refining_clip_via_dinov2_representations_tpu.models import siglip as jsiglip

    monkeypatch.setitem(jsiglip._SIGLIP_FAMILY_DIMS, "base", SIGLIP_DIMS)
    monkeypatch.setitem(tsiglip._SIGLIP_FAMILY_DIMS, "base", SIGLIP_DIMS)


def _jax_model(cfg):
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build, parse_model_cfg as jax_parse,
    )

    return jax_build(jax_parse(cfg), attn_impl="xla")


def _features(model, x, ids):
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), torch.from_numpy(ids).long())
    return {k: out[k].numpy() for k in ("image_features", "text_features")}


def _jax_features(jmodel, variables, x, ids):
    import jax

    out = jax.jit(jmodel.apply)(variables, x, ids)
    return {k: np.asarray(out[k]) for k in ("image_features", "text_features")}


@pytest.mark.parametrize("family", ["fastvit", "mci"])
def test_apple_layout_loads_as_the_jax_loader_loads_it(family, tmp_path):
    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        load_checkpoint as jax_load_checkpoint,
    )

    jmodel, variables = _jax(family)
    sd = jax_params_to_state_dict(variables)
    head = "visual.trunk.head.fc.bias" if family == "fastvit" else "visual.trunk.head.bias"
    sd[head] = torch.zeros_like(sd[head])  # Apple's projection has no bias
    apple = to_apple_layout(sd)
    marker = (tce.MOBILECLIP_S_KEY if family == "fastvit"  # the JAX loader's sniffs
              else "image_encoder.model.patch_emb.0.block.conv.weight")
    assert marker in apple and not any(k.startswith(("visual.", "text.")) for k in apple)
    if family == "fastvit":  # the flat list: 3 downsamplers, 1 position encoding, 4 stages
        assert {k.split(".")[3] for k in apple if ".network." in k} == set("01234567")
        assert "image_encoder.model.head.proj" in apple
    else:
        assert "image_encoder.model.classifier.proj" in apple
    path = str(tmp_path / "apple.pt")
    torch.save(apple, path)

    model = build_model(parse_model_cfg(CFGS[family]), init=False)
    missing, unexpected = load_checkpoint(model, path, strict=True)
    assert not missing and not unexpected
    own = model.state_dict()
    assert own.keys() == sd.keys()
    assert all(torch.equal(own[k], v.reshape(own[k].shape)) for k, v in sd.items())

    jvars, (jmissing, junexpected) = jax_load_checkpoint(jmodel, variables, path, strict=True)
    assert not jmissing and not junexpected
    x, ids = images(3, SIZE[family], seed=60), token_ids(3, CTX, seed=61)
    got, want = _features(model, x, ids), _jax_features(jmodel, jvars, x, ids)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_apple_text_renames_are_the_jax_renames():
    from refining_clip_via_dinov2_representations_tpu.models.convert_external import (
        convert_mobileclip_text_state_dict as jax_text,
    )

    sd = {  # tests/test_convert_external.py's sample
        "text_encoder.embedding_layer.weight": np.zeros((10, 4)),
        "text_encoder.positional_embedding.pos_embed.pos_embed": np.zeros((1, 8, 4)),
        "text_encoder.transformer.0.pre_norm_mha.0.weight": np.zeros(4),
        "text_encoder.transformer.0.pre_norm_mha.1.qkv_proj.weight": np.zeros((12, 4)),
        "text_encoder.transformer.0.pre_norm_mha.1.out_proj.bias": np.zeros(4),
        "text_encoder.transformer.0.pre_norm_ffn.1.weight": np.zeros((8, 4)),
        "text_encoder.transformer.0.pre_norm_ffn.4.bias": np.zeros(4),
        "text_encoder.final_layer_norm.weight": np.zeros(4),
        "text_encoder.projection_layer": np.zeros((4, 6)),
        "image_encoder.model.whatever": np.zeros(1),
    }
    want = jax_text(sd)
    got = tce.convert_mobileclip_text_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert got.keys() == want.keys()
    assert all(tuple(v.shape) == np.shape(want[k]) for k, v in got.items())
    assert got["text.positional_embedding"].shape == (8, 4)
    # the writer inverts them
    back = to_apple_layout(got)
    assert set(back) == {k for k in sd if k.startswith("text_encoder.")}


def _big_vision_npz(path, with_image=True):
    from .test_convert_external import _fake_big_vision_img, _fake_big_vision_npz

    w = _fake_big_vision_npz(d=32, heads=4, layers=2, vocab=64, ctx=CTX, out_dim=32)
    if with_image:
        _fake_big_vision_img(w, d=32, heads=4, layers=2, patch=8, img=16, mlp=64)
    else:
        w["params/t"] = np.asarray([2.0], np.float32)
    np.savez(path, **w)
    return str(path)


def test_big_vision_npz_loads_as_the_jax_loader_loads_it(tmp_path, tiny_siglip):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        load_checkpoint as jax_load_checkpoint,
    )

    path = _big_vision_npz(tmp_path / "siglip.npz")
    model = build_model(parse_model_cfg(SIGLIP_CFG), init=False)
    missing, unexpected = load_checkpoint(model, path, strict=True)
    assert not missing and not unexpected
    assert float(model.logit_scale.detach()) == 2.0 and float(model.logit_bias.detach()) == -10.0
    jmodel = _jax_model(SIGLIP_CFG)
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                              jnp.zeros((1, CTX), jnp.int32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(template))
    jvars, (jmissing, junexpected) = jax_load_checkpoint(jmodel, template, path, strict=True)
    assert not jmissing and not junexpected
    # every tensor is the JAX load's, through the port's own emitters
    want = jax_params_to_state_dict(jvars)
    own = model.state_dict()
    assert own.keys() == want.keys()
    assert all(torch.equal(own[k], v.reshape(own[k].shape)) for k, v in want.items())
    x = images(3, 16, seed=62)
    ids = np.random.default_rng(63).integers(1, 64, (3, CTX)).astype(np.int32)
    got, jwant = _features(model, x, ids), _jax_features(jmodel, jvars, x, ids)
    for k in got:
        np.testing.assert_allclose(got[k], jwant[k], atol=1e-5, rtol=0, err_msg=k)

    text_only = _big_vision_npz(tmp_path / "text.npz", with_image=False)
    with pytest.raises(ValueError):
        load_checkpoint(build_model(parse_model_cfg(SIGLIP_CFG), init=False), text_only)
    with pytest.raises(ValueError):
        jax_load_checkpoint(jmodel, template, text_only, strict=True)
    model = build_model(parse_model_cfg(SIGLIP_CFG))
    missing, unexpected = load_checkpoint(model, text_only, strict=False)
    assert not unexpected and missing and all(k.startswith("visual.") or k == "logit_bias"
                                              for k in missing)
    assert float(model.logit_scale.detach()) == 2.0


def test_a_batch_norm_tower_file_without_statistics_fails_strict(tmp_path):
    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        load_checkpoint as jax_load_checkpoint,
    )

    jmodel, variables = _jax("fastvit")
    sd = {k: v for k, v in jax_params_to_state_dict(variables).items() if ".running_" not in k}
    path = str(tmp_path / "no_stats.pt")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="running_"):
        load_checkpoint(build_model(parse_model_cfg(CFGS["fastvit"])), path, strict=True)
    with pytest.raises(ValueError, match="batch_stats"):
        jax_load_checkpoint(jmodel, variables, path, strict=True)
    missing, _ = load_checkpoint(build_model(parse_model_cfg(CFGS["fastvit"])), path,
                                 strict=False)
    assert missing and all(".running_" in k for k in missing)


def test_the_datacompdr_tag_loads_from_a_seeded_hub_cache(tmp_path, monkeypatch, offline):
    from refining_clip_via_dinov2_representations_torch.models import create_model, pretrained
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    _, variables = _jax("fastvit")
    cfg = pretrained.get_pretrained_cfg("MobileCLIP-S2", "datacompdr")
    assert cfg["hf_hub"] == "apple/MobileCLIP-S2-OpenCLIP/"
    register_model_config(TAG_MODEL, CFGS["fastvit"])
    monkeypatch.setitem(pretrained._PRETRAINED, TAG_MODEL, {"datacompdr": cfg})
    snap = tmp_path / "models--apple--MobileCLIP-S2-OpenCLIP" / "snapshots" / "seeded"
    os.makedirs(snap)
    (tmp_path / "models--apple--MobileCLIP-S2-OpenCLIP" / "refs").mkdir()
    (tmp_path / "models--apple--MobileCLIP-S2-OpenCLIP" / "refs" / "main").write_text("seeded")
    exported = {k: torch.as_tensor(np.asarray(v)) for k, v in flax_params_to_torch_state_dict(
        variables["params"], batch_stats=variables["batch_stats"]).items()}
    exported.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                     for k in list(exported) if k.endswith(".running_mean")})
    torch.save(exported, snap / "open_clip_pytorch_model.bin")
    model, pp = create_model(TAG_MODEL, pretrained="datacompdr", cache_dir=str(tmp_path),
                             device="cpu")
    want = jax_params_to_state_dict(variables)
    own = model.state_dict()
    assert own.keys() == want.keys()
    assert all(torch.equal(own[k], v.reshape(own[k].shape)) for k, v in want.items())
    assert (tuple(pp.mean), tuple(pp.std), pp.resize_mode, pp.interpolation) == (
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), "shortest", "bilinear")


def test_deploy_form_equals_the_jax_fused_tower():
    import jax

    from refining_clip_via_dinov2_representations_tpu.models import fastvit as jfastvit

    _, variables = _jax("fastvit")
    vis = {"params": variables["params"]["visual"],
           "batch_stats": variables["batch_stats"]["visual"]}
    x = images(3, 64, seed=40)
    jfused = jfastvit.fuse_fastvit_variables(vis)
    want = jax.jit(jfastvit.FastVitTower(cfg=jfastvit.FastVitCfg(**TINY), output_dim=24,
                                         inference_mode=True).apply)(jfused, x)
    model = _port("fastvit").eval()
    fused = tfastvit.fuse_fastvit(model)
    assert fused.visual.inference_mode and not model.visual.inference_mode
    keys = fused.visual.state_dict()
    assert not any("running_" in k for k in keys) and len(keys) < len(model.visual.state_dict())
    assert sum(v.numel() for v in keys.values()) < sum(
        p.numel() for p in model.visual.parameters())
    with torch.no_grad():
        got = fused.visual(torch.from_numpy(x))
        train_form = model.visual(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), train_form.numpy(), atol=2e-4, rtol=0)
    # the text tower and the scalars are the model's own
    assert torch.equal(fused.logit_scale, model.logit_scale)
    assert fused.text is not model.text and all(
        torch.equal(a, b) for a, b in zip(fused.text.parameters(), model.text.parameters()))
    # the state-dict function on the CLIP's keys, the rest passed through
    sd = tfastvit.fuse_fastvit_state_dict(model.state_dict())
    assert sd.keys() == fused.state_dict().keys()


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_quantizes_the_jax_leaves(family):
    import jax

    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, Int8Weight, dequantize, quantize_state_dict_int8,
    )
    from refining_clip_via_dinov2_representations_tpu.inference import quantize_variables_int8

    _, variables = _jax(family)
    # MCi's position table is [4, 32]; FastViT's RepCPE kernel [64, 1, 7, 7] (op by
    # op, as the JAX engine runs it, the quantizer compiles each shape: a larger
    # bound keeps FastViT's leaves few)
    min_size = 3000 if family == "fastvit" else 128
    jq = quantize_variables_int8({"params": variables["params"]}, min_size)["params"]
    stats = variables["batch_stats"]
    is_q = lambda x: isinstance(x, dict) and set(x) == {"_q", "_s"}  # noqa: E731
    # ``dequantize_variables``' product
    want = jax_params_to_state_dict(jax.tree.map(
        lambda x: np.asarray(x["_q"]).astype(np.float32) * np.asarray(x["_s"]) if is_q(x)
        else x, jq, is_leaf=is_q), stats)
    marks = jax.tree.map(lambda x: np.ones(x["_q"].shape, np.float32) if is_q(x)
                         else np.zeros(np.shape(x), np.float32), jq, is_leaf=is_q)
    jax_int8 = {k for k, v in jax_params_to_state_dict(marks, stats).items()
                if v.numel() and ".running_" not in k and bool((v == 1).all())}
    ours = quantize_state_dict_int8(jax_params_to_state_dict(variables), min_size)
    assert {k for k, v in ours.items() if isinstance(v, Int8Weight)} == jax_int8
    if family == "fastvit":  # a depthwise 7x7, per output channel (the RepCPE's)
        dw = "visual.trunk.stages.3.pos_emb.pos_enc.weight"
        assert dw in jax_int8 and ours[dw].scale.shape == (64, 1, 1, 1)
    else:  # the position table is the JAX leaf positional_embedding: skipped
        assert "visual.trunk.pos_embed" not in jax_int8
        assert ours["visual.trunk.pos_embed"].numel() >= min_size
    got = dequantize(ours)
    for k, v in got.items():
        if ".running_" not in k:
            assert torch.equal(v, want[k].reshape(v.shape)), k
    model = _port(family)
    ClipInferenceEngine(model, (SIZE[family],) * 2, CTX, buckets=(2,), quantize="int8",
                        quantize_min_size=min_size)
    stored = {n.replace("parametrizations.", "").replace(".original", ""): p
              for n, p in model.named_parameters()}
    assert {n for n, p in stored.items() if p.dtype == torch.int8} == jax_int8


def _split_worker(rank, world, sds, batches):
    """Each family's CLIP step whole and split over the model group of the
    ranks (BatchNorm training, as the step runs it): the losses, the lowest
    gradient cosine (split ones gathered), the split count."""
    import copy

    import torch

    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train.distributed import model_group

    undo = _patch_tables_port()
    create_mesh(model=world, device_type="cpu")
    mp = model_parallel(model_group())
    out = {}
    for family, sd in sds.items():
        whole = build_model(parse_model_cfg(CFGS[family]))
        whole.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        whole.train()
        batch = _torch(batches[family])

        def step(model):
            loss, _ = make_loss_fn(model, StepCfg(loss_type="clip"))(batch, 0)
            loss.backward()
            return float(loss), {n: p.grad for n, p in model.named_parameters()}

        split = copy.deepcopy(whole)
        loss_one, grads_one = step(whole)
        splits = shard_module(split, mp)
        loss_split, grads = step(split)
        grads = {n: gather_tensor(g, splits[n], mp) if n in splits else g
                 for n, g in grads.items()}
        cos = min((_cosine(g, grads_one[n]), n) for n, g in grads.items()
                  if not n.endswith("attn.in_proj_bias"))
        out[family] = {"loss": (loss_one, loss_split), "cos": cos, "splits": sorted(splits),
                       "stats": {k: float((v - _stats(whole)[k]).abs().max())
                                 for k, v in _stats(split).items()}}
    undo()
    return out


def _patch_tables_port():
    """The tiny trunks in the port's tables (a rank imports no JAX)."""
    saved = dict(tfastvit.FASTVIT_DIMS), dict(tfastvit.MCI_DIMS)
    tfastvit.FASTVIT_DIMS[TINY_NAME] = tfastvit.FastVitCfg(**TINY)
    tfastvit.MCI_DIMS["vit_base_mci_224"] = tfastvit.MciCfg(**MCI)

    def undo():
        for table, old in zip((tfastvit.FASTVIT_DIMS, tfastvit.MCI_DIMS), saved):
            table.clear()
            table.update(old)

    return undo


def test_two_gloo_ranks_split_step_equals_the_one_process_step():
    sds = {f: {k: v.numpy() for k, v in jax_params_to_state_dict(_jax(f)[1]).items()}
           for f in FAMILIES}
    batches = {f: _batch(f, seed=50) for f in FAMILIES}
    ranks = run_ranks(_split_worker, 2, sds, batches)
    for family in FAMILIES:
        for r in ranks:
            got = r[family]
            one, split = got["loss"]
            assert abs(split - one) <= 1e-5 * abs(one), (family, got["loss"])
            assert got["cos"][0] >= 0.99999, (family, got["cos"])
            assert all(e <= 1e-6 for e in got["stats"].values()), family
            if family == "fastvit":  # only the text tower splits
                assert got["splits"] and all(n.startswith("text.") for n in got["splits"])
            else:
                assert "visual.trunk.blocks.0.attn.qkv.weight" in got["splits"]
