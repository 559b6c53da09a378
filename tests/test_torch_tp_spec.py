"""The port's tensor-parallel split rules and the EVA01 tower, no processes.

* The split of every parameter (``parallel/tensor.py:param_split``) against
  the JAX ``parallel/mesh.py:_param_spec`` on the corresponding flax path,
  for a tiny CLIP, a tiny EVA01 CLIP, a tiny SigLIP (its timm trunk and MAP
  head), a tiny CoCa (its attentional pooler whole, as the JAX rule keeps
  it), the DINO head (``mlp``) and tiny DINOv2 (plain and SwiGLU). Each flax leaf is replaced by a marker that
  counts along the axis its spec splits (zeros where it is replicated) and
  carried through the port's converters, transposes included: a tensor the
  port splits on dim ``d`` must vary along ``d`` alone, a tensor the port
  keeps whole must be a replicated JAX leaf. 1-D biases of column-parallel
  layers are the one difference, by design: the JAX rule keeps every 1-D
  leaf whole, the port splits them with their weight's rows.
* The tiny EVA01 CLIP against the JAX ``VisionTransformer(no_ln_pre,
  proj_bias, patch_embed_bias, norm_eps=1e-6)`` it dispatches to, through
  the weight bridge (features at 1e-5 absolute, fp32 on the CPU); the timm
  layout round trip, and the JAX exporter's CustomTextCLIP state dict
  loading into the port with ``strict=True``.
* ``EVA01-g-14`` and ``EVA01-g-14-plus`` at their full widths, built on the
  ``meta`` device (no 4 GB allocation): parameter counts and shapes.
"""

import numpy as np
import pytest

from .torch_port_utils import TINY_CFG, images, jax_clip, jax_dinov2, token_ids

TINY_EVA = "eva_tiny_patch8_16"
EVA_CFG = {"custom_text": True, "embed_dim": 32,
           "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                        "layers": 1},
           "vision_cfg": {"image_size": 16, "timm_model_name": TINY_EVA,
                          "timm_model_pretrained": False, "timm_pool": "token",
                          "timm_proj": None}}


@pytest.fixture
def tiny_eva(monkeypatch):
    """A tiny EVA01 trunk name in both packages' ``EVA01_DIMS``."""
    from refining_clip_via_dinov2_representations_torch.models import eva
    from refining_clip_via_dinov2_representations_tpu.models import eva as jax_eva

    dims = (32, 1, 4, 2.0, 8)  # width, layers, heads, mlp_ratio, patch
    monkeypatch.setitem(eva.EVA01_DIMS, TINY_EVA, dims)
    monkeypatch.setitem(jax_eva.EVA01_DIMS, TINY_EVA, dims)
    return EVA_CFG


def _markers(params, head=False):
    """Each leaf -> an array of its shape counting (from 1) along the axis
    ``_param_spec`` splits, zeros where it is replicated."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import MODEL_AXIS, _param_spec

    def mark(path, x):
        keys = tuple(p.key if hasattr(p, "key") else str(p) for p in path)
        spec = _param_spec(("dino_head",) + keys if head else keys, np.asarray(x))
        out = np.zeros(np.shape(x), np.float32)
        for axis, name in enumerate(tuple(spec)):
            if name == MODEL_AXIS:
                shape = [1] * out.ndim
                shape[axis] = out.shape[axis]
                out = out + np.arange(1, out.shape[axis] + 1, dtype=np.float32).reshape(shape)
        return out

    return jax.tree_util.tree_map_with_path(mark, params)


def _varying(t) -> set:
    """The dims along which tensor ``t`` is not constant."""
    t = t.numpy()
    return {d for d in range(t.ndim) if t.shape[d] > 1 and
            not np.all(np.take(t, [0], axis=d) == t)}


def _check(markers_sd, head=False):
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import param_split

    for name, t in markers_sd.items():
        split = param_split(name, head)
        if split is None or t.ndim >= 2:
            want = set() if split is None else {split.dim}
            assert _varying(t) == want, (name, split, _varying(t))
        else:  # a column-parallel bias: its weight is split on its rows
            weight = name.replace("in_proj_bias", "in_proj_weight").replace(".bias", ".weight")
            weight = "weight" if name == "bias" else weight
            assert split.dim == 0 and _varying(markers_sd[weight]) == {0}, name
    return {n for n in markers_sd if param_split(n, head) is not None}


def test_clip_splits_agree_with_jax_param_spec():
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )

    _, variables = jax_clip(TINY_CFG, attn_impl="xla")
    split = _check(jax_params_to_state_dict(_markers(variables["params"])))
    assert "token_embedding.weight" in split and "visual.transformer.resblocks.1.attn." \
        "in_proj_weight" in split and "transformer.resblocks.0.mlp.c_proj.weight" in split


def test_eva01_splits_agree_with_jax_param_spec(tiny_eva):
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )

    _, variables = jax_clip(tiny_eva, attn_impl="xla")
    sd = jax_params_to_state_dict(_markers(variables["params"]))
    assert {"visual.proj.weight", "visual.proj.bias", "visual.conv1.bias"} <= set(sd)
    split = _check(sd)
    assert "visual.proj.weight" not in split and "visual.transformer.resblocks.0.mlp.c_fc." \
        "bias" in split


def test_dino_head_splits_agree_with_jax_param_spec():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_head_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.losses.dino import DinoProjectionHead

    params = DinoProjectionHead(dino_dim=24, projection_type="mlp", use_layernorm=True).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32)))["params"]
    split = _check(jax_head_params_to_state_dict(_markers(params, head=True)), head=True)
    assert split == {"fc1.weight", "fc1.bias", "fc2.weight"}


@pytest.mark.parametrize("swiglu", [False, True], ids=["mlp", "swiglu"])
def test_dinov2_splits_agree_with_jax_param_spec(swiglu):
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_dinov2_params_to_state_dict,
    )

    _, variables = jax_dinov2(use_swiglu=swiglu)
    split = _check(jax_dinov2_params_to_state_dict(_markers(variables["params"])))
    pre = "encoder.layer.0."
    want = {pre + "attention.attention.query.weight", pre + "attention.output.dense.weight",
            pre + ("mlp.weights_in.weight" if swiglu else "mlp.fc1.weight")}
    assert want <= split


def test_siglip_splits_agree_with_jax_param_spec(monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import siglip as tsiglip
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.models import siglip as jsiglip

    from .test_torch_siglip import TINY_DIMS, TINY_SIGLIP

    monkeypatch.setitem(jsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    monkeypatch.setitem(tsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    _, variables = jax_clip(TINY_SIGLIP, attn_impl="xla", jit=True)
    split = _check(jax_params_to_state_dict(_markers(variables["params"])))
    trunk = "visual.trunk."
    want = {trunk + "blocks.1.attn.qkv.weight", trunk + "blocks.1.attn.qkv.bias",
            trunk + "blocks.0.attn.proj.weight", trunk + "blocks.0.mlp.fc1.weight",
            trunk + "blocks.0.mlp.fc2.weight", trunk + "attn_pool.q.weight",
            trunk + "attn_pool.kv.weight", trunk + "attn_pool.proj.weight",
            trunk + "attn_pool.mlp.fc1.weight", trunk + "attn_pool.mlp.fc2.weight",
            "text.token_embedding.weight", "text.transformer.resblocks.0.attn.in_proj_weight"}
    assert want <= split
    assert not {trunk + "patch_embed.proj.weight", trunk + "pos_embed", trunk + "attn_pool.latent",
                "text.text_projection.weight"} & split


def test_coca_splits_agree_with_jax_param_spec():
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )

    from .torch_coca_utils import jax_coca

    _, variables = jax_coca()
    sd = jax_params_to_state_dict(_markers(variables["params"]))
    split = _check(sd)
    pooler = {k for k in sd if k.startswith("visual.attn_pool.")}
    assert "visual.attn_pool.attn.in_proj_weight" in pooler and not pooler & split
    dec = "text_decoder."
    assert {dec + "resblocks.0.attn.in_proj_weight", dec + "cross_attn.1.attn.in_proj_weight",
            dec + "cross_attn.1.attn.out_proj.weight", dec + "resblocks.1.mlp.c_fc.weight",
            "visual.transformer.resblocks.0.attn.in_proj_weight",
            "text.token_embedding.weight"} <= split
    assert dec + "text_projection" not in split


def test_packed_splits_take_each_ranks_heads_of_every_pack():
    import torch

    from refining_clip_via_dinov2_representations_torch.parallel.tensor import Split, split_tensor

    whole = torch.arange(12).reshape(12, 1)  # q rows 0-3, k 4-7, v 8-11; 2 ranks
    parts = [split_tensor(whole, Split(0, 3), 2, r).flatten().tolist() for r in range(2)]
    assert parts == [[0, 1, 4, 5, 8, 9], [2, 3, 6, 7, 10, 11]]


def test_shard_module_raises_with_the_numbers_where_heads_do_not_split():
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        ModelParallel, shard_module,
    )

    model = build_model(parse_model_cfg(TINY_CFG))  # 2 vision heads, 4 text heads
    with pytest.raises(ValueError, match="2 heads do not split over a model axis of 4"):
        shard_module(model, ModelParallel(None, 0, 4))


def test_tiny_eva01_matches_the_jax_tower_through_the_weight_bridge(tiny_eva):
    import jax.numpy as jnp
    import torch

    from refining_clip_via_dinov2_representations_torch.models import build_model, \
        parse_model_cfg
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_torch.models.factory import load_weights
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    jmodel, variables = jax_clip(tiny_eva, attn_impl="xla")
    assert "ln_pre" not in variables["params"]["visual"]
    port = build_model(parse_model_cfg(tiny_eva), attn_impl="xla")
    assert port.custom_text and port.visual.ln_pre is None
    assert port.visual.transformer.resblocks[0].ln_1.eps == 1e-6
    port.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    x, ids = images(3, 16, seed=4), token_ids(3, 12, seed=5)
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(ids))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)

    # the JAX exporter's CustomTextCLIP layout (timm trunk, text.*) loads strictly
    exported = {k: torch.from_numpy(np.asarray(v)) for k, v in
                flax_params_to_torch_state_dict(variables["params"]).items()}
    assert any(k.startswith("visual.trunk.blocks.0.attn.qkv") for k in exported)
    other = build_model(parse_model_cfg(tiny_eva), attn_impl="xla", seed=9)
    assert load_weights(other, exported, strict=True) == ([], [])
    for k, v in port.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_eva01_timm_layout_round_trips_with_the_zero_key_bias(tiny_eva):
    import torch

    from refining_clip_via_dinov2_representations_torch.models import build_model, \
        parse_model_cfg
    from refining_clip_via_dinov2_representations_torch.models.eva import (
        convert_eva_clip_state_dict, convert_timm_eva_state_dict, eva_clip_state_dict,
    )

    sd = build_model(parse_model_cfg(tiny_eva), seed=3).state_dict()
    timm = eva_clip_state_dict(sd)
    assert timm["visual.trunk.pos_embed"].shape == (1, 5, 32) and "text.token_embedding.weight" \
        in timm
    back = convert_eva_clip_state_dict(timm)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    # timm's own parameters: separate q/v biases and a zero key-bias buffer
    pre = "visual.trunk.blocks.0.attn."
    qkv = timm.pop(pre + "qkv.bias")
    q, _, v = qkv.chunk(3)
    timm.update({pre + "q_bias": q, pre + "k_bias": torch.full_like(q, 7.0), pre + "v_bias": v})
    fused = convert_timm_eva_state_dict(timm)["visual.transformer.resblocks.0.attn.in_proj_bias"]
    assert torch.equal(fused, torch.cat([q, torch.zeros_like(q), v]))


@pytest.mark.parametrize("name", ["EVA01-g-14", "EVA01-g-14-plus"])
def test_eva01_builds_at_full_width_on_the_meta_device(name):
    import jax
    import jax.numpy as jnp
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        get_model_config, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.models.clip import CLIP
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build, get_model_config as jax_cfg, parse_model_cfg as jax_parse,
    )

    # the JAX tower's parameter count, from shapes alone
    abstract = jax.eval_shape(jax_build(jax_parse(jax_cfg(name))).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32))
    params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abstract["params"]))
    cfg = parse_model_cfg(get_model_config(name))
    with torch.device("meta"):
        model = CLIP(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg)
    sd = model.state_dict()
    blk = "visual.transformer.resblocks.39."
    assert sd[blk + "attn.in_proj_weight"].shape == (3 * 1408, 1408)
    assert sd[blk + "mlp.c_fc.weight"].shape == (6144, 1408)
    assert sd["visual.proj.weight"].shape == (1024, 1408) and "visual.ln_pre.weight" not in sd
    assert sd["visual.conv1.bias"].shape == (1408,)
    assert sum(p.numel() for p in model.parameters()) == params
