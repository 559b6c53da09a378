"""The plain ViT's variants, CLIPA, timm's GAP ViT and the relative-position
ViT in the port, against the JAX package.

* ``get_2d_sincos_pos_embed`` equals the JAX function exactly (both fp32
  from float64), with and without the class token's zero row.
* Each variant of ``VisionTransformer`` (``tpu/models/transformer.py:
  240-400``) at a tiny size (16 px, patch 8, width 32, 2 blocks): the JAX
  tower with numpy-perturbed params, its leaves carried through
  ``models/convert.py`` and loaded with ``strict=True``, features (and
  tokens) at 1e-5 absolute in fp32; the fused path runs once a block.
* A tiny CLIPA CLIP (average pool, ``ln_post`` after it, no ``ln_pre``; the
  non-causal text tower at context 32 over a 32000 vocabulary, pooled at
  the last position whatever the padding) against the JAX CLIPA ``CLIP``.
* The relative-position tower against ``tpu/models/relpos_vit.py``: the
  index table equal, features at 1e-5, and no fused call (its bias is an
  external mask, as in JAX).
* The 8 names the registry adds, at full width on the ``meta`` device:
  every state-dict key and shape equal to what the weight bridge makes of
  the JAX model's abstract tree, and the parameter counts.
* The model axis: CLIPA's and the GAP tower's splits against the JAX
  ``_param_spec``; the relative-position tower split over two gloo ranks
  gives the whole tower's forward.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import relpos_vit as trelpos
from refining_clip_via_dinov2_representations_torch.models import transformer as ttrans
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.ops import fused_attention as fused_ops

from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip

OUT = 24


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the fused kernel's plain-version calls (the CPU's launches)."""
    calls = []
    plain = fused_ops.fused_attention_reference

    def counted(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return plain(q, *args, **kwargs)

    monkeypatch.setattr(fused_ops, "fused_attention_reference", counted)
    return calls


@pytest.mark.parametrize("cls_token", [True, False])
@pytest.mark.parametrize("dim,grid", [(32, 2), (64, 7), (768, 14), (1024, 16)])
def test_sincos_pos_embed_equals_jax(dim, grid, cls_token):
    from refining_clip_via_dinov2_representations_tpu.models.transformer import (
        get_2d_sincos_pos_embed as jax_sincos,
    )
    from refining_clip_via_dinov2_representations_tpu.utils import get_2d_sincos_pos_embed

    got = ttrans.get_2d_sincos_pos_embed(dim, grid, cls_token=cls_token)
    want = jax_sincos(dim, grid, cls_token=cls_token)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want) and np.array_equal(got, get_2d_sincos_pos_embed(
        dim, grid, cls_token=cls_token))


VARIANTS = {
    "sincos": dict(pos_embed_type="sin_cos_2d"),
    "sincos_gap": dict(pos_embed_type="sin_cos_2d", class_token=False, pool_type="avg"),
    "avg": dict(pool_type="avg"),
    "clipa": dict(pool_type="avg", final_ln_after_pool=True, no_ln_pre=True),
    "tok_ln_after_pool": dict(final_ln_after_pool=True),
    "gap": dict(class_token=False, pool_type="avg", qkv_bias=False, ls_init_value=1e-6,
                no_ln_pre=True, patch_embed_bias=True, norm_eps=1e-6),
    "tanh_eps": dict(act="tanh", norm_eps=1e-6),
    "none_pool": dict(pool_type="none"),
}


def _perturbed(tree, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, 0.05, np.shape(x)).astype(
        np.float32), jax.device_get(tree))


def _text_tree():
    """A tiny CLIP's text tower and scale, to carry a lone vision tree
    through the weight bridge."""
    _, variables = jax_clip(TINY_CFG, attn_impl="xla")
    return variables["params"]


def _port_visual(module, visual_tree):
    params = dict(_text_tree())
    params["visual"] = visual_tree
    sd = {k[len("visual."):]: v for k, v in jax_params_to_state_dict(params).items()
          if k.startswith("visual.")}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("output_tokens", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_vision_variant_matches_jax(name, output_tokens, fused_calls):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.siglip import gelu_tanh
    from refining_clip_via_dinov2_representations_tpu.models.layers import get_act_fn
    from refining_clip_via_dinov2_representations_tpu.models.transformer import (
        VisionTransformer as JaxViT,
    )

    kw = dict(VARIANTS[name])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("act", None) == "tanh":
        jkw["act"], tkw["act"] = get_act_fn("gelu_tanh"), gelu_tanh
    base = dict(image_size=(16, 16), patch_size=(8, 8), width=32, layers=2, heads=4,
                output_dim=OUT, output_tokens=output_tokens)
    jtower = JaxViT(**base, **jkw, attn_impl="fused")
    x = images(3, 16, seed=31)
    params = _perturbed(jtower.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"],
                        32)
    want = jtower.apply({"params": params}, jnp.asarray(x))
    port = _port_visual(ttrans.VisionTransformer(**base, **tkw, attn_impl="fused"), params)
    if "class_token" in kw:
        assert port.class_embedding is None and "class_embedding" not in params
    if kw.get("pos_embed_type") == "sin_cos_2d":
        assert "positional_embedding" not in dict(port.named_parameters())
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got if output_tokens else [got], want if output_tokens else [want]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert len(fused_calls) == 2  # every block through the kernel's path


CLIPA_TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 32, "layers": 2, "head_width": 16,
                   "no_ln_pre": True, "pool_type": "avg", "final_ln_after_pool": True},
    "text_cfg": {"context_length": 32, "vocab_size": 32000, "width": 32, "heads": 4,
                 "layers": 2, "no_causal_mask": True, "pool_type": "last",
                 "hf_tokenizer_name": "bert-base-uncased",
                 "tokenizer_kwargs": {"strip_sep_token": True}},
}


def clipa_token_ids(n: int, seed: int = 33) -> np.ndarray:
    """Rows framed as CLIPA's tokenizer frames them: [CLS] (101), word ids,
    the stripped [SEP] and zero padding."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 32), np.int32)
    for i in range(n):
        length = int(rng.integers(1, 30))
        out[i, 0] = 101
        out[i, 1:1 + length] = rng.integers(104, 32000, length)
    out[-1, 1:] = rng.integers(104, 32000, 31)  # one row fills the context
    return out


def test_clipa_matches_the_jax_clipa_clip(fused_calls):
    import jax.numpy as jnp

    jmodel, variables = jax_clip(CLIPA_TINY, attn_impl="fused", seed=6)
    model = port_clip(CLIPA_TINY, variables["params"], attn_impl="fused")
    assert not model.causal and model.pool_type == "last" and model.visual.ln_pre is None
    x, ids = images(3, 16, seed=34), clipa_token_ids(3)
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert [s[2] for s in fused_calls] == [5, 5, 32, 32]  # non-causal text on the kernel too
    # the last position, padding or not: the text pool is x[:, -1]
    from refining_clip_via_dinov2_representations_torch.models.transformer import (
        text_global_pool,
    )

    h = torch.randn(2, 32, 8)
    assert torch.equal(text_global_pool(h, torch.from_numpy(ids[:2]).long(), "last"), h[:, -1])


def test_relpos_tower_matches_jax_and_takes_plain_attention(fused_calls):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.relpos_vit import (
        RelPosVisionTower as JaxRelPos, build_relpos_index as jax_index,
    )

    for grid in ((2, 2), (3, 5), (14, 14)):
        for prefix in (0, 1):
            assert np.array_equal(trelpos.build_relpos_index(grid, prefix),
                                  jax_index(grid, prefix))
    base = dict(width=32, layers=2, heads=4, patch_size=8, image_size=32, output_dim=OUT)
    jtower = JaxRelPos(**base, attn_impl="fused")
    x = images(2, 32, seed=35)
    params = _perturbed(jtower.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"],
                        36)
    want = jtower.apply({"params": params}, jnp.asarray(x))
    port = _port_visual(trelpos.RelPosVisionTower(**base, attn_impl="fused"), params)
    assert tuple(port.transformer.resblocks[0].relative_position_bias_table.shape) == (
        7 * 7 + 3, 4)
    assert port.transformer.resblocks[0].attn.in_proj_bias is None
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert fused_calls == []  # the bias is an external mask: the plain path, as in JAX
    # the bias tables take their gradients through the plain path
    port.train()
    port(torch.from_numpy(x)).square().sum().backward()
    assert all(float(b.relative_position_bias_table.grad.abs().max()) > 0
               for b in port.transformer.resblocks)


NEW_NAMES = ["ViT-H-14-CLIPA", "ViT-H-14-CLIPA-336", "ViT-L-14-CLIPA", "ViT-L-14-CLIPA-336",
             "ViT-bigG-14-CLIPA", "ViT-bigG-14-CLIPA-336", "vit_medium_patch16_gap_256",
             "vit_relpos_medium_patch16_cls_224"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_added_names_build_at_full_width_as_the_jax_tree(name, monkeypatch):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, convert, get_model_config, list_models, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.models._registry_data import (
        MODEL_CONFIGS as JAX_CONFIGS,
    )

    assert name in list_models() and get_model_config(name) == JAX_CONFIGS[name]
    cfg = jax_parse(JAX_CONFIGS[name])
    size = cfg.vision_cfg.image_size
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))["params"]
    # zero-stride leaves through the bridge, each tensor a meta tensor of its shape
    leaves = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(convert, "_t", lambda x, transpose=False: torch.empty(
        np.shape(x)[::-1] if transpose and np.ndim(x) == 2 else np.shape(x), device="meta"))
    want = {k: tuple(v.shape) for k, v in convert.jax_params_to_state_dict(leaves).items()}
    with torch.device("meta"):
        model = build_model(parse_model_cfg(get_model_config(name)))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n


def test_clipa_and_gap_splits_agree_with_jax_param_spec():
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.transformer import (
        VisionTransformer as JaxViT,
    )

    from .test_torch_tp_spec import _check, _markers

    _, variables = jax_clip(CLIPA_TINY, attn_impl="xla")
    split = _check(jax_params_to_state_dict(_markers(variables["params"])))
    assert {"token_embedding.weight", "visual.transformer.resblocks.1.attn.in_proj_weight",
            "transformer.resblocks.0.mlp.c_fc.weight"} <= split
    gap = JaxViT(image_size=(16, 16), patch_size=(8, 8), width=32, layers=2, heads=4,
                 output_dim=OUT, **{k: v for k, v in VARIANTS["gap"].items()})
    params = dict(_text_tree())
    params["visual"] = gap.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    sd = jax_params_to_state_dict(_markers(params))
    split = _check(sd)
    assert "visual.transformer.resblocks.0.attn.in_proj_bias" not in sd
    assert {"visual.transformer.resblocks.0.attn.in_proj_weight",
            "visual.transformer.resblocks.0.attn.out_proj.weight"} <= split
    assert not {"visual.conv1.bias", "visual.transformer.resblocks.0.ls_1.gamma",
                "visual.positional_embedding"} & split


def test_relpos_tower_refuses_a_model_axis():
    """No longer refused: two gloo ranks split the tower (its attention by
    heads, its MLP by columns, each bias table whole and sliced to the
    rank's heads) and give the whole tower's forward; one process keeps it
    whole."""
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import shard_module

    from .test_torch_tp_towers import split_forward

    tower = trelpos.RelPosVisionTower(width=32, layers=1, heads=4, patch_size=8, image_size=16,
                                      output_dim=OUT)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():  # no uninitialised (possibly NaN) values in the comparison
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    before = {k: v.clone() for k, v in tower.state_dict().items()}
    assert shard_module(tower, None) == {}  # one process: whole, as before
    assert all(torch.equal(v, tower.state_dict()[k]) for k, v in before.items())
    n_split, err = split_forward(("relpos",))["relpos"]
    # each of 2 blocks: in_proj_weight, out_proj.weight, c_fc.weight and
    # .bias, c_proj.weight (no QKV bias); the tables stay whole
    assert n_split == 10 and err <= 1e-6, (n_split, err)
