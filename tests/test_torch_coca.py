"""The port's CoCa against the JAX package's, on the CPU, at the tiny CoCa
of ``tests/test_coca.py`` (``tests/torch_coca_utils.py``).

* Towers and decoder: image latent and tokens, text latent and tokens,
  teacher-forced logits and labels, within 1e-5 of the largest |value|;
  a decoder self- and cross-attention block with JAX at
  ``attn_impl="fused"`` (the Pallas kernel interpreted, the cross-attention
  at Lq != Lk) against the port's fused route.
* Weights: the JAX exporter's open_clip layout loads strictly; a pooler
  whose context is wider than its queries takes torch's separate q/k/v
  names and matches the JAX pooler.
* Generation, token for token against JAX's re-decode route (which
  ``tests/test_coca.py`` holds equal to its cached route): greedy at
  repetition penalty 1.0 and 1.5, the three beam-search parameter sets of
  ``tests/test_coca.py``, prompt continuation; the port's cached route
  against its own re-decode; the seq_len and beam errors; the warpers on
  the same logits; sampling reproducible under one generator seed, every
  drawn token inside the warped set.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models.coca import (
    generate,
    generate_beam,
    top_k_filter,
    top_p_filter,
)

from .torch_coca_utils import EOT, IDS, SOT, TINY_COCA, coca_images, coca_texts, jax_coca, port_coca

BEAM_CASES = [  # tests/test_coca.py:182-188
    dict(num_beams=4, num_beam_groups=2, seq_len=10, min_seq_len=2, repetition_penalty=1.0),
    dict(num_beams=6, num_beam_groups=3, seq_len=9, min_seq_len=3, repetition_penalty=1.0),
    dict(num_beams=4, num_beam_groups=1, seq_len=10, min_seq_len=2, repetition_penalty=1.3),
]


@pytest.fixture(scope="module")
def pair():
    jmodel, variables = jax_coca()
    return jmodel, variables, port_coca(variables["params"])


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _jax_outputs(jmodel, variables, imgs, texts):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(v, i, t):
        out = jmodel.apply(v, i, t)
        img = jmodel.apply(v, i, method=lambda m, x: m._encode_image(x))
        txt = jmodel.apply(v, t, method=lambda m, x: m._encode_text(x))
        return out, img, txt

    return jax.device_get(run(variables, jnp.asarray(imgs), jnp.asarray(texts)))


def _port_outputs(model, imgs, texts):
    with torch.no_grad():
        x, t = torch.from_numpy(imgs), torch.from_numpy(texts).long()
        return model(x, t), model._encode_image(x), model._encode_text(t)


def _check_towers(jax_out, port_out):
    (jo, jimg, jtxt), (po, pimg, ptxt) = jax_out, port_out
    for k in ("image_features", "text_features", "logits"):
        assert _rel(po[k], jo[k]) <= 1e-5, k
    np.testing.assert_array_equal(po["labels"].numpy(), jo["labels"])
    for name, j, p in (("image", jimg, pimg), ("text", jtxt, ptxt)):
        assert p[1].shape == j[1].shape, name
        assert _rel(p[0], j[0]) <= 1e-5 and _rel(p[1], j[1]) <= 1e-5, name
    assert float(po["logit_scale"]) == pytest.approx(float(jo["logit_scale"]), rel=1e-6)


def test_towers_and_decoder_match_jax(pair):
    jmodel, variables, model = pair
    imgs, texts = coca_images(3), coca_texts(3)
    jax_out = _jax_outputs(jmodel, variables, imgs, texts)
    port_out = _port_outputs(model, imgs, texts)
    _check_towers(jax_out, port_out)
    # image tokens: pooler rows 1-7 of 8 queries; text tokens: 12 (the CLS row dropped)
    assert tuple(port_out[1][1].shape) == (3, 7, 32)
    assert tuple(port_out[2][1].shape) == (3, 12, 32)
    assert tuple(port_out[0]["logits"].shape) == (3, 11, 64)


def test_fused_decoder_blocks_match_the_interpreted_pallas_kernel(pair, monkeypatch):
    """The decoder's first causal self-attention block (11 tokens) and first
    cross-attention block (11 queries over the 7 image tokens: Lq != Lk) at
    ``attn_impl="fused"``: JAX runs the Pallas kernel interpreted off the
    TPU; the port's fused route on CPU tensors runs the kernels' plain
    versions through the same autograd Function. Both take the same image
    and token embeddings."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.transformer import (
        ResidualAttentionBlock as JaxBlock,
    )

    from refining_clip_via_dinov2_representations_torch.ops import attention

    _, variables, plain = pair
    model = port_coca(variables["params"], attn_impl="fused")
    imgs, texts = coca_images(2, seed=3), coca_texts(2, seed=4)
    shapes, kernel_call = [], attention.fused_attention

    def contiguous_only(q, k, v, scale, causal):  # as the CUDA wrappers require
        assert all(t.is_contiguous() for t in (q, k, v))
        shapes.append((tuple(q.shape), tuple(k.shape), causal))
        return kernel_call(q, k, v, scale, causal)

    monkeypatch.setattr(attention, "fused_attention", contiguous_only)
    with torch.no_grad():
        _, image_embs = plain._encode_image(torch.from_numpy(imgs))
        x = plain._encode_text(torch.from_numpy(texts).long())[1][:, :-1]
        self_out = model.text_decoder.resblocks[0](x, causal=True)
        cross_out = model.text_decoder.cross_attn[0](self_out, kv=image_embs)
    dec = variables["params"]["text_decoder"]

    @jax.jit
    def run(x, kv):
        y = JaxBlock(n_head=4, attn_impl="fused").apply({"params": dec["resblocks_0"]}, x,
                                                       None, None, True)
        z = JaxBlock(n_head=4, attn_impl="fused", is_cross_attention=True).apply(
            {"params": dec["cross_attn_0"]}, y, kv)
        return y, z

    want_self, want_cross = run(jnp.asarray(x.numpy()), jnp.asarray(image_embs.numpy()))
    assert tuple(image_embs.shape) == (2, 7, 32) and tuple(x.shape) == (2, 11, 32)
    assert _rel(self_out, want_self) <= 1e-5 and _rel(cross_out, want_cross) <= 1e-5
    assert shapes == [((2, 4, 11, 8), (2, 4, 11, 8), True), ((2, 4, 11, 8), (2, 4, 7, 8), False)]


def test_jax_exporter_output_loads_strictly(pair):
    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )

    _, variables, model = pair
    exported = flax_params_to_torch_state_dict(variables["params"], shared_text_namespace=False)
    fresh = port_coca(variables["params"])
    fresh.load_state_dict(exported, strict=True)
    ours = jax_params_to_state_dict(variables["params"])
    assert exported.keys() == ours.keys() == model.state_dict().keys()
    for k, v in ours.items():
        torch.testing.assert_close(torch.as_tensor(np.asarray(exported[k])).float(), v,
                                   atol=0, rtol=0)
    assert "text_decoder.cross_attn.1.ln_1_kv.weight" in ours
    assert "visual.attn_pool.attn.in_proj_weight" in ours  # a context as wide as the queries


def test_pooler_with_a_wider_context_takes_separate_projections():
    """coca_ViT-L-14's pooler: 768-wide queries over the 1024-wide trunk, so
    torch's MultiheadAttention keeps q_proj_weight, k_proj_weight and
    v_proj_weight; here 32 over 48, against the JAX pooler."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.models.convert import _emit_pooler
    from refining_clip_via_dinov2_representations_torch.models.layers import AttentionalPooler
    from refining_clip_via_dinov2_representations_tpu.models.layers import (
        AttentionalPooler as JaxPooler,
    )

    x = np.random.default_rng(7).normal(size=(3, 9, 48)).astype(np.float32)
    jpool = JaxPooler(d_model=32, n_head=4, n_queries=5)
    shapes = jax.eval_shape(jpool.init, jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), shapes)
    want = np.asarray(jax.jit(jpool.apply)({"params": params}, jnp.asarray(x)))
    sd = {}
    _emit_pooler(sd, params, "p")
    pooler = AttentionalPooler(32, 48, n_head=4, n_queries=5)
    pooler.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    assert {"attn.q_proj_weight", "attn.k_proj_weight", "attn.v_proj_weight"} <= set(
        pooler.state_dict()) and "attn.in_proj_weight" not in pooler.state_dict()
    assert tuple(pooler.attn.k_proj_weight.shape) == (32, 48)
    with torch.no_grad():
        got = pooler(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


def _jax_generate(jmodel, variables, imgs, beam: bool, text=None, **kw):
    """JAX's tokens through its re-decode route (which tests/test_coca.py
    holds equal to its cached one), under one ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.coca import (
        generate as jax_generate,
        generate_beam as jax_generate_beam,
    )

    fn = jax_generate_beam if beam else jax_generate
    extra = {} if text is None else {"text": jnp.asarray(text)}
    run = jax.jit(lambda v, i: fn(jmodel, v, i, use_cache=False, **IDS, **extra, **kw))
    return np.asarray(run(variables, jnp.asarray(imgs)))


@pytest.mark.parametrize("rep", [1.0, 1.5])
def test_greedy_matches_jax_token_for_token(pair, rep):
    jmodel, variables, model = pair
    imgs = coca_images(3, seed=1)
    kw = dict(generation_type="top_k", top_k=1, seq_len=10, min_seq_len=2,
              repetition_penalty=rep)
    want = _jax_generate(jmodel, variables, imgs, False, **kw)
    got = generate(model, torch.from_numpy(imgs), **IDS, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == SOT).all() and (got == EOT).any(axis=1).all()


@pytest.mark.parametrize("case", range(len(BEAM_CASES)))
def test_beam_search_matches_jax_token_for_token(pair, case):
    jmodel, variables, model = pair
    imgs = coca_images(3, seed=1)
    want = _jax_generate(jmodel, variables, imgs, True, **BEAM_CASES[case])
    got = generate_beam(model, torch.from_numpy(imgs), **IDS, **BEAM_CASES[case]).numpy()
    np.testing.assert_array_equal(got, want)
    # the pools took part: some hypothesis ended early with EOT, then pad
    early = [row for row in got if EOT in row[:-1].tolist()]
    assert early and all((row[row.tolist().index(EOT) + 1:] == 0).all() for row in early)


def test_prompt_continuation_matches_jax(pair):
    jmodel, variables, model = pair
    imgs = coca_images(2, seed=4)
    prompt = np.array([[SOT, 5, 9], [SOT, 11, 3]], np.int32)
    kw = dict(generation_type="top_k", top_k=1, seq_len=10, min_seq_len=4)
    want = _jax_generate(jmodel, variables, imgs, False, text=prompt, **kw)
    got = generate(model, torch.from_numpy(imgs), text=torch.from_numpy(prompt), **IDS,
                   **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :3], prompt)
    # one 1-D prompt is tiled over the batch
    one = generate(model, torch.from_numpy(imgs), text=torch.from_numpy(prompt[0]), **IDS,
                   **kw).numpy()
    np.testing.assert_array_equal(one[:, :3], np.tile(prompt[:1], (2, 1)))


def test_cached_decode_equals_the_re_decode(pair):
    """Every mode through the KV caches gives the re-decode's tokens: greedy,
    top-p sampling under one generator seed, a prompt with the repetition
    penalty, and beams (grouped; one group with the penalty)."""
    _, _, model = pair
    imgs = torch.from_numpy(coca_images(2, seed=5))
    for kw in (dict(generation_type="top_k", top_k=1, seq_len=10, min_seq_len=2),
               dict(generation_type="top_p", top_p=0.7, seq_len=10, min_seq_len=2, seed=3),
               dict(generation_type="top_k", top_k=1, seq_len=10, min_seq_len=4,
                    text=torch.tensor([[SOT, 5, 9], [SOT, 11, 3]]), repetition_penalty=1.3)):
        seed = kw.pop("seed", 0)
        runs = [generate(model, imgs, use_cache=c, generator=torch.Generator().manual_seed(seed),
                         **IDS, **kw) for c in (True, False)]
        torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    for kw in (dict(num_beams=4, num_beam_groups=2, seq_len=9, min_seq_len=2),
               dict(num_beams=3, num_beam_groups=1, seq_len=8, min_seq_len=2,
                    repetition_penalty=1.2)):
        runs = [generate_beam(model, imgs, use_cache=c, **IDS, **kw) for c in (True, False)]
        torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    # generate's default mode is the beam search
    torch.testing.assert_close(
        generate(model, imgs, seq_len=9, min_seq_len=3, **IDS),
        generate_beam(model, imgs, seq_len=9, min_seq_len=3, **IDS), atol=0, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(generation_type="top_k", seq_len=16),                    # past the context
    dict(generation_type="top_k", seq_len=3, min_seq_len=3),       # not above the minimum
    dict(generation_type="beam_search", seq_len=16),
    dict(generation_type="beam_search", seq_len=8, num_beams=1),
    dict(generation_type="beam_search", seq_len=8, num_beams=6, num_beam_groups=4),
    dict(generation_type="beam_search", seq_len=16, num_beams=1),  # the beams checked first
    dict(generation_type="nucleus", seq_len=8),
])
def test_generation_errors_match_jax(pair, kw):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.coca import (
        generate as jax_generate,
    )

    jmodel, variables, model = pair
    kw = {"min_seq_len": 2, **kw}
    imgs = coca_images(1)
    with pytest.raises(ValueError) as want:
        jax_generate(jmodel, variables, jnp.asarray(imgs), **IDS, **kw)
    with pytest.raises(ValueError) as got:
        generate(model, torch.from_numpy(imgs), **IDS, **kw)
    assert str(got.value) == str(want.value)


def test_warpers_match_jax_on_the_same_logits():
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.coca import (
        top_k_filter as jax_top_k,
        top_p_filter as jax_top_p,
    )

    logits = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32) * 3
    for fn, jfn, params in ((top_k_filter, jax_top_k, (1, 3, 10)),
                            (top_p_filter, jax_top_p, (0.1, 0.5, 0.9))):
        for p in params:
            got = fn(torch.from_numpy(logits), p).numpy()
            want = np.asarray(jfn(jnp.asarray(logits), p))
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            np.testing.assert_array_equal(np.where(np.isinf(got), 0, got),
                                          np.where(np.isinf(want), 0, want))


@pytest.mark.parametrize("mode", [dict(generation_type="top_p", top_p=0.6),
                                  dict(generation_type="top_k", top_k=5, temperature=0.7)])
def test_sampling_is_reproducible_and_stays_in_the_kept_set(pair, mode):
    _, _, model = pair
    imgs = torch.from_numpy(coca_images(4, seed=6))
    kw = dict(seq_len=10, min_seq_len=3, **IDS, **mode)
    runs = [generate(model, imgs, generator=torch.Generator().manual_seed(s), **kw)
            for s in (11, 11, 12)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    assert not torch.equal(runs[0], runs[2])  # another seed draws otherwise
    tokens = runs[0]
    with torch.no_grad():
        logits = model.decode_logits(imgs, tokens).float()  # position t-1 predicts token t
    warp = top_p_filter if mode["generation_type"] == "top_p" else top_k_filter
    param = mode.get("top_p", mode.get("top_k"))
    drawn = 0
    for row in range(tokens.shape[0]):
        for t in range(1, 9):  # the last position is a forced EOT
            if tokens[row, t - 1] in (EOT, 0) and t > 1:
                break  # finished: pad follows
            step = logits[row, t - 1].clone()
            if t < 3:
                step[EOT] = float("-inf")
            assert torch.isfinite(warp(step[None], param)[0, tokens[row, t]]), (row, t)
            drawn += 1
    assert drawn >= 8


def test_registry_builds_the_coca_configs():
    """coca_ViT-B-32, coca_ViT-L-14 and coca_base build (on the meta device:
    no memory); coca_ViT-L-14 at 638,450,177 parameters; coca_roberta's HF
    text tower raises, citing item 14; the tokenizer gives 76 tokens."""
    from refining_clip_via_dinov2_representations_torch.models import (
        get_model_config, get_tokenizer, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.models.coca import CoCa

    counts = {}
    for name in ("coca_ViT-B-32", "coca_ViT-L-14", "coca_base"):
        cfg = parse_model_cfg(get_model_config(name))
        with torch.device("meta"):
            model = CoCa(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg, cfg.multimodal_cfg)
        counts[name] = sum(p.numel() for p in model.parameters())
    assert counts["coca_ViT-L-14"] == 638_450_177
    cfg = parse_model_cfg(get_model_config("coca_roberta-ViT-B-32"))
    with pytest.raises(NotImplementedError, match="item 14"), torch.device("meta"):
        CoCa(cfg.embed_dim, cfg.vision_cfg, cfg.text_cfg, cfg.multimodal_cfg)
    assert get_tokenizer("coca_ViT-L-14")(["a cat"]).shape == (1, 76)
