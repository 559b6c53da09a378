"""CLIPA in the port: the WordPiece tokenizer files of ``bert-base-uncased``
and CLIPA's engine, served as the JAX engine serves.

* ``tokenizer.py:FastTokenizerFile``'s WordPiece arm (BertNormalizer,
  BertPreTokenizer, greedy longest-match WordPiece with ``##`` and
  ``[UNK]``, ``[CLS] $A [SEP]``) through ``HFTokenizer`` against the JAX
  ``HFTokenizer`` (``AutoTokenizer`` offline over the same hub snapshot of
  the committed test vocabulary, ``tests/assets/bert_vocab/``): captions
  with accents, CJK, punctuation, control characters, unknown and
  over-long words, special tokens, empty and over-long text, at CLIPA's
  context 32 with and without ``strip_sep_token``, ids equal. The ids that
  ``chip_smoke.py`` expects on the card for its captions are these.
* ``get_tokenizer`` of every CLIPA name: ``HFTokenizer`` at context 32
  with ``strip_sep_token``; other pipeline components raise naming them.
* A tiny CLIPA CLIP served by ``serve.main`` from its ``datacomp1b`` tag (a
  seeded hub cache, no network): the text and image features against the
  port's engine (1e-6) and the JAX engine on the JAX tokenizer's ids (1e-4,
  the serve tests' tolerance), both at the server's default bf16; the fp32
  and int8 engines exported at one bucket and reloaded with
  ``load_exported``, each program equal to its engine (1e-6), the
  non-causal text program holding the kernel op.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch import tokenizer as ttok

from .test_torch_vit_variants import CLIPA_TINY
from .torch_port_utils import (  # noqa: F401
    BERT_TOKENIZER_CONFIG, BERT_VOCAB, block_network, images, jax_clip, offline, port_clip,
    seed_bert_snapshot,
)

CAPTIONS = ["a photo of a cat", "", "  A Dog,  on the   beach!! ",
            "Ünïcödé ÀÉÎ café résumé naïve ßtraße", "猫和狗 in the park 東京",
            "walking-running... (yes) $5 <b> a_b ~x|y", "unplayable xyzzy qqq",
            "a [CLS] b [SEP] c [MASK] [PAD] [UNK]", "tab\there\x0bvt\x00nul� end",
            "x" * 150 + " after", "the " * 40, "ǅ ǈ İstanbul ΣΑΣ ﬁ", "\tnew\nline  ",
            "A PHOTO OF THE DOG.", "running runner runs unplayed"]
CLIPA_NAMES = ["ViT-H-14-CLIPA", "ViT-H-14-CLIPA-336", "ViT-L-14-CLIPA", "ViT-L-14-CLIPA-336",
               "ViT-bigG-14-CLIPA", "ViT-bigG-14-CLIPA-336"]


@pytest.fixture(scope="module")
def bert_cache(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("hub"))
    seed_bert_snapshot(cache)
    return cache


@pytest.fixture(scope="module")
def pairs(bert_cache):
    """The port's and the JAX package's ``HFTokenizer`` over one snapshot,
    with and without ``strip_sep_token``."""
    from refining_clip_via_dinov2_representations_tpu import tokenizer as jtok

    with pytest.MonkeyPatch.context() as mp:
        block_network(mp)
        return {strip: tuple(cls("bert-base-uncased", context_length=32, strip_sep_token=strip,
                                 cache_dir=bert_cache)
                             for cls in (ttok.HFTokenizer, jtok.HFTokenizer))
                for strip in (True, False)}


@pytest.mark.parametrize("context_length", [32, 8])
@pytest.mark.parametrize("strip", [True, False])
def test_wordpiece_ids_equal_the_jax_hftokenizer(pairs, offline, strip, context_length):
    port, jax_tok = pairs[strip]
    got = port(CAPTIONS, context_length=context_length)
    want = jax_tok(CAPTIONS, context_length=context_length)
    assert type(jax_tok.tokenizer).__name__ == "BertTokenizerFast"
    assert got.dtype == np.int32 and got.shape == (len(CAPTIONS), context_length)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 101).all()  # [CLS]
    assert (102 in got) is not strip  # [SEP] is padding under strip_sep_token


def test_card_ids_are_the_jax_ids(pairs, offline):
    import chip_smoke

    assert chip_smoke.BERT_TOKENIZER_CONFIG == BERT_TOKENIZER_CONFIG
    assert os.path.samefile(chip_smoke.BERT_VOCAB if os.path.isabs(chip_smoke.BERT_VOCAB) else
                            os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                         chip_smoke.BERT_VOCAB), BERT_VOCAB)
    port, jax_tok = pairs[True]
    want = np.zeros((len(chip_smoke.CLIPA_IDS), 32), np.int32)
    for i, ids in enumerate(chip_smoke.CLIPA_IDS):
        want[i, :len(ids)] = ids
    np.testing.assert_array_equal(port(chip_smoke.CLIPA_CAPTIONS), want)
    np.testing.assert_array_equal(jax_tok(chip_smoke.CLIPA_CAPTIONS), want)


@pytest.mark.parametrize("name", CLIPA_NAMES)
def test_get_tokenizer_gives_clipa_its_wordpiece_tokenizer(bert_cache, name):
    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    tok = get_tokenizer(name, cache_dir=bert_cache)
    assert isinstance(tok, ttok.HFTokenizer) and tok.tokenizer.model_type == "WordPiece"
    assert tok.context_length == 32 and tok.strip_sep_token
    assert (tok.pad_token_id, tok.sep_token_id, tok.eos_token_id) == (0, 102, None)
    assert tok(["a cat"]).tolist() == [[101, 104, 270] + [0] * 29]


@pytest.mark.parametrize("change,named", [
    ({"normalizer": {"type": "Lowercase"}}, "Lowercase"),
    ({"pre_tokenizer": {"type": "Whitespace"}}, "Whitespace"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []}}, "BPE"),
    ({"post_processor": {"type": "RobertaProcessing"}}, "RobertaProcessing"),
    ({"model": "UNK_MISSING"}, "unk_token"),
])
def test_other_components_raise_naming_them(tmp_path, change, named):
    with open(BERT_VOCAB, encoding="utf-8") as f:
        spec = json.load(f)
    if change.get("model") == "UNK_MISSING":
        spec["model"]["unk_token"] = "<oov>"
    else:
        spec.update(change)
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(NotImplementedError, match=named):
        ttok.FastTokenizerFile(str(path))


def test_bert_normalizer_and_pre_tokenizer_pieces():
    assert ttok.bert_normalize("Héllo\tWÖRLD\x00猫!") == "hello world 猫 !"
    assert ttok.bert_normalize("Héllo", lowercase=False) == "Héllo"
    assert ttok.bert_normalize("Héllo", lowercase=False, strip_accents=True) == "Hello"
    assert ttok.bert_pre_tokenize("don't stop, $5 now") == ["don", "'", "t", "stop", ",", "$",
                                                            "5", "now"]


CLI_MODEL = "tiny-torch-clipa-serve"


@pytest.fixture
def clipa_hub(tmp_path, monkeypatch, offline, bert_cache):  # noqa: F811
    """``CLI_MODEL`` (``CLIPA_TINY``) with a ``datacomp1b`` tag whose hub repo
    holds seeded weights, beside the bert-base-uncased snapshot."""
    from refining_clip_via_dinov2_representations_torch.models import (
        jax_params_to_state_dict, pretrained, register_model_config,
    )
    cache = tmp_path / "hub"
    shutil.copytree(bert_cache, cache)
    register_model_config(CLI_MODEL, CLIPA_TINY)
    tag = {"datacomp1b": {"hf_hub": "example/tiny-clipa/", "url": "",
                          "mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225),
                          "interpolation": "bilinear", "resize_mode": "squash"}}
    monkeypatch.setitem(pretrained._PRETRAINED, CLI_MODEL, tag)
    jmodel, variables = jax_clip(CLIPA_TINY, attn_impl="xla", seed=41, jit=True)
    snap = cache / "models--example--tiny-clipa" / "snapshots" / "seeded"
    snap.mkdir(parents=True)
    torch.save(jax_params_to_state_dict(variables["params"]), snap / "open_clip_pytorch_model.bin")
    return {"cache": str(cache), "jax": (jmodel, variables)}


def test_clipa_serves_from_its_tag_as_the_jax_engine(clipa_hub):
    from PIL import Image

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model_and_transforms,
    )
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )
    from refining_clip_via_dinov2_representations_tpu.tokenizer import HFTokenizer as JaxTok

    from .test_torch_serve import _cli_answers, _png_b64

    got = _cli_answers(["--model", CLI_MODEL, "--pretrained", "datacomp1b", "--cache-dir",
                        clipa_hub["cache"]])
    assert got["image"][0] == got["text"][0] == 200
    # the tag's weights and preprocessing (ImageNet mean and std, bilinear,
    # squash), as served, in engines of the server's defaults
    model, preprocess = create_model_and_transforms(CLI_MODEL, pretrained="datacomp1b",
                                                    cache_dir=clipa_hub["cache"], device="cpu")
    engine = ClipInferenceEngine(model, (16, 16), 32, buckets=(2, 4))
    jax_engine = JaxEngine(*clipa_hub["jax"], (16, 16), 32, buckets=(2, 4))
    pixels = np.stack([preprocess(Image.fromarray(_png_b64(s)[1])) for s in range(3)])
    ids = JaxTok("bert-base-uncased", context_length=32, strip_sep_token=True,
                 cache_dir=clipa_hub["cache"])(["a cat", "a dog", "x"])
    for what, call, jax_call, x in (("image", engine.encode_image, jax_engine.encode_image,
                                     pixels),
                                    ("text", engine.encode_text, jax_engine.encode_text, ids)):
        served = np.asarray(got[what][1]["features"], np.float32)
        np.testing.assert_allclose(served, call(x), atol=1e-6, err_msg=what)
        np.testing.assert_allclose(served, np.asarray(jax_call(x)), atol=1e-4, err_msg=what)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_clipa_engine_exports_one_bucket(tmp_path, quantize):
    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, load_exported,
    )

    from .test_torch_export import _fused_calls
    from .test_torch_vit_variants import clipa_token_ids

    _, variables = jax_clip(CLIPA_TINY, attn_impl="xla", seed=42, jit=True)
    engine = ClipInferenceEngine(port_clip(CLIPA_TINY, variables["params"], attn_impl="fused"),
                                 (16, 16), 32, buckets=(2,), quantize=quantize,
                                 quantize_min_size=1024)
    if quantize:
        assert any(p.dtype == torch.int8 for p in engine.model.parameters())
    written = engine.export(str(tmp_path))
    assert sorted(written) == ["encode_image_b2", "encode_text_b2"]
    x, ids = images(2, 16, seed=43), clipa_token_ids(2, seed=44)
    for name, arg, fn in (("encode_image_b2", x, engine.encode_image),
                          ("encode_text_b2", ids, engine.encode_text)):
        got = load_exported(written[name])(arg)
        np.testing.assert_allclose(np.asarray(got), fn(arg), atol=1e-6, err_msg=name)
        assert len(_fused_calls(torch.export.load(written[name]))) == 2, name
