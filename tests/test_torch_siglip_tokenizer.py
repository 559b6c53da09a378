"""The port's SigLIP tokenizers (``tokenizer.py``: ``FastTokenizerFile``,
``HFTokenizer``, ``SigLipTokenizer``) against the JAX package's, which run
``transformers`` over the same committed vocabulary
(``tests/assets/siglip_vocab/c4_en_32000.json``): exactly the same ids for
fixed strings and hypothesis-made ones, at context 16 and 64 (truncation
included); the hub-snapshot and ``$REFINING_CLIP_VOCAB_DIR`` resolution;
``get_tokenizer``'s dispatch; the errors for what is missing; and no
``transformers`` import in the port's path. No host is contacted
(``offline``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from refining_clip_via_dinov2_representations_torch import tokenizer as ttok
from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

from .torch_port_utils import VOCAB, block_network, offline, seed_hub_snapshot  # noqa: F401

REPO = "timm/ViT-B-16-SigLIP"
FIXED = ["a photo of a cat", "", "  A Dog,  on the   beach!! ", "zzz qqq unknownword",
         "the " * 40, "a </s> b <unk>x <pad>", "▁a ▁▁b", "über café 東京 😀",
         "photograph of an image", "a_b-c", "A PHOTO OF THE DOG.", "\tnew\nline  ",
         "an image of a bird, a horse and a child"]
# words of the vocabulary, its pieces' fragments, and characters outside it
WORDS = st.sampled_from(["a", "the", "photo", "of", "cat", "dog", "image", "picture", "an",
                         "pho", "to", "x", "zq", "Über", "東", "!", ",", "</s>", "<unk>",
                         "▁", "  ", "_", "-"])
TEXTS = st.one_of(st.lists(WORDS, max_size=40).map(" ".join),
                  st.lists(WORDS, max_size=20).map("".join),
                  st.text(max_size=60))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The port's and the JAX package's tokenizers over one vocabulary: the
    direct ``.json`` path (``SigLipTokenizer``) and a seeded hub snapshot
    (``HFTokenizer``, ``clean`` canonicalize as ViT-B-16-SigLIP's config
    and whitespace)."""
    from refining_clip_via_dinov2_representations_tpu import tokenizer as jtok

    cache = str(tmp_path_factory.mktemp("hub"))
    seed_hub_snapshot(cache)
    with pytest.MonkeyPatch.context() as mp:
        block_network(mp)
        out = {"siglip": (ttok.SigLipTokenizer(VOCAB), jtok.SigLipTokenizer(VOCAB))}
        for clean in ("canonicalize", "whitespace"):
            out[f"hf {clean}"] = tuple(cls(REPO, clean=clean, cache_dir=cache)
                                       for cls in (ttok.HFTokenizer, jtok.HFTokenizer))
    return out


@pytest.mark.parametrize("context_length", [16, 64])
@pytest.mark.parametrize("which", ["siglip", "hf canonicalize", "hf whitespace"])
def test_fixed_strings_give_the_jax_ids(pairs, offline, which, context_length):
    port, jax_tok = pairs[which]
    got = port(FIXED, context_length=context_length)
    want = jax_tok(FIXED, context_length=context_length)
    assert got.dtype == np.int32 and got.shape == (len(FIXED), context_length)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["siglip", "hf whitespace"])
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXTS, context_length=st.sampled_from([16, 64]))
def test_hypothesis_strings_give_the_jax_ids(pairs, offline, which, text, context_length):
    port, jax_tok = pairs[which]
    np.testing.assert_array_equal(port([text], context_length=context_length),
                                  jax_tok([text], context_length=context_length))


def test_get_tokenizer_dispatches_as_jax(offline, tmp_path, monkeypatch):
    """``ViT-B-16-SigLIP``'s ``hf_tokenizer_name`` gives ``HFTokenizer`` over
    the snapshot under ``cache_dir`` with its config's ``clean:
    canonicalize``, the ids of the JAX ``get_tokenizer``; the snapshot's
    pad token decides the padding; a SigLIP name without an HF name gives
    ``SigLipTokenizer`` (through ``$REFINING_CLIP_VOCAB_DIR``)."""
    from refining_clip_via_dinov2_representations_tpu.models.factory import (
        get_tokenizer as jax_get_tokenizer,
    )
    from refining_clip_via_dinov2_representations_torch.models import register_model_config

    for pad in ("</s>", "<pad>"):
        cache = str(tmp_path / pad.strip("<>/"))
        seed_hub_snapshot(cache, pad_token=pad)
        got = get_tokenizer("ViT-B-16-SigLIP", cache_dir=cache)
        want = jax_get_tokenizer("ViT-B-16-SigLIP", cache_dir=cache)
        assert type(got).__name__ == type(want).__name__ == "HFTokenizer"
        assert got.context_length == 64 and got.clean_fn is ttok._clean_canonicalize
        ids = got(FIXED)
        np.testing.assert_array_equal(ids, want(FIXED))
        assert ids[0, 6] == (1 if pad == "</s>" else 0)  # 5 pieces, </s>, then the pad
    vocab_dir = tmp_path / "vocab"
    vocab_dir.mkdir()
    (vocab_dir / "c4_en_32000.json").write_text(open(VOCAB).read())
    monkeypatch.setenv("REFINING_CLIP_VOCAB_DIR", str(vocab_dir))
    register_model_config("tiny-siglip-no-hf-name", {"embed_dim": 32, "text_cfg": {
        "context_length": 16, "vocab_size": 256}, "vision_cfg": {}})
    tok = get_tokenizer("tiny-siglip-no-hf-name")
    assert isinstance(tok, ttok.SigLipTokenizer) and tok.context_length == 16
    np.testing.assert_array_equal(tok(FIXED), ttok.SigLipTokenizer(VOCAB, 16)(FIXED))
    np.testing.assert_array_equal(ttok.SigLipTokenizer("c4-en", 16)(FIXED), tok(FIXED))


def test_missing_and_unsupported_files_raise_naming_them(tmp_path, monkeypatch):
    """A repo with no cached snapshot names every path looked at; SigLIP2's
    gemma and the i18n mc4 vocabularies raise the JAX package's guidance;
    a sentencepiece ``.model`` names the package it needs; a pipeline the
    reader lacks is named."""
    with pytest.raises(FileNotFoundError, match="models--timm--ViT-B-16-SigLIP2"):
        get_tokenizer("ViT-B-16-SigLIP2", cache_dir=str(tmp_path))
    monkeypatch.delenv("REFINING_CLIP_VOCAB_DIR", raising=False)
    monkeypatch.setenv("REFINING_CLIP_HF_CACHE", str(tmp_path / "hf"))
    for name, vocab in (("ViT-B-16-SigLIP2", "gemma_256000.model"),
                        ("ViT-B-16-SigLIP-i18n-256", "mc4_250000.model"),
                        ("gemma", "gemma_256000.model")):
        with pytest.raises(FileNotFoundError, match="REFINING_CLIP_VOCAB_DIR") as e:
            ttok.SigLipTokenizer(name)
        assert vocab in str(e.value) and "hf_tokenizer_name" in str(e.value)
    model = tmp_path / "c4_en_32000.model"
    model.write_bytes(b"\x00")
    with pytest.raises(NotImplementedError, match="sentencepiece"):
        ttok.SigLipTokenizer(str(model))
    with pytest.raises(FileNotFoundError, match="neither an existing"):
        ttok.SigLipTokenizer("/nonexistent/path.model")
    spec = json.load(open(VOCAB))
    for key, value, what in (("model", {"type": "BPE", "vocab": {}, "merges": []}, "'BPE' model"),
                             ("normalizer", {"type": "NFKC"}, "normalizer 'NFKC'"),
                             ("pre_tokenizer", {"type": "Whitespace"},
                              "pre-tokenizer 'Whitespace'"),
                             ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁",
                                                "prepend_scheme": "first", "split": True},
                              "prepend_scheme 'first'")):
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps({**spec, key: value}))
        with pytest.raises(NotImplementedError, match=what):
            ttok.FastTokenizerFile(str(path))


def test_unigram_viterbi_unknowns_and_metaspace():
    """The reader's own rules on the committed vocabulary: the best-scoring
    segmentation, adjacent unknown characters fused into one ``<unk>``, runs
    of spaces opening one word, the template's ``</s>``, truncation that
    keeps it."""
    f = ttok.FastTokenizerFile(VOCAB, ["</s>", "<unk>", "<pad>"])
    piece = {p: i for i, p in enumerate(f.pieces)}  # a repeated piece: its last id
    assert f.encode("a photo") == [piece["▁a"], piece["▁photo"]]
    assert f.encode("photos") == [piece["▁photo"], piece["s"]]
    assert f._words("a  b") == ["▁a", "▁▁b"]
    assert f.encode("a üüx") == [piece["▁a"], piece["▁"], f.unk_id, piece["x"]]
    assert f.encode("a</s>b") == [piece["▁a"], 1, piece["▁b"]]
    assert f.frame(f.encode("a photo of a cat"), 4, pad_id=1) == \
        [piece["▁a"], piece["▁photo"], piece["▁of"], 1]
    assert f.frame([], 3, pad_id=1) == [1, 1, 1]


def test_the_port_never_imports_transformers(tmp_path):
    """Building and running every tokenizer of the port loads neither
    ``transformers`` nor ``tokenizers``."""
    cache = str(tmp_path)
    seed_hub_snapshot(cache)
    code = (
        "import sys\n"
        "from refining_clip_via_dinov2_representations_torch.models import get_tokenizer\n"
        "from refining_clip_via_dinov2_representations_torch.tokenizer import SigLipTokenizer\n"
        f"get_tokenizer('ViT-B-16-SigLIP', cache_dir={cache!r})(['a photo of a cat'])\n"
        f"SigLipTokenizer({VOCAB!r})(['a dog'])\n"
        "bad = [m for m in ('transformers', 'tokenizers', 'jax', 'sentencepiece') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "HF_HUB_OFFLINE": "1"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path),
                   timeout=120)
