"""The port's tokenizer and validation transform against the JAX package's.

The port pre-tokenizes without the ``regex`` package; token ids must be equal
to the JAX ``SimpleTokenizer``'s, and the pre-tokenizer equal to the regex
pattern's ``findall``. The eval transform must give the same pixels.
"""

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch import tokenizer as port_tok
from refining_clip_via_dinov2_representations_torch.transform import (
    PreprocessCfg, image_transform_v2,
)

CORPUS = [
    "a photo of a cat",
    "A Photo Of Two DOGS playing in the SNOW!!!",
    "café naïve résumé façade Ångström Øresund Łódź",
    "東京タワーの写真 한국어 문장 中文句子",
    "digits 0123456789 and 3.14159, 1,000,000 and 42nd",
    "punctuation runs ?!?!... ---> <<>> ((())) ''' \"\"\" ;;::",
    "snake_case_name __dunder__ a_b_c",
    "it's they're we've I'm you'll he'd can't 'S 'LL",
    "superscripts x² y³, fractions ½ ¾, roman ⅫⅣ, circled ①②, ٣ ३",
    "long s ſtate 'ſ and kelvin K",
    "emoji 😀🐈‍⬛ 👍🏽 and symbols ©®™ €£¥",
    "combining é ä ñ and अनुच्छेद العربية",
    "html &amp; entities &lt;b&gt; &#39;quoted&#39;",
    "tabs\tand\nnewlines\r\n and   multiple    spaces ",
    "<start_of_text> literal specials <end_of_text> <START_OF_TEXT>",
    "",
    "x" * 200,
]


@pytest.fixture(scope="module")
def tokenizers():
    from refining_clip_via_dinov2_representations_tpu.tokenizer import SimpleTokenizer

    return SimpleTokenizer(), port_tok.SimpleTokenizer()


@pytest.mark.parametrize("context_length", [77, 8])
def test_token_ids_equal_jax(tokenizers, context_length):
    jax_tok, tok = tokenizers
    for text in CORPUS:
        assert tok.encode(text) == jax_tok.encode(text), text
    np.testing.assert_array_equal(tok(CORPUS, context_length=context_length),
                                  jax_tok(CORPUS, context_length=context_length))


def test_pre_tokenizer_equals_regex_findall(tokenizers):
    """Seeded random mixed-case strings over letters, marks, numbers,
    punctuation, symbols, apostrophes and spaces: the scanner splits like the
    case-insensitive regex."""
    jax_tok, _ = tokenizers
    pool = list("aZsStTrRlLdDmMvVeE'' ._-!?<>/") + [
        "é", "ß", "ſ", "İ", "²", "½", "Ⅻ", "٣", "́", "中", "ー", "😀", "‍",
        "©", " ", "<start_of_text>", "<end_of_text>", "'s", "'ll", "'re", "1", "9",
    ]
    rng = np.random.default_rng(0)
    for _ in range(300):
        text = "".join(rng.choice(pool, size=int(rng.integers(1, 40))))
        text = port_tok.whitespace_clean(text)
        specials = ["<start_of_text>", "<end_of_text>"]
        assert port_tok.pre_tokenize(text, specials) == jax_tok.pat.findall(text), text


def test_decode_and_module_helpers_equal_jax():
    from refining_clip_via_dinov2_representations_tpu import tokenizer as jax_tok

    ids = port_tok.tokenize(["a photo of a cat", "café ½"])
    np.testing.assert_array_equal(ids, jax_tok.tokenize(["a photo of a cat", "café ½"]))
    assert ids[0][:7].tolist() == [49406, 320, 1125, 539, 320, 2368, 49407]
    body = ids[1][1:list(ids[1]).index(49407)]
    assert port_tok.decode(body) == jax_tok.decode(body)


@pytest.mark.parametrize("cfg", [
    dict(size=224),
    dict(size=(48, 64)),
    dict(size=32, resize_mode="longest", fill_color=7),
    dict(size=32, resize_mode="squash", interpolation="bilinear"),
])
def test_validation_transform_equals_jax(cfg):
    from PIL import Image

    from refining_clip_via_dinov2_representations_tpu.transform import (
        PreprocessCfg as JaxCfg, image_transform_v2 as jax_transform,
    )

    port_t = image_transform_v2(PreprocessCfg(**cfg))
    jax_t = jax_transform(JaxCfg(**cfg), is_train=False)
    rng = np.random.default_rng(0)
    for hw in ((300, 200), (20, 24), (64, 64)):
        arr = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        for img in (Image.fromarray(arr), arr):
            got = port_t(img)
            assert got.dtype == np.float32 and got.shape[-1] == 3
            np.testing.assert_array_equal(got, jax_t(img))


def test_training_transform_is_not_ported():
    """The training transform is ported now: with a seed it gives the JAX
    package's pixels (``tests/test_torch_csv_data.py`` covers the branches)."""
    from PIL import Image

    from refining_clip_via_dinov2_representations_tpu.transform import (
        PreprocessCfg as JaxCfg, image_transform as jax_image_transform,
    )

    from refining_clip_via_dinov2_representations_torch.transform import image_transform

    assert image_transform_v2(PreprocessCfg(size=32), is_train=True).is_train
    got = image_transform(32, True, mean=PreprocessCfg().mean, std=PreprocessCfg().std, seed=2)
    cfg = JaxCfg(size=32)
    want = jax_image_transform(cfg.size, True, mean=cfg.mean, std=cfg.std, seed=2)
    assert got.is_train and got.image_size == (32, 32)
    img = Image.fromarray((np.random.default_rng(0).random((50, 40, 3)) * 255).astype(np.uint8))
    for _ in range(3):
        np.testing.assert_allclose(got(img), want(img), atol=1e-6, rtol=0)
