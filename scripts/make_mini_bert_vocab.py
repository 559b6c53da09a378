"""Write tests/assets/bert_vocab/tokenizer.json: a miniature
bert-base-uncased fast tokenizer for the CLIPA tokenizer path, offline.

The same pipeline and special-token layout as ``bert-base-uncased``'s
``tokenizer.json`` (BertNormalizer with lowercasing, BertPreTokenizer,
WordPiece with the ``##`` continuing prefix and ``[UNK]``, the template
``[CLS] $A [SEP]``; ids ``[PAD]`` 0, ``[unused0-98]`` 1-99, ``[UNK]`` 100,
``[CLS]`` 101, ``[SEP]`` 102, ``[MASK]`` 103) with a small vocabulary:
single characters and their ``##`` forms, a few hundred caption words and
some word pieces, so that greedy longest-match splits words. The ids do not
match the real vocabulary: this is test plumbing, not a parity vocabulary.

Run: python scripts/make_mini_bert_vocab.py
"""

import os
import string

from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

WORDS = (
    "the a an of to and in is on with for at by this that near over under one two three "
    "photo image picture showing shows colored background backdrop frame center left right "
    "top bottom small large circle square triangle cross red green blue yellow purple orange "
    "cyan white black gray navy olive cat dog bird horse person man woman child car train "
    "boat plane standing sitting running walking playing eating holding wearing street park "
    "beach water grass sky tree house building room table chair food ball hat shirt group "
    "young old little big cafe resume naive"
).split()
PIECES = "##s ##ing ##ed ##er ##ly ##es ##tion ##ness un re ##able ##ful".split()
CJK = "猫狗鸟人的一是不在有"


def build():
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                               "[MASK]"]
    chars = string.ascii_lowercase + string.digits + string.punctuation + CJK
    vocab += list(chars) + ["##" + c for c in string.ascii_lowercase + string.digits]
    vocab += [w for w in WORDS + PIECES if w not in vocab]
    tok = Tokenizer(models.WordPiece({t: i for i, t in enumerate(vocab)}, unk_token="[UNK]",
                                     max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                                strip_accents=None, lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 101), ("[SEP]", 102)])
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.add_special_tokens(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    return tok


if __name__ == "__main__":
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                       "assets", "bert_vocab", "tokenizer.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    build().save(out)
    print(out)
