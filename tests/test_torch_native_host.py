"""The port's host-side native cores (``native/``) and the raw uint8 path,
against the JAX package's on the same inputs:

* ``decode_jpeg`` equal to the JAX ``decode_jpeg`` on the same bytes (full
  size, DCT-scaled, grayscale; truncated, CMYK and non-JPEG streams None);
* ``raw_uint8_transform`` equal to JAX's, from an image and from bytes;
* CLIP token ids with and without the native BPE core equal to the JAX
  tokenizer's;
* eight threads encoding different captions with one ``NativeBPE`` each
  getting their own ids (the JAX wrapper's shared buffer not copied);
* the build directory's ownership check.
"""

import io
import os
import sys
import threading

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch import native
from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
from refining_clip_via_dinov2_representations_torch.transform import raw_uint8_transform

needs_jpeg = pytest.mark.skipif(native.load_native_jpeg() is None,
                                reason="libjpeg headers absent: the native decoder does not build")


def _image(w=320, h=240, mode="RGB"):
    from PIL import Image

    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([(x / 3 + y / 7) % 256, (y / 2) % 256, ((x + y) / 5) % 256],
                   -1).astype(np.uint8)
    return Image.fromarray(arr).convert(mode)


def _encode(img, fmt="JPEG", **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def test_the_cores_build_from_the_ports_sources():
    assert native.load_native() is not None
    assert native.library_path(native.BPE_SOURCE).parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "host_native")
    assert native.jpeg_decoder() in ("native", "PIL")


@needs_jpeg
@pytest.mark.parametrize("case", ["full", "scaled", "small", "gray"])
def test_decode_equals_jax(case):
    from refining_clip_via_dinov2_representations_tpu.native import decode_jpeg as jax_decode

    img, target = {"full": (_image(), 0), "scaled": (_image(1024, 768), 256),
                   "small": (_image(200, 150), 256), "gray": (_image(mode="L"), 100)}[case]
    data = _encode(img, quality=90)
    got, want = native.decode_jpeg(data, target), jax_decode(data, target)
    assert got is not None and got.dtype == np.uint8 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)
    if case == "scaled":
        assert got.shape == (288, 384, 3)  # 3/8: the smallest M/8 covering 256


@needs_jpeg
def test_refused_streams_give_none_as_in_jax():
    from refining_clip_via_dinov2_representations_tpu.native import decode_jpeg as jax_decode

    data = _encode(_image())
    for bad in (data[: len(data) // 2], _encode(_image(64, 64).convert("CMYK")),
                _encode(_image(64, 64), "PNG"), b"\xff\xd8" + b"garbage" * 20, b""):
        assert native.decode_jpeg(bad, 256) is None
        assert jax_decode(bad, 256) is None


@pytest.mark.parametrize("raw_size", [64, 100])
def test_raw_uint8_transform_equals_jax(raw_size, tmp_path):
    from refining_clip_via_dinov2_representations_tpu.transform import (
        raw_uint8_transform as jax_raw,
    )

    mine, theirs = raw_uint8_transform(raw_size), jax_raw(raw_size)
    assert mine.decode_min_dim == raw_size and mine.is_raw_uint8
    assert mine.image_size == (raw_size, raw_size)
    img = _image(300, 170)
    got = mine(img)
    assert got.dtype == np.uint8 and got.shape == (raw_size, raw_size, 3)
    np.testing.assert_array_equal(got, theirs(img))
    for data in (_encode(img, quality=88), _encode(img, "PNG")):
        np.testing.assert_array_equal(mine.apply_bytes(data), theirs.apply_bytes(data))
        path = tmp_path / "x.img"
        path.write_bytes(data)
        np.testing.assert_array_equal(mine.load_and_apply(str(path)),
                                      theirs.load_and_apply(str(path)))


CAPTIONS = ["a photo of a cat", "Two dogs play in the snow near a red barn.",
            "naïve café — 123 <start_of_text> x!!", "A man's bicycle, leaning on a wall",
            "UPPER lower MiXeD", "emoji 🙂 and tabs\tand\nnewlines", "",
            "a very " + "long " * 90 + "caption"]


@pytest.mark.parametrize("context_length", [77, 16])
def test_token_ids_with_and_without_the_native_core_equal_jax(context_length, monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )

    fast = SimpleTokenizer()
    with monkeypatch.context() as m:  # the core did not build: the Python merge loop runs
        m.setattr(native, "load_native", lambda: None)
        slow = SimpleTokenizer()
    assert fast._native is not None and slow._native is None
    want = JaxTokenizer()(CAPTIONS, context_length=context_length)
    np.testing.assert_array_equal(fast(CAPTIONS, context_length), want)
    np.testing.assert_array_equal(slow(CAPTIONS, context_length), want)
    np.testing.assert_array_equal(fast(CAPTIONS, context_length), want)  # memoised words


def test_eight_threads_share_one_native_bpe_and_keep_their_ids():
    tok = SimpleTokenizer()
    core = native.NativeBPE(list(tok.bpe_ranks), [tok.decoder[i] for i in range(tok.vocab_size)])
    words = ["".join(tok.byte_encoder[b] for b in w.encode()) for w in
             ("photograph", "skateboarding", "extraordinary", "motorcycle", "beach",
              "mountain", "umbrella", "xylophone")]
    want = {w: [tok.encoder[t] for t in tok.bpe(w).split(" ")] for w in words}
    barrier = threading.Barrier(8)
    errors = []

    def worker(word):
        barrier.wait()
        for _ in range(5000):
            got = core.encode_word(word)
            if got != want[word]:
                errors.append((word, got))
                return

    threads = [threading.Thread(target=worker, args=(w,)) for w in words]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a shared buffer shows at once
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]


def test_a_build_directory_others_can_write_is_refused(tmp_path, monkeypatch):
    shared = tmp_path / "shared"
    shared.mkdir()
    os.chmod(shared, 0o777)
    monkeypatch.setattr(native, "BUILD_DIR", shared)
    with pytest.raises(RuntimeError, match="not owned by the current user alone"):
        native.library_path(native.BPE_SOURCE)
