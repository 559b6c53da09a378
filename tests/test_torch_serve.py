"""The port's HTTP front end (serve.py) at tiny size on the CPU: endpoints,
micro-batching, and agreement with direct engine calls and the JAX engine;
the CLI's ``--pretrained`` (a seeded hub cache, no network), ``--quantize
int8`` and ``--checkpoint`` over ``--pretrained`` in process, and its
argparse surface against the JAX server's (``tpu/serve.py:291-300``)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
from refining_clip_via_dinov2_representations_torch.models import get_tokenizer
from refining_clip_via_dinov2_representations_torch.serve import (
    ClipServer, _Batcher, main, make_http_server,
)
from refining_clip_via_dinov2_representations_torch.transform import (
    PreprocessCfg, image_transform_v2,
)

from .torch_port_utils import TINY_CFG, jax_clip, offline, port_clip  # noqa: F401

# a tiny model whose matrices reach the int8 rule's least size (16k elements)
INT8_CFG = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 128, "layers": 1,
                   "head_width": 64},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 128, "heads": 2,
                 "layers": 1},
}
CLI_MODEL = "tiny-torch-serve-cli"


@pytest.fixture(scope="module")
def bundle():
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )

    jmodel, variables = jax_clip(TINY_CFG, seed=21)
    jax_engine = JaxEngine(jmodel, variables, (16, 16), 12, buckets=(2, 4))
    engine = ClipInferenceEngine(port_clip(TINY_CFG, variables["params"]), (16, 16), 12,
                                 buckets=(2, 4))
    tokenizer = get_tokenizer("ViT-B-16", context_length=12)
    preprocess = image_transform_v2(PreprocessCfg(size=16))
    server = ClipServer(engine, preprocess, tokenizer, batch_window_ms=50.0)
    httpd = make_http_server(server, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield engine, jax_engine, tokenizer, preprocess, server, \
        f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    server.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_b64(seed, size=(20, 16)):
    from PIL import Image

    arr = (np.random.default_rng(seed).random((*size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode(), arr


def test_health(bundle):
    base = bundle[-1]
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["buckets"] == [2, 4]
    assert body["context_length"] == 12 and body["image_size"] == [16, 16]
    assert body["device"] == "cpu" and body["quantize"] is None


def test_encode_text_matches_engine_and_jax(bundle):
    engine, jax_engine, tokenizer, _, _, base = bundle
    texts = ["a photo of a cat", "a drawing of a dog", "three birds"]
    status, body = _post(base, "/v1/encode_text", {"texts": texts})
    assert status == 200
    got = np.asarray(body["features"], np.float32)
    ids = tokenizer(texts)
    np.testing.assert_allclose(got, engine.encode_text(ids), atol=1e-6)
    np.testing.assert_allclose(got, jax_engine.encode_text(ids), atol=1e-4)


def test_encode_image_and_similarity(bundle):
    engine, jax_engine, tokenizer, preprocess, _, base = bundle
    b64s, arrs = zip(*(_png_b64(s) for s in range(3)))
    status, body = _post(base, "/v1/encode_image", {"images_b64": list(b64s)})
    assert status == 200
    feats = np.asarray(body["features"], np.float32)
    pixels = np.stack([preprocess(a) for a in arrs])
    np.testing.assert_allclose(feats, engine.encode_image(pixels), atol=1e-6)
    np.testing.assert_allclose(feats, jax_engine.encode_image(pixels), atol=1e-4)

    status, body = _post(base, "/v1/similarity",
                         {"texts": ["a cat", "a dog"], "images_b64": list(b64s)})
    assert status == 200
    logits = np.asarray(body["logits"], np.float32)
    scale, bias = engine.logit_terms()
    txt = engine.encode_text(tokenizer(["a cat", "a dog"]))
    np.testing.assert_allclose(logits, scale * feats @ txt.T + bias, atol=1e-4)


def test_bad_requests_and_caption(bundle):
    base = bundle[-1]
    status, body = _post(base, "/v1/encode_text", {"texts": []})
    assert status == 400 and "texts" in body["error"]
    assert _post(base, "/v1/nope", {})[0] == 404
    img, _ = _png_b64(9)
    status, body = _post(base, "/v1/caption", {"images_b64": [img]})
    assert status == 400 and "CoCa" in body["error"]


def test_concurrent_requests_coalesce_and_stay_correct(bundle):
    engine, _, tokenizer, _, server, base = bundle
    texts = [f"sample number {i}" for i in range(6)]
    want = engine.encode_text(tokenizer(texts))
    calls = []
    orig = server._text_batcher._fn

    def counting(x):
        calls.append(x.shape[0])
        return orig(x)

    server._text_batcher._fn = counting
    results = [None] * len(texts)
    barrier = threading.Barrier(len(texts))

    def worker(i):
        barrier.wait(timeout=30)
        status, body = _post(base, "/v1/encode_text", {"texts": [texts[i]]})
        if status == 200:
            results[i] = np.asarray(body["features"], np.float32)[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(texts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server._text_batcher._fn = orig
    assert not any(t.is_alive() for t in threads)
    for i in range(len(texts)):
        np.testing.assert_allclose(results[i], want[i], atol=1e-6)
    assert sum(calls) == 6 and len(calls) < 6, f"no coalescing: {calls}"


def test_batcher_error_reaches_every_waiter():
    def boom(x):
        raise RuntimeError("device exploded")

    b = _Batcher(boom, max_rows=8, window_ms=10.0)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            b.submit(np.zeros((2, 3)))
    finally:
        b.close()
    assert not b._thread.is_alive()


def test_cli_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model", "ViT-B-32", "--port", "0"])


@pytest.fixture
def hub(tmp_path, monkeypatch, offline):  # noqa: F811
    """``CLI_MODEL``'s ``openai`` tag as seeded weights in a hub cache, and
    other seeded weights as a state-dict file."""
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        jax_params_to_state_dict, pretrained, register_model_config,
    )

    register_model_config(CLI_MODEL, INT8_CFG)
    monkeypatch.setitem(pretrained._PRETRAINED, CLI_MODEL,
                        {"openai": {"hf_hub": "example/tiny-serve-cli/", "url": ""}})
    params = [jax_clip(INT8_CFG, attn_impl="xla", seed=s, jit=True)[1]["params"]
              for s in (31, 32)]
    snap = tmp_path / "hub" / "models--example--tiny-serve-cli" / "snapshots" / "seeded"
    snap.mkdir(parents=True)
    torch.save(jax_params_to_state_dict(params[0]), snap / "open_clip_pytorch_model.bin")
    torch.save(jax_params_to_state_dict(params[1]), tmp_path / "ckpt.pt")
    return {"cache": str(tmp_path / "hub"), "ckpt": str(tmp_path / "ckpt.pt"), "params": params}


def _cli_answers(argv):
    """Runs ``serve.main(argv)`` in this process; its /health and the
    features of three images and three texts."""
    got = {}

    def drive(httpd):
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                got["health"] = json.loads(r.read())
            got["image"] = _post(base, "/v1/encode_image",
                                 {"images_b64": [_png_b64(s)[0] for s in range(3)]})
            got["text"] = _post(base, "/v1/encode_text", {"texts": ["a cat", "a dog", "x"]})
        finally:
            httpd.shutdown()

    main(argv + ["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--buckets", "2", "4"],
         on_ready=drive)
    return got


@pytest.mark.parametrize("flags,weights", [
    (["--pretrained", "openai"], 0), (["--pretrained", "openai", "--quantize", "int8"], 0),
    (["--pretrained", "openai", "--checkpoint", "CKPT"], 1)], ids=["pretrained", "int8",
                                                                    "checkpoint"])
def test_cli_serves_the_tag_int8_and_a_checkpoint_over_the_tag(hub, flags, weights):
    import torch

    flags = [hub["ckpt"] if f == "CKPT" else f for f in flags]
    got = _cli_answers(["--model", CLI_MODEL, "--cache-dir", hub["cache"]] + flags)
    quantize = "int8" if "--quantize" in flags else None
    assert got["health"]["quantize"] == quantize and got["health"]["mesh"] is None
    assert got["image"][0] == got["text"][0] == 200
    engines = [ClipInferenceEngine(port_clip(INT8_CFG, p), (16, 16), 12, buckets=(2, 4),
                                   quantize=quantize) for p in hub["params"]]
    preprocess = image_transform_v2(PreprocessCfg(size=16))
    pixels = np.stack([preprocess(_png_b64(s)[1]) for s in range(3)])
    ids = get_tokenizer(CLI_MODEL)(["a cat", "a dog", "x"])
    img = np.asarray(got["image"][1]["features"], np.float32)
    txt = np.asarray(got["text"][1]["features"], np.float32)
    np.testing.assert_allclose(img, engines[weights].encode_image(pixels), atol=1e-6)
    np.testing.assert_allclose(txt, engines[weights].encode_text(ids), atol=1e-6)
    assert np.abs(img - engines[1 - weights].encode_image(pixels)).max() > 1e-3
    if quantize:
        assert any(p.dtype == torch.int8 for p in engines[0].model.parameters())
        fp32 = ClipInferenceEngine(port_clip(INT8_CFG, hub["params"][0]), (16, 16), 12,
                                   buckets=(2, 4))
        want = fp32.encode_image(pixels)
        assert (img * want).sum(-1).min() > 0.999 and np.abs(img - want).max() > 1e-6


def _jax_parser():
    """The JAX server's ``argparse`` parser, as its ``main`` builds it."""
    import argparse

    from refining_clip_via_dinov2_representations_tpu.serve import main as jax_main

    class Built(Exception):
        pass

    def stop(self, args=None, namespace=None):
        raise Built(self)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(Built) as e:
            jax_main([])
    return e.value.args[0]


def test_cli_flags_match_the_jax_server():
    from refining_clip_via_dinov2_representations_torch.serve import build_parser

    ours = {a.dest: a for a in build_parser()._actions}
    for a in _jax_parser()._actions:
        if a.dest == "help":
            continue
        mine = ours[a.dest]
        assert mine.option_strings == a.option_strings, a.dest
        for attr in ("default", "choices", "type", "nargs", "required"):
            assert getattr(mine, attr) == getattr(a, attr), (a.dest, attr)
