"""CoCa training and serving in the port against the JAX package's, on the
CPU (the tiny CoCa of ``tests/torch_coca_utils.py``).

* ``coca_loss`` on the same features, logits and labels (pads among them)
  within 1e-6 relative.
* One step's loss and gradients through ``train/step.py``'s loss function
  against ``jax.value_and_grad`` of the JAX CoCa and ``coca_loss``: the
  loss at 1e-5 relative, every tensor's gradient at cosine >= 0.9999,
  with and without grad checkpointing (full and a selective policy).
* The optimizer's labels on CoCa's names, leaf for leaf against the JAX
  ``label_params`` under CustomTextCLIP's style, and the CLI's loss
  dispatch (CoCa before DINO) against the JAX CLI's.
* Serving: ``/v1/caption`` on the CPU returns JAX ``generate_beam``'s
  tokens, decoded; the parameter checks answer as the JAX server's.
* The CLI: a two-step CoCa run on mini-Flickr CSVs with
  ``--use_dino_general``, whose losses are CoCa's, whose validation has the
  caption loss and whose checkpoint loads strictly into an engine that
  captions.
"""

import base64
import io
import json
import math
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import coca_loss
from refining_clip_via_dinov2_representations_torch.models.convert import jax_params_to_state_dict
from refining_clip_via_dinov2_representations_torch.train import optim
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg, make_loss_fn

from .torch_coca_utils import BPE_COCA, coca_images, coca_texts, jax_coca, port_coca


@pytest.fixture(scope="module")
def pair():
    jmodel, variables = jax_coca(seed=5)
    return jmodel, variables


@pytest.mark.parametrize("weights", [(2.0, 1.0), (1.0, 0.0)])
def test_coca_loss_matches_jax(weights):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import coca_loss as jax_coca_loss

    rng = np.random.default_rng(9)
    img, txt = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    img, txt = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (img, txt))
    logits = rng.normal(size=(6, 11, 64)).astype(np.float32) * 2
    labels = coca_texts(6)[:, 1:]
    scale = np.float32(14.3)
    caption_w, clip_w = weights
    want = jax_coca_loss(*(jnp.asarray(a) for a in (img, txt, logits, labels, scale)),
                         caption_loss_weight=caption_w, clip_loss_weight=clip_w)
    got = coca_loss(*(torch.from_numpy(np.asarray(a)) for a in (img, txt, logits, labels, scale)),
                    caption_loss_weight=caption_w, clip_loss_weight=clip_w)
    assert (labels == 0).any()
    for k in ("contrastive_loss", "caption_loss"):
        w = float(want[k])
        assert float(got[k]) == pytest.approx(w, rel=1e-6, abs=1e-30), k


@pytest.fixture(scope="module")
def jax_step(pair):
    """The JAX loss and gradient (params tree) of one CoCa step."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import coca_loss as jax_coca_loss

    jmodel, variables = pair
    imgs, texts = coca_images(4, seed=8), coca_texts(4, seed=9)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, imgs, texts)
        losses = jax_coca_loss(out["image_features"], out["text_features"], out["logits"],
                               out["labels"], out["logit_scale"])
        return losses["contrastive_loss"] + losses["caption_loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, variables["params"]))
    return imgs, texts, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("remat", [False, True, "dots_with_no_batch_dims_saveable"])
def test_step_loss_and_gradients_match_jax(pair, jax_step, remat):
    _, variables = pair
    imgs, texts, want_loss, want_grads = jax_step
    model = port_coca(variables["params"], grad_checkpointing=remat).train()
    batch = {"images": torch.from_numpy(imgs), "texts": torch.from_numpy(texts).long()}
    loss, metrics = make_loss_fn(model, StepCfg(loss_type="coca"))(batch, 0)
    loss.backward()
    assert set(metrics) == {"logit_scale", "contrastive_loss", "caption_loss", "total_loss"}
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    want = jax_params_to_state_dict(want_grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys() and all(g is not None for g in got.values())
    for n, g in got.items():
        a, b = g.double().flatten(), want[n].double().flatten()
        cos = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
        assert cos >= 0.9999, (n, cos)


LABEL_CASES = [{}, dict(lock_image=True, lock_image_unlocked_groups=1),
               dict(lock_text=True), dict(lock_text=True, lock_text_unlocked_layers=1)]


@pytest.mark.parametrize("case", LABEL_CASES)
def test_optimizer_labels_match_jax(pair, case):
    import jax

    from refining_clip_via_dinov2_representations_tpu.train.optim import (
        OptimCfg as JaxCfg,
        label_params as jax_labels,
    )

    jmodel, variables = pair
    tree = {"model": variables["params"]}
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    index_tree = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    want = jax.tree_util.tree_leaves(jax_labels(tree, JaxCfg(text_tower_style="custom_text",
                                                             **case)))
    got = optim.label_params(list(jax_params_to_state_dict(variables["params"])),
                             optim.OptimCfg(text_tower_style="custom_text", **case))
    for name, idx in jax_params_to_state_dict(index_tree["model"]).items():
        # a fused pooler weight holds three JAX leaves, each labelled alike
        for i in np.unique(idx.numpy()).astype(int):
            assert got[name] == want[i], (name, got[name], want[i])
    assert len(got) == len(jax_params_to_state_dict(variables["params"]))


@pytest.mark.parametrize("argv", [["--model", "coca_ViT-L-14", "--use_dino_general"],
                                  ["--model", "ViT-B-16", "--use_coca"],
                                  ["--model", "coca_ViT-B-32", "--siglip"],
                                  ["--model", "ViT-B-16", "--siglip", "--use_dino_general"],
                                  ["--model", "ViT-B-16", "--use_dino_general"],
                                  ["--model", "ViT-B-16"]])
def test_loss_dispatch_matches_the_jax_cli(argv):
    from refining_clip_via_dinov2_representations_torch.train.main import resolve_loss_type
    from refining_clip_via_dinov2_representations_torch.train.params import parse_args
    from refining_clip_via_dinov2_representations_tpu.train.main import _resolve_loss_type
    from refining_clip_via_dinov2_representations_tpu.train.params import (
        parse_args as jax_parse_args,
    )

    assert resolve_loss_type(parse_args(argv)) == _resolve_loss_type(jax_parse_args(argv))


def _png_b64(pixels: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_caption_endpoint_returns_jax_beam_search_tokens():
    """The tiny CoCa with the BPE vocabulary behind the HTTP server: the
    captions of two PNG images are JAX ``generate_beam``'s tokens on the
    same preprocessed pixels (rounded to the engine's bf16, as the JAX
    engine rounds them), SOT stripped, cut at EOT and BPE-decoded; bad
    parameters answer 400 with the JAX server's messages."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer, make_http_server
    from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
    from refining_clip_via_dinov2_representations_torch.transform import (
        PreprocessCfg,
        image_transform_v2,
    )
    from refining_clip_via_dinov2_representations_tpu.models.coca import (
        generate_beam as jax_generate_beam,
    )
    from refining_clip_via_dinov2_representations_tpu.serve import ClipServer as JaxServer

    jmodel, variables = jax_coca(BPE_COCA, seed=6, eot=49407)
    engine = ClipInferenceEngine(port_coca(variables["params"], BPE_COCA), image_size=(32, 32),
                                 context_length=12, buckets=(2, 8))
    tokenizer = SimpleTokenizer(12)
    server = ClipServer(engine, image_transform_v2(PreprocessCfg(size=32), is_train=False),
                        tokenizer)
    rng = np.random.default_rng(4)
    images_b64 = [_png_b64(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)) for _ in range(2)]
    gen = dict(seq_len=9, num_beams=6, num_beam_groups=3, min_seq_len=3)
    pixels = server._decode_images(images_b64)
    want = np.asarray(jax.jit(lambda v, i: jax_generate_beam(jmodel, v, i, use_cache=False,
                                                             **gen))(
        variables, jnp.asarray(pixels).astype(jnp.bfloat16)))
    want_text = []
    for row in want.tolist():
        body = row[1:]  # SOT stripped, cut at the first EOT
        want_text.append(tokenizer.decode(body[:body.index(49407)] if 49407 in body
                                          else body).strip())
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, body = _post(base, "/v1/caption", {"images_b64": images_b64, **gen})
        assert status == 200 and body["captions"] == want_text
        for bad in ({"num_beams": 20}, {"seq_len": 40}, {"repetition_penalty": 0.0},
                    {"seq_len": "x"}, {"num_beams": 4, "num_beam_groups": 3}):
            status, body = _post(base, "/v1/caption", {"images_b64": images_b64[:1], **bad})
            assert status == 400 and "error" in body, bad
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    # the parameter checks answer as the JAX server's
    stub = SimpleNamespace(engine=SimpleNamespace(context_length=12))
    for gen_kw in ({"seq_len": "9", "num_beams": 4.0}, {"repetition_penalty": 1.23456},
                   {"num_beams": 20}, {"seq_len": 13}, {"min_seq_len": 0},
                   {"length_penalty": 101}, {"temperature": 1.0}):
        try:
            expected = JaxServer._validate_gen_kwargs(stub, gen_kw)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                server._validate_gen_kwargs(gen_kw)
            assert str(err.value) == str(e)
        else:
            assert server._validate_gen_kwargs(gen_kw) == expected


CLI_MODEL = "coca_tiny-torch-cli-test"


def test_cli_trains_coca_and_its_checkpoint_captions(tmp_path):
    """Two steps of a tiny CoCa (the BPE vocabulary) through ``train.main``
    on mini-Flickr CSVs, with ``--use_dino_general`` as a thesis run would
    pass it: the CoCa loss is taken (caption and contrastive terms logged),
    validation reports the caption loss, and the final checkpoint loads
    strictly into a model that captions through the engine."""
    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        create_model,
        register_model_config,
    )
    from refining_clip_via_dinov2_representations_torch.train.main import main
    from scripts.mini_flickr import generate

    register_model_config(CLI_MODEL, BPE_COCA)
    d = generate(str(tmp_path / "data"), n_train=2, n_val=2, size_px=32, dino_dim=16)
    records = main(["--model", CLI_MODEL, "--train-data", d["train_csv"], "--val-data",
                    d["val_csv"], "--dataset-type", "csv", "--batch-size", "5", "--epochs", "1",
                    "--workers", "1", "--logs", str(tmp_path), "--name", "run", "--precision",
                    "fp32", "--force-cpu", "--use_dino_general", "--dino_fts_path",
                    d["dino_feats"], "--dino_index_map_path", d["dino_index_map"],
                    "--log-every-n-steps", "1", "--coca-caption-loss-weight", "1.5"])
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        assert {"caption_loss", "contrastive_loss"} <= set(r) and "soft_loss" not in r
        assert r["total_loss"] == pytest.approx(r["caption_loss"] + r["contrastive_loss"],
                                                rel=1e-6)
    run = tmp_path / "run"
    with open(run / "final_itm_results.json") as f:
        results = json.load(f)
    for entry in results:
        metrics = entry["results"][0]["metrics"]
        assert math.isfinite(metrics["val_generative_loss"]) and metrics["val_generative_loss"] > 0
    assert "val_generative_loss" in (run / "out.log").read_text()
    model, _ = create_model(CLI_MODEL, str(run / "checkpoints" / "final_torch_state.pt"),
                            device="cpu")
    engine = ClipInferenceEngine(model, image_size=(32, 32), context_length=12, buckets=(2,))
    tokens = engine.caption_tokens(coca_images(2, seed=3), seq_len=8, num_beams=2,
                                   num_beam_groups=1, min_seq_len=2)
    assert tokens.shape == (2, 8) and (tokens[:, 0] == 49406).all()
