"""Serving a model split over gloo ranks, and SigLIP and CoCa on the model
axis, against one process (CPU, ``tests/torch_dist_utils.py`` ranks).

* The engine (``inference.py``) on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``
  meshes, rank 0 driving and the others in ``follow``, against the
  one-process engine on the same seeded weights: features within 1e-5
  (fp32), requests that pad, that fill a bucket and that chunk past the
  top one; the buckets rounded to the data axis as the JAX engine rounds
  them (a JAX engine on a data-2 mesh of the forced host devices); the
  model axis holds half the heads on each rank.
* ``mesh`` with int8 at ``(1, 2)``: the int8 weights whole on every rank,
  the features within 1e-5 of the one-process int8 engine.
* A tiny CoCa captioned at ``(1, 2)`` (the grouped beam search, every
  decode step's logits all-reduced): the same tokens as one process.
* The serve CLI under two ranks (``--mesh-model-axis 2 --device cpu``):
  rank 0 answers ``/health``, ``/v1/encode_image`` and ``/v1/similarity``
  with the one-process engine's numbers (1e-5), the follower returns when
  rank 0 shuts down.
* One fp32 train step of a tiny SigLIP (its timm trunk and MAP head split)
  and of a tiny CoCa (its pooler whole) at ``(1, 2)`` against the same step
  in one process on the same rows: loss within 1e-5 relative, every whole
  gradient at cosine >= 0.9999; the ``(1, 2)`` checkpoint
  (``full_state_dict``) loads strictly into a one-process model and equals
  its stepped weights at 1e-5 relative and 5e-6 absolute (AdamW, lr 1e-3,
  eps 1e-3, as ``tests/test_torch_tp_step.py``; the attention's key biases
  aside: ``_no_key_bias``).
"""

import numpy as np
import pytest

from .torch_coca_utils import TINY_COCA, coca_images, coca_texts
from .torch_dist_utils import run_ranks
from .torch_port_utils import TINY_CFG, images, token_ids

BUCKETS = (1, 3, 8)
SIGLIP_DIMS = (32, 2, 4, 64)  # width, layers, heads, mlp_dim of the "base" family
TP_SIGLIP = {
    "embed_dim": 32, "custom_text": True, "init_logit_bias": -10,
    "vision_cfg": {"image_size": 32, "timm_model_name": "vit_base_patch8_siglip_32",
                   "timm_model_pretrained": False, "timm_pool": "map", "timm_proj": "none"},
    "text_cfg": {"context_length": 16, "vocab_size": 256, "width": 32, "heads": 4,
                 "layers": 2, "no_causal_mask": True, "norm_kwargs": {"eps": 1e-6},
                 "pool_type": "last", "proj_bias": True},
}
CLI_MODEL = "tiny-torch-tp-serve"
COCA_IDS = dict(sot_token_id=62, eot_token_id=63, pad_token_id=0)


def _tiny_model(cfg, seed, noise=0.02):
    """The port's model at ``cfg``, seeded, every tensor perturbed (numpy)."""
    import torch

    from refining_clip_via_dinov2_representations_torch.models import build_model, parse_model_cfg
    from refining_clip_via_dinov2_representations_torch.models import siglip

    siglip._SIGLIP_FAMILY_DIMS["base"] = SIGLIP_DIMS  # this process's tiny SigLIP family
    model = build_model(parse_model_cfg(cfg), attn_impl="xla", seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim():
                p.add_(torch.from_numpy(rng.normal(0.0, noise, p.shape).astype(np.float32)))
    return model


def _engines(mesh, cfg, seed, **kw):
    """(one-process engine, engine on ``mesh``) on the same weights."""
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine

    size = cfg["vision_cfg"]["image_size"]
    ctx = cfg["text_cfg"]["context_length"]
    return [ClipInferenceEngine(_tiny_model(cfg, seed), (size, size), ctx, buckets=BUCKETS,
                                dtype=torch.float32, mesh=m, **kw) for m in (None, mesh)]


def _engine_case(mesh, cfg=TINY_CFG, **kw):
    """Rank 0: {what: max |mesh - one process|}, the buckets and the local
    heads; the others follow."""
    one, eng = _engines(mesh, cfg, seed=5, **kw)
    import torch

    blk = eng.model.visual.transformer.resblocks[0].attn
    local = {"vision_rows": tuple(blk.in_proj_weight.shape),
             "int8": any(p.dtype == torch.int8 for p in eng.model.parameters())}
    if not eng.leader:
        eng.follow()
        return local
    out = {"buckets": eng.buckets, **local}
    for n in (2, 3, 9):
        x, ids = images(n, 16, seed=n), token_ids(n, 12, seed=n)
        out[f"image{n}"] = float(np.abs(eng.encode_image(x) - one.encode_image(x)).max())
        out[f"text{n}"] = float(np.abs(eng.encode_text(ids) - one.encode_text(ids)).max())
    eng.warmup()
    eng.stop()
    return out


def _caption_case(mesh):
    one, eng = _engines(mesh, TINY_COCA, seed=6)
    if not eng.leader:
        eng.follow()
        return None
    x = coca_images(3, seed=4)
    got = eng.caption_tokens(x, seq_len=10, num_beams=4, num_beam_groups=2, min_seq_len=3,
                             **COCA_IDS)
    eng.stop()
    return got.tolist(), one.caption_tokens(x, seq_len=10, num_beams=4, num_beam_groups=2,
                                            min_seq_len=3, **COCA_IDS).tolist()


def _png_b64(seed):
    import base64
    import io

    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, (20, 16, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _cli_case(rank):
    """The serve CLI at ``--mesh-model-axis 2``: rank 0's answers beside the
    one-process engine's."""
    import json
    import urllib.request

    from refining_clip_via_dinov2_representations_torch.inference import create_engine
    from refining_clip_via_dinov2_representations_torch.models import register_model_config
    from refining_clip_via_dinov2_representations_torch.serve import main

    register_model_config(CLI_MODEL, TINY_CFG)
    argv = ["--model", CLI_MODEL, "--device", "cpu", "--mesh-model-axis", "2", "--host",
            "127.0.0.1", "--port", "0", "--buckets", "2", "4"]
    got = {}

    def drive(httpd):
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(path, payload):
            req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        try:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                got["health"] = json.loads(r.read())
            pngs = [_png_b64(s) for s in range(3)]
            got["features"] = post("/v1/encode_image", {"images_b64": pngs})["features"]
            got["logits"] = post("/v1/similarity", {"images_b64": pngs,
                                                    "texts": ["a cat", "a dog"]})["logits"]
        finally:
            httpd.shutdown()

    main(argv, on_ready=drive if rank == 0 else None)
    if rank:
        return None
    engine, preprocess, tokenizer = create_engine(CLI_MODEL, device="cpu", buckets=(2, 4),
                                                  warm=False)
    from refining_clip_via_dinov2_representations_torch.serve import ClipServer

    server = ClipServer(engine, preprocess, tokenizer)
    try:
        pngs = [_png_b64(s) for s in range(3)]
        want_f = server.encode_image_b64(pngs)
        want_l = server.similarity(["a cat", "a dog"], pngs)
    finally:
        server.close()
    return {"health": got["health"],
            "features": float(np.abs(np.asarray(got["features"]) - want_f).max()),
            "logits": float(np.abs(np.asarray(got["logits"]) - want_l).max())}


def _step_case(mesh, family):
    """One fp32 step of ``family`` split over the model group against the
    same step in one process: (losses, min gradient cosine and where, the
    split checkpoint, the one-process weights after the step)."""
    import copy

    import torch

    from refining_clip_via_dinov2_representations_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, full_state_dict, tp_sharding, wrap_ddp,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg, Towers, TrainState, make_train_step, train_parameters, train_splits,
    )

    cfg = TP_SIGLIP if family == "siglip" else TINY_COCA
    base = _tiny_model(cfg, seed=7).train()
    if family == "siglip":
        batch = {"images": torch.from_numpy(images(4, 32, seed=11)),
                 "texts": torch.from_numpy(np.random.default_rng(12).integers(
                     3, 256, (4, 16))).long()}
    else:
        batch = {"images": torch.from_numpy(coca_images(4, seed=11)),
                 "texts": torch.from_numpy(coca_texts(4, seed=12)).long()}
    mp = model_parallel(mesh[MODEL_AXIS].get_group())
    step_cfg = StepCfg(loss_type=family)
    out = {}
    for route in ("single", "tp"):
        model = copy.deepcopy(base)
        sharding = towers = group = None
        splits = {}
        if route == "tp":
            shard_module(model, mp)
            splits = train_splits(model, None)
            dgroup = mesh[DATA_AXIS].get_group()
            sharding = tp_sharding(train_parameters(model, None), dgroup, mp, splits)
            towers = wrap_ddp(Towers(model, None), torch.device("cpu"), dgroup)
        opt, _ = optim.build_optimizer(train_parameters(model, None),
                                       optim.OptimCfg(lr=1e-3, eps=1e-3),
                                       scheduler.const_lr(1e-3, 0, 1), sharding=sharding)
        step = make_train_step(model, step_cfg, group=group, towers=towers)
        _, m = step(TrainState(model, None, opt), batch)
        grads = {n: (gather_tensor(p.grad, splits[n], mp) if n in splits else p.grad).double()
                 .flatten() for n, p in train_parameters(model, None).items()}
        out[route] = (float(m["total_loss"]), grads, full_state_dict(model))
    cos = {n: float(torch.nn.functional.cosine_similarity(g, out["single"][1][n], dim=0))
           for n, g in out["tp"][1].items() if out["single"][1][n].abs().max() > 0}
    return {"loss": out["tp"][0], "one_loss": out["single"][0],
            "min_cos": min(cos.values()), "min_cos_at": min(cos, key=cos.get),
            "n_split": len(getattr(model, "tp_splits", {})),
            "checkpoint": {k: v.numpy() for k, v in out["tp"][2].items()},
            "one": {k: v.numpy() for k, v in out["single"][2].items()}}


def _world2(rank, world):
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh

    mesh12 = create_mesh(model=2, device_type="cpu")
    res = {"engine_1x2": _engine_case(mesh12),
           "int8_1x2": _engine_case(mesh12, quantize="int8", quantize_min_size=256),
           "caption_1x2": _caption_case(mesh12),
           "cli": _cli_case(rank)}
    for family in ("siglip", "coca"):
        step = _step_case(mesh12, family)
        res[family] = step if rank == 0 else {k: step[k] for k in ("loss", "min_cos")}
    res["engine_2x1"] = _engine_case(create_mesh(model=1, device_type="cpu"))
    return res


def _world4(rank, world):
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh

    return _engine_case(create_mesh(model=2, device_type="cpu"))


@pytest.fixture(scope="module")
def ranks():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        two, four = pool.submit(run_ranks, _world2, 2), pool.submit(run_ranks, _world4, 4)
        return {2: two.result(), 4: four.result()}


def _jax_buckets(data):
    """The JAX engine's buckets for ``BUCKETS`` on a ``(data, 1)`` mesh."""
    import jax

    from refining_clip_via_dinov2_representations_tpu.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_tpu.parallel.mesh import create_mesh

    from .torch_port_utils import jax_clip

    model, variables = jax_clip(TINY_CFG, attn_impl="xla")
    mesh = create_mesh(data=data, model=1, devices=jax.devices()[:data])
    return ClipInferenceEngine(model, variables, (16, 16), 12, buckets=BUCKETS,
                               mesh=mesh).buckets


@pytest.mark.parametrize("case,world,data", [("engine_1x2", 2, 1), ("engine_2x1", 2, 2),
                                             ("engine_2x2", 4, 2)])
def test_mesh_engine_matches_one_process(ranks, case, world, data):
    results = ranks[world] if world == 4 else [r[case] for r in ranks[2]]
    got = results[0]
    assert got["buckets"] == _jax_buckets(data) == ((2, 4, 8) if data == 2 else BUCKETS)
    errs = {k: v for k, v in got.items() if k.startswith(("image", "text"))}
    assert errs and max(errs.values()) <= 1e-5, errs
    model_axis = world // data
    # the vision tower's 2 heads of 16: this rank's rows of the packed QKV
    assert all(r["vision_rows"] == (96 // model_axis, 32) for r in results)


def test_mesh_int8_replicates_the_int8_weights(ranks):
    results = [r["int8_1x2"] for r in ranks[2]]
    assert all(r["int8"] and r["vision_rows"] == (96, 32) for r in results)
    errs = {k: v for k, v in results[0].items() if k.startswith(("image", "text"))}
    assert max(errs.values()) <= 1e-5, errs


def test_coca_caption_on_the_model_axis_equals_one_process(ranks):
    got, want = ranks[2][0]["caption_1x2"]
    assert got == want and len(got) == 3 and all(row[0] == 62 for row in got)


def test_serve_cli_answers_on_rank_0_with_a_follower(ranks):
    cli = ranks[2][0]["cli"]
    assert cli["health"]["mesh"] == {"data": 1, "model": 2}
    assert cli["health"]["buckets"] == [2, 4] and cli["health"]["quantize"] is None
    assert cli["features"] <= 1e-5 and cli["logits"] <= 1e-4
    assert ranks[2][1]["cli"] is None


@pytest.mark.parametrize("family", ["siglip", "coca"])
def test_family_step_on_the_model_axis_matches_one_process(ranks, family):
    import torch

    from refining_clip_via_dinov2_representations_torch.models import build_model, parse_model_cfg
    from refining_clip_via_dinov2_representations_torch.models import siglip

    r0 = ranks[2][0][family]
    assert r0["n_split"] > 0
    for r in ranks[2]:
        np.testing.assert_allclose(r[family]["loss"], r0["one_loss"], rtol=1e-5)
        assert r[family]["min_cos"] >= 0.9999, (r[family]["min_cos"], r0["min_cos_at"])
    cfg = TP_SIGLIP if family == "siglip" else TINY_COCA
    saved = siglip._SIGLIP_FAMILY_DIMS["base"]
    siglip._SIGLIP_FAMILY_DIMS["base"] = SIGLIP_DIMS
    try:
        model = build_model(parse_model_cfg(cfg), attn_impl="xla")
    finally:
        siglip._SIGLIP_FAMILY_DIMS["base"] = saved
    model.load_state_dict({k: torch.from_numpy(v) for k, v in r0["checkpoint"].items()},
                          strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(_no_key_bias(k, v.numpy()), _no_key_bias(k, r0["one"][k]),
                                   rtol=1e-5, atol=5e-6, err_msg=k)


def _no_key_bias(name, v):
    """``v`` without its key-bias part: that gradient is zero but for rounding
    (a key bias moves every score of a query alike), and AdamW's update turns
    rounding noise into steps of the learning rate's size."""
    if name.endswith(("qkv.bias", "in_proj_bias")):
        q, _, val = np.split(v, 3)
        return np.concatenate([q, val])
    return np.split(v, 2)[1] if name.endswith("attn_pool.kv.bias") else v
