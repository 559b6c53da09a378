"""Shared helpers of the ``test_torch_*`` files: one set of weights in both
the JAX package and its PyTorch port.

A JAX CLIP (or DINOv2 teacher) is initialised from a seed, every parameter
is then perturbed by seeded numpy noise (so LayerNorm scales, biases and
every other leaf differ from their init constants), and the tree is carried
into the port through ``jax_params_to_state_dict`` (``jax_dinov2_params_
to_state_dict``) with ``strict=True``. JAX is imported inside the
functions, so test files stay importable where JAX is absent.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil

import numpy as np
import pytest

TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 32,
                   "layers": 2, "head_width": 16},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32,
                 "heads": 4, "layers": 2},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread for a module that imports this fixture, the
    count before restored after it: tests of many small ops (tiny towers,
    the kernels' schedule models) otherwise spin OpenMP threads against the
    other test workers' processes."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_clip(cfg_dict, attn_impl: str = "fused", seed: int = 0, noise: float = 0.02,
             jit: bool = False):
    """(flax module, variables) with seeded, perturbed fp32 params; ``jit``
    compiles the init once (faster than op by op; other last bits)."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model, parse_model_cfg,
    )

    cfg = parse_model_cfg(cfg_dict)
    model = build_model(cfg, attn_impl=attn_impl)
    size = cfg.vision_cfg.image_size
    variables = (jax.jit(model.init) if jit else model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32),
    )
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) if "logit_scale" in jax.tree_util.keystr(path)
        else np.asarray(x) + rng.normal(0.0, noise, np.shape(x)).astype(np.float32),
        jax.device_get(variables["params"]),
    )
    return model, {"params": params}


def port_clip(cfg_dict, params, attn_impl: str = "auto"):
    """The port's CLIP on the CPU holding the JAX params."""
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, jax_params_to_state_dict, parse_model_cfg,
    )

    model = build_model(parse_model_cfg(cfg_dict), attn_impl=attn_impl)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


# a tiny DINOv2: head dim 8, a 3x3 position table (42 px at patch 14)
DINO_TINY = dict(hidden_size=32, layers=2, heads=4, mlp_ratio=2, patch_size=14,
                 native_image_size=42)


def jax_dinov2(use_swiglu: bool = False, seed: int = 3, noise: float = 0.05):
    """(flax Dinov2, variables) of ``DINO_TINY`` with seeded, perturbed fp32
    params."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models.dinov2 import Dinov2, Dinov2Cfg

    model = Dinov2(cfg=Dinov2Cfg(**DINO_TINY, use_swiglu_ffn=use_swiglu))
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, noise, np.shape(x)).astype(
        np.float32), jax.device_get(variables["params"]))
    return model, {"params": params}


def port_dinov2(params, use_swiglu: bool = False, attn_impl: str = "xla"):
    """The port's Dinov2 on the CPU holding the JAX params."""
    from refining_clip_via_dinov2_representations_torch.models import (
        Dinov2, Dinov2Cfg, jax_dinov2_params_to_state_dict,
    )

    model = Dinov2(Dinov2Cfg(**DINO_TINY, use_swiglu_ffn=use_swiglu), attn_impl=attn_impl)
    model.load_state_dict(jax_dinov2_params_to_state_dict(params), strict=True)
    return model.eval()


def images(n: int, size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def token_ids(n: int, context_length: int, seed: int = 2) -> np.ndarray:
    """Random CLIP-framed rows: SOT, random ids, EOT (the max id), zero pad."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, context_length), np.int32)
    for i in range(n):
        length = int(rng.integers(1, context_length - 1))
        out[i, 0] = 49406
        out[i, 1:1 + length] = rng.integers(1, 49405, length)
        out[i, 1 + length] = 49407
    return out


# the smallest config an OpenAI archive can describe: OpenAI's shapes give
# heads = width // 64 in both towers, so both are 64 wide (one head each)
OPENAI_TINY_CFG = {
    "embed_dim": 32,
    "quick_gelu": True,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 64, "layers": 2},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 64,
                 "heads": 1, "layers": 2},
}


@pytest.fixture
def offline(monkeypatch):
    """No outside host is reached during the test (``block_network``)."""
    block_network(monkeypatch)


def block_network(monkeypatch) -> None:
    """The hub libraries offline, and a name lookup or connection to any
    host but this one fails (``monkeypatch``'s undo restores them)."""
    import socket

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for module, attr in (("huggingface_hub.constants", "HF_HUB_OFFLINE"),
                         ("transformers.utils.hub", "_is_offline_mode")):
        try:
            monkeypatch.setattr(importlib.import_module(module), attr, True)
        except (ImportError, AttributeError):
            pass
    local = ("localhost", "127.0.0.1", "::1", "0.0.0.0", "", None)
    real_lookup, real_connect = socket.getaddrinfo, socket.socket.connect

    def lookup(host, *args, **kwargs):
        assert host in local, f"network access attempted: {host}"
        return real_lookup(host, *args, **kwargs)

    def connect(sock, address):
        assert not isinstance(address, tuple) or address[0] in local, (
            f"network access attempted: {address}")
        return real_connect(sock, address)

    monkeypatch.setattr(socket, "getaddrinfo", lookup)
    monkeypatch.setattr(socket.socket, "connect", connect)


# the committed c4-en fast-tokenizer file (a 210-piece Unigram vocabulary in
# the published tokenizer.json layout)
VOCAB = os.path.join(os.path.dirname(__file__), "assets", "siglip_vocab", "c4_en_32000.json")


def seed_hub_snapshot(cache: str, repo: str = "timm/ViT-B-16-SigLIP", state_dict=None,
                      pad_token: str = "</s>") -> str:
    """The published hub layout of a SigLIP repo under ``cache``: the
    committed test vocabulary as ``tokenizer.json``, a T5 tokenizer config,
    and ``state_dict`` as ``open_clip_pytorch_model.bin`` where given."""
    root = os.path.join(cache, "models--" + repo.replace("/", "--"))
    snap = os.path.join(root, "snapshots", "seeded")
    os.makedirs(snap, exist_ok=True)
    os.makedirs(os.path.join(root, "refs"), exist_ok=True)
    with open(os.path.join(root, "refs", "main"), "w") as f:
        f.write("seeded")
    shutil.copy(VOCAB, os.path.join(snap, "tokenizer.json"))
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": pad_token, "extra_ids": 0, "model_max_length": 64}, f)
    if state_dict is not None:
        import torch

        torch.save(state_dict, os.path.join(snap, "open_clip_pytorch_model.bin"))
    return snap


# the committed bert-base-uncased-style fast-tokenizer file (WordPiece, the
# BERT normalizer and pre-tokenizer; scripts/make_mini_bert_vocab.py)
BERT_VOCAB = os.path.join(os.path.dirname(__file__), "assets", "bert_vocab", "tokenizer.json")
BERT_TOKENIZER_CONFIG = {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                         "model_max_length": 512}


def seed_bert_snapshot(cache: str, repo: str = "bert-base-uncased") -> str:
    """The hub layout of ``bert-base-uncased`` under ``cache``: the committed
    test vocabulary as ``tokenizer.json`` and a BERT tokenizer config."""
    root = os.path.join(cache, "models--" + repo.replace("/", "--"))
    snap = os.path.join(root, "snapshots", "seeded")
    os.makedirs(snap, exist_ok=True)
    os.makedirs(os.path.join(root, "refs"), exist_ok=True)
    with open(os.path.join(root, "refs", "main"), "w") as f:
        f.write("seeded")
    shutil.copy(BERT_VOCAB, os.path.join(snap, "tokenizer.json"))
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump(BERT_TOKENIZER_CONFIG, f)
    return snap


def jax_drawn_clip(cfg_dict, seed: int = 0, noise: float = 0.05):
    """(flax CLIP, variables) with numpy-drawn fp32 params on the tree's
    shapes (``jax.eval_shape``: nothing is compiled for the init): norm
    scales 1 + N(0, noise), other vectors N(0, noise), token embeddings
    N(0, 0.02), matrices and kernels N(0, fan_in^-1/2), the logit scale at
    ln(1/0.07); a BatchNorm tower's ``batch_stats`` drawn too (means
    N(0, 0.1), variances U(0.5, 1.5)), so running statistics differ from
    their init."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model, parse_model_cfg,
    )

    cfg = parse_model_cfg(cfg_dict)
    model = build_model(cfg, attn_impl="xla")
    size = cfg.vision_cfg.image_size
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "logit_scale" in name:
            return np.asarray(np.log(1 / 0.07), np.float32)
        if "['mean']" in name:
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        if "['var']" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "token_embedding" in name:
            return rng.normal(0.0, 0.02, shape).astype(np.float32)
        std = noise if len(shape) < 2 else float(np.prod(shape[:-1])) ** -0.5
        x = rng.normal(0.0, std, shape).astype(np.float32)
        return x + 1.0 if name.endswith("['scale']") else x

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return model, variables
