"""The attention kernels as ``torch.library`` custom ops (``ops/``):
``torch.ops.rcd_torch.fused_attention_fwd``, ``fused_attention_bwd`` and
``flash_attention_fwd``, whose implementations are the kernel wrappers.

On the CPU each op runs its plain version. ``torch.library.opcheck`` holds
each op's schema, fake implementation (shapes and dtypes under fake tensors
and ``aot_autograd``) and autograd registration against the real one. The
forward ops' registered gradients are held against the plain backward the
formula names: the fused op's against ``fused_attention_bwd_reference``
(exactly: the formula calls that function on the CPU), the flash op's
against autograd through plain attention (the JAX ``_flash_bwd_rule``).
``torch.export`` of a tower keeps the op in its graph. Calling an op
imports no ``torch._dynamo`` (a fresh interpreter).

The ``cuda``-marked tests skip without a card. There the ops' CUDA
implementations equal their plain versions at the kernels' tolerances
(fp32 1e-4, bf16 2e-2, as ``tests/test_torch_fused_attention.py``), and a
reloaded exported tower launches the fused and the flash kernel once a
layer. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.attention import (
    dot_product_attention_xla,
)
from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
    flash_attention_fwd, flash_attention_reference,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention_bwd_reference, fused_attention_fwd, fused_attention_reference,
)

# the forward ops (each counts its kernel's launches), by name
OPS = {"fused_attention_fwd": fused_attention_fwd, "flash_attention_fwd": flash_attention_fwd}


def _op(name):
    return getattr(torch.ops.rcd_torch, name).default


TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 64, "layers": 2,
                   "head_width": 32},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 64, "heads": 4,
                 "layers": 2},
}


def _qkv(b, h, lq, lk, d, seed, grad=False, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(
        device, dtype).requires_grad_(grad) for n in (lq, lk, lk)]


def test_the_ops_are_registered_under_the_port_namespace():
    for name in ("fused_attention_fwd", "fused_attention_bwd", "flash_attention_fwd"):
        op = _op(name)
        assert str(op._schema).startswith(f"rcd_torch::{name}(Tensor q, Tensor k, Tensor v")
        assert "float scale, bool causal=False" in str(op._schema)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck_forward_ops(name, causal):
    q, k, v = _qkv(2, 3, 9, 9, 8, seed=1, grad=True)
    torch.library.opcheck(_op(name), (q, k, v, 0.3, causal))
    q, k, v = _qkv(1, 2, 5, 7, 16, seed=2)  # Lq != Lk, no grad
    torch.library.opcheck(_op(name), (q, k, v, 0.25, False))


@pytest.mark.parametrize("causal", [False, True])
def test_opcheck_backward_op(causal):
    q, k, v = _qkv(2, 3, 9, 9, 8, seed=3)
    o = fused_attention_reference(q, k, v, 0.3, causal)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=o.shape).astype(np.float32))
    torch.library.opcheck(_op("fused_attention_bwd"), (q, k, v, o, do, 0.3, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_fused_op_gradients_are_the_plain_backward(causal):
    q, k, v = _qkv(2, 3, 11, 11, 16, seed=5, grad=True)
    do = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))
    o = _op("fused_attention_fwd")(q, k, v, 0.25, causal)
    # a strided cotangent, as MultiheadAttention's transpose hands back
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(o, (q, k, v), strided)
    want = fused_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                         0.25, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_gradients_recompute_plain_attention(causal):
    q, k, v = _qkv(1, 2, 13, 13, 8, seed=7, grad=True)
    do = torch.from_numpy(np.random.default_rng(8).normal(size=q.shape).astype(np.float32))
    got = torch.autograd.grad(_op("flash_attention_fwd")(q, k, v, 0.35, causal), (q, k, v), do)
    mask = torch.full((13, 13), float("-inf")).triu(1) if causal else None
    want = torch.autograd.grad(dot_product_attention_xla(q, k, v, mask=mask, scale=0.35),
                               (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl,op", [("fused", "fused_attention_fwd"),
                                     ("flash", "flash_attention_fwd")])
def test_export_keeps_the_op_in_the_graph(impl, op):
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )

    cfg = dict(TINY, vision_cfg=dict(TINY["vision_cfg"], image_size=184))  # 530 tokens
    model = build_model(parse_model_cfg(cfg), attn_impl=impl, seed=0).eval()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 3, 184, 184)).astype(
        np.float32))
    with torch.no_grad():
        exported = torch.export.export(model.visual, (x,), strict=False)
        targets = [n.target for n in exported.graph.nodes if n.op == "call_function"]
        assert targets.count(_op(op)) == 2
        torch.testing.assert_close(exported.module()(x), model.visual(x), atol=0, rtol=0)


def test_calling_the_ops_imports_no_dynamo():
    import os
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from refining_clip_via_dinov2_representations_torch.ops.attention import "
            "multi_head_attention\n"
            "q = torch.randn(1, 2, 520, 8, requires_grad=True)\n"
            "for impl in ('fused', 'flash'):\n"
            "    multi_head_attention(q, q, q, causal=True, impl=impl).sum().backward()\n"
            "print('DYNAMO', 'torch._dynamo' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DYNAMO False" in proc.stdout


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_ops_match_their_plain_versions(dtype, tol):
    _cuda()
    for name, shape, plain in (("fused_attention_fwd", (2, 3, 77, 77, 64),
                                fused_attention_reference),
                               ("flash_attention_fwd", (1, 2, 600, 600, 64),
                                flash_attention_reference)):
        q, k, v = _qkv(*shape, seed=10, device="cuda", dtype=dtype)
        op = _op(name)
        before = OPS[name].launches
        got = op(q, k, v, 0.125, True)
        torch.cuda.synchronize()
        assert OPS[name].launches == before + 1
        torch.testing.assert_close(got.float(), plain(q, k, v, 0.125, True).float(), atol=tol,
                                   rtol=0)
    q, k, v = _qkv(2, 3, 77, 77, 64, seed=11, device="cuda", dtype=dtype)
    o = fused_attention_reference(q, k, v, 0.125, True)
    do = torch.randn_like(o)
    got = _op("fused_attention_bwd")(q, k, v, o, do, 0.125, True)
    want = fused_attention_bwd_reference(q, k, v, o, do, 0.125, True)
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,size,counter", [("fused", 16, "fused_attention_fwd"),
                                               ("flash", 184, "flash_attention_fwd")])
def test_cuda_reloaded_program_launches_the_kernel(tmp_path, impl, size, counter):
    _cuda()
    from refining_clip_via_dinov2_representations_torch.inference import (
        ClipInferenceEngine, load_exported,
    )
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )

    cfg = dict(TINY, vision_cfg=dict(TINY["vision_cfg"], image_size=size))
    model = build_model(parse_model_cfg(cfg), attn_impl=impl, seed=0).cuda()
    engine = ClipInferenceEngine(model, (size, size), 12, buckets=(2,))
    run = load_exported(engine.export(str(tmp_path))["encode_image_b2"])
    x = np.random.default_rng(12).normal(size=(2, size, size, 3)).astype(np.float32)
    before = OPS[counter].launches
    got = run(x)
    torch.cuda.synchronize()
    assert OPS[counter].launches == before + 2  # one a layer
    np.testing.assert_allclose(got.cpu().numpy(), engine.encode_image(x), atol=1e-5, rtol=0)
