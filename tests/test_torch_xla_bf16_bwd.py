"""``impl="xla_bf16_bwd"``: the plain forward with the JAX package's custom
backward (``tpu/ops/attention.py:64-118``), against
``dot_product_attention_bf16_bwd`` on the same seeded numpy inputs.

* bf16: output, dq, dk, dv and the learned mask's cotangent, each within
  2e-2 of its largest |value| (a few bf16 ulps: XLA on the CPU and torch
  round the bf16 products' fp32 sums at the same points, but not always to
  the same last bit);
* fp32: the same function at 1e-5 of the largest |value| (summation order
  only);
* a mask of each broadcast shape: full ``[B,H,L,L]``, ``[1,H,L,L]``,
  ``[B,1,L,L]``, ``[L,L]``, a key-padding row ``[B,1,1,L]`` and none; the
  causal mask the dispatcher builds.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.attention import (
    dot_product_attention_bf16_bwd,
    multi_head_attention,
)

B, H, L, D = 2, 3, 19, 16
MASK_SHAPES = [None, (B, H, L, L), (1, H, L, L), (B, 1, L, L), (L, L), (B, 1, 1, L)]
TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def _inputs(mask_shape, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, D)).astype(np.float32) for _ in range(4))
    mask = None if mask_shape is None else rng.normal(size=mask_shape).astype(np.float32)
    return q, k, v, do, mask


def _jax(q, k, v, do, mask, dtype_name, causal=False):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.attention import (
        dot_product_attention_bf16_bwd as jax_fn,
        multi_head_attention as jax_mha,
    )

    dt = jnp.dtype(dtype_name)
    qkv = [jnp.asarray(x, dt) for x in (q, k, v)]
    if causal:
        out, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, causal=True, impl="xla_bf16_bwd"),
                           *qkv)
        grads = vjp(jnp.asarray(do, dt)) + (None,)
    elif mask is None:
        out, vjp = jax.vjp(lambda a, b, c: jax_fn(a, b, c), *qkv)
        grads = vjp(jnp.asarray(do, dt)) + (None,)
    else:
        out, vjp = jax.vjp(jax_fn, *qkv, jnp.asarray(mask))
        grads = vjp(jnp.asarray(do, dt))
    as_np = lambda x: None if x is None else np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return as_np(out), [as_np(g) for g in grads]


def _port(q, k, v, do, mask, dtype, causal=False):
    qkv = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask).requires_grad_()
    if causal:
        out = multi_head_attention(*qkv, causal=True, impl="xla_bf16_bwd")
    else:
        out = dot_product_attention_bf16_bwd(*qkv, mask=tmask)
    out.backward(torch.from_numpy(do).to(dtype))
    grads = [t.grad for t in qkv] + [None if tmask is None else tmask.grad]
    as_np = lambda x: None if x is None else x.detach().float().numpy()  # noqa: E731
    return out, as_np(out), [as_np(g) for g in grads]


def _close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("mask_shape", MASK_SHAPES, ids=lambda s: "none" if s is None
                         else "x".join(map(str, s)))
def test_matches_the_jax_custom_vjp(mask_shape, dtype_name):
    q, k, v, do, mask = _inputs(mask_shape)
    out_t, out, grads = _port(q, k, v, do, mask, getattr(torch, dtype_name))
    want_out, want_grads = _jax(q, k, v, do, mask, dtype_name)
    # the backward is the custom rule, not autograd through the plain forward
    assert type(out_t.grad_fn).__name__ == "_AttentionBf16BwdBackward"
    assert out_t.dtype == getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    _close(out, want_out, tol, "out")
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), grads, want_grads):
        if w is None:
            assert g is None, name
            continue
        _close(g, w, tol, name)
    if mask is not None:
        assert grads[3].shape == mask.shape


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_causal_dispatch_matches_jax(dtype_name):
    q, k, v, do, _ = _inputs(None, seed=1)
    _, out, grads = _port(q, k, v, do, None, getattr(torch, dtype_name), causal=True)
    want_out, want_grads = _jax(q, k, v, do, None, dtype_name, causal=True)
    _close(out, want_out, TOL[dtype_name], "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        _close(g, w, TOL[dtype_name], name)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_runs_on_the_card_with_the_cpu_rule():
    """The same Function on CUDA tensors: the card's bf16 result against the
    CPU's at the bf16 tolerance."""
    q, k, v, do, mask = _inputs((1, H, L, L), seed=2)
    _, out, grads = _port(q, k, v, do, mask, torch.bfloat16)
    qkv = [torch.from_numpy(x).cuda().bfloat16().requires_grad_() for x in (q, k, v)]
    tmask = torch.from_numpy(mask).cuda().requires_grad_()
    got = multi_head_attention(*qkv, mask=tmask, impl="xla_bf16_bwd")
    got.backward(torch.from_numpy(do).cuda().bfloat16())
    _close(got.detach().float().cpu().numpy(), out, TOL["bfloat16"], "out")
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), [t.grad for t in qkv] + [tmask.grad],
                          grads):
        _close(g.float().cpu().numpy(), w, TOL["bfloat16"], name)
