"""The port's fused attention backward against the JAX package.

On the CPU the port's backward runs its plain version
(``fused_attention_bwd_reference``); it is held against ``jax.vjp`` of the
JAX ``fused_attention``, whose backward is the Pallas ``_bwd_kernel``
interpreted off-TPU, on the same numpy inputs and cotangent. Tolerances:
3e-5 absolute and relative in fp32, as the JAX package's own gradient test
(summation order only); in bf16, 2e-2 of the largest |grad| of the three compared
in fp32 (a few output ulps: one bf16 ulp is 2^-8 of a value, and the rounded
dS can flip by one ulp where P or dP differ in their last fp32 bits). The
``cuda``-marked tests hold the Hopper kernels against the plain version on
the card: in fp32 within 1e-4 of the largest |grad| (split-TF32 tensor-core
kernels up to head dim 128, scalar past it), in bf16 within 2e-2.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.attention import (
    multi_head_attention,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_fwd,
    fused_attention_reference,
)

FP32_TOL = 3e-5
BF16_REL_TOL = 2e-2


def _inputs(b=2, h=3, l=23, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4)]


def _jax_vjp(q, k, v, do, scale, causal, dtype=None):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention as jax_fused,
    )

    dtype = dtype or jnp.float32
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda q_, k_, v_: jax_fused(q_, k_, v_, scale, causal), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [23, 77, 197])
def test_plain_backward_matches_jax_vjp(l, causal):
    q, k, v, do = _inputs(l=l, seed=l)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fused_attention_reference(tq, tk, tv, scale, causal)
    got = fused_attention_bwd_reference(tq, tk, tv, o, tdo, scale, causal)
    want = _jax_vjp(q, k, v, do, scale, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_TOL, rtol=FP32_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_bf16_matches_jax_vjp(causal):
    import jax.numpy as jnp

    q, k, v, do = _inputs(b=2, h=4, l=77, d=64, seed=7)
    scale = 64 ** -0.5
    tq, tk, tv, tdo = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    o = fused_attention_reference(tq, tk, tv, scale, causal)
    got = fused_attention_bwd_reference(tq, tk, tv, o, tdo, scale, causal)
    want = _jax_vjp(q, k, v, do, scale, causal, dtype=jnp.bfloat16)
    largest = max(np.abs(w).max() for w in want)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max()
        assert err <= BF16_REL_TOL * largest, (name, err, largest)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["fused", "auto", "xla"])
def test_autograd_through_dispatch_matches_jax_vjp(impl, causal):
    """``torch.autograd.grad`` through ``multi_head_attention`` on CPU
    tensors ("fused": the autograd Function with the plain versions; "auto"
    and "xla": the plain path differentiated by autograd)."""
    q, k, v, do = _inputs(l=41, seed=11)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = multi_head_attention(tq, tk, tv, causal=causal, impl=impl)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want = _jax_vjp(q, k, v, do, scale, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_TOL, rtol=FP32_TOL,
                                   err_msg=f"{impl} d{name}")


def test_function_takes_strided_cotangent_and_counts_no_cpu_launches():
    """The Function makes the cotangent contiguous (the attention layer's
    transpose + reshape hands back a strided view) and launches no kernel on
    CPU tensors."""
    q, k, v, do = map(torch.from_numpy, _inputs(l=9, seed=3))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fused_attention_fwd.launches, fused_attention_bwd.launches)
    out = fused_attention(q, k, v, 0.25, True)
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(out, (q, k, v), strided)
    want = fused_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         out.detach(), do, 0.25, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert (fused_attention_fwd.launches, fused_attention_bwd.launches) == before


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _bwd_error(q, k, v, do, causal):
    """max |kernel - plain| over the three gradients, and the largest |grad|
    of the three (the tolerance is relative to it: at L = 1, dq and dk are
    rounding noise around 0)."""
    scale = q.shape[-1] ** -0.5
    o = fused_attention_fwd(q, k, v, scale, causal)
    got = fused_attention_bwd(q, k, v, o, do, scale, causal)
    want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert g_.dtype == q.dtype and g_.shape == w.shape
    err = max((g_.float() - w.float()).abs().max().item() for g_, w in zip(got, want))
    return err, max(w.float().abs().max().item() for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-4), (torch.bfloat16, BF16_REL_TOL)])
@pytest.mark.parametrize("shape,lk,causal", [
    ((8, 12, 197, 64), None, False), ((8, 8, 77, 64), None, True), ((3, 5, 23, 64), None, True),
    ((1, 1, 1, 64), None, False), ((1, 1, 1, 64), None, True), ((1, 2, 1024, 64), None, True),
    ((2, 3, 1024, 64), None, False), ((2, 3, 65, 40), None, True), ((1, 2, 300, 256), None, False),
    # Lq != Lk: keys past Lq get zero gradients when causal (col > row)
    *(((2, 3, lq, 64), lk, causal) for lq, lk in ((70, 45), (45, 130), (1, 9), (9, 1),
                                                  (1024, 300), (300, 1024))
      for causal in (False, True)),
])
def test_cuda_backward_kernel_matches_plain_version(shape, lk, causal, dtype, rel_tol):
    """shape is q's [B,H,Lq,D]; k and v have lk keys (None: Lq)."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    b, h, lq, d = shape
    q, k, v, do = [torch.randn(n, generator=g).to("cuda", dtype)
                   for n in (shape, (b, h, lk or lq, d), (b, h, lk or lq, d), shape)]
    before = fused_attention_bwd.launches
    err, largest = _bwd_error(q, k, v, do, causal)
    assert fused_attention_bwd.launches == before + 1
    assert err <= rel_tol * largest, (err, largest)


@pytest.mark.cuda
def test_cuda_autograd_function_matches_autograd_of_plain_version():
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    for shape, causal in (((4, 12, 197, 64), False), ((4, 8, 77, 64), True)):
        q, k, v, do = [torch.randn(shape, generator=g).to("cuda") for _ in range(4)]
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = fused_attention_bwd.launches
        got = torch.autograd.grad(fused_attention(q, k, v, 0.125, causal), (q, k, v), do)
        torch.cuda.synchronize()
        assert fused_attention_bwd.launches == before + 1
        want = torch.autograd.grad(fused_attention_reference(q, k, v, 0.125, causal),
                                   (q, k, v), do)
        largest = max(w.abs().max().item() for w in want)
        for g_, w in zip(got, want):
            assert (g_ - w).abs().max().item() <= 1e-4 * largest


@pytest.mark.cuda
def test_cuda_backward_wrapper_rejects_bad_inputs():
    _needs_cuda()
    q = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(TypeError):
        fused_attention_bwd(q, q, q, q, q.bfloat16(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_bwd(q, q, q, q, q.transpose(2, 3).contiguous().transpose(2, 3), 0.125)
    with pytest.raises(ValueError, match="shape"):
        fused_attention_bwd(q, q, q, q[:, :, :8].contiguous(), q, 0.125)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_attention_bwd(q, q, q, q, q.cpu(), 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_bf16_backward_every_head_dim(causal):
    """Every head_dim the gate admits (1-256) in bf16: up to 128 the
    tensor-core kernels (d % 8 != 0 takes element copies; d pads to 32, 64 or
    128), past it the scalar kernels."""
    _needs_cuda()
    g = torch.Generator().manual_seed(1)
    for d in range(1, 257):
        q, do = (torch.randn(1, 2, 70, d, generator=g).to("cuda", torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(1, 2, 45, d, generator=g).to("cuda", torch.bfloat16) for _ in range(2))
        err, largest = _bwd_error(q, k, v, do, causal)
        assert err <= BF16_REL_TOL * largest, (d, err, largest)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(1, 1), (1, 9), (70, 70)])
def test_cuda_bf16_backward_unaligned_and_strided_inputs(lq, lk):
    """Bases 2 bytes off a 16-byte boundary (element copies) and transposed
    views made contiguous give the plain version's gradients."""
    _needs_cuda()
    g = torch.Generator().manual_seed(2)
    sizes = (2 * 3 * lq * 64, 2 * 3 * lk * 64, 2 * 3 * lk * 64, 2 * 3 * lq * 64)
    flat = torch.randn(sum(sizes) + 1, generator=g).to("cuda", torch.bfloat16)
    unaligned = [t.view(2, 3, -1, 64) for t in flat[1:].split(sizes)]
    assert unaligned[0].data_ptr() % 16 != 0 and unaligned[0].is_contiguous()
    strided = [torch.randn(2, 3, 64, n, generator=g).to("cuda", torch.bfloat16)
               .transpose(2, 3).contiguous() for n in (lq, lk, lk, lq)]
    for causal in (False, True):
        for q, k, v, do in (unaligned, strided):
            err, largest = _bwd_error(q, k, v, do, causal)
            assert err <= BF16_REL_TOL * largest, (causal, err, largest)


def _kernels_launched(fn) -> set:
    """Names of the CUDA kernels that ``fn`` launches, from torch.profiler.
    ``fn`` runs once before the profiled call: a kernel's first launch loads
    its module, and the profiler can miss the kernels of that launch. The
    profiler at times records a window's runtime calls but none of its
    kernels (seen on an H100); such a window is profiled again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        if any("_kernel" in n for n in names):
            break
    return names


@pytest.mark.cuda
def test_cuda_backward_routes_by_dtype_and_head_dim():
    """Up to head dim 128 bf16 runs the two bf16 tensor-core kernels and fp32
    the two split-TF32 tensor-core kernels; past it both dtypes run the two
    scalar kernels."""
    _needs_cuda()
    mma = ("fused_attention_bwd_dq_mma_kernel", "fused_attention_bwd_dkdv_mma_kernel")
    tf32 = ("fused_attention_bwd_dq_tf32_kernel", "fused_attention_bwd_dkdv_tf32_kernel")
    scalar = ("fused_attention_bwd_dq_kernel<", "fused_attention_bwd_dkdv_kernel<")
    for dtype, d, want, not_want in ((torch.bfloat16, 64, mma, scalar + tf32),
                                     (torch.float32, 64, tf32, scalar + mma),
                                     (torch.float32, 128, tf32, scalar + mma),
                                     (torch.bfloat16, 256, scalar, mma + tf32),
                                     (torch.float32, 256, scalar, mma + tf32)):
        x = torch.randn(2, 3, 77, d, device="cuda").to(dtype)
        o = fused_attention_fwd(x, x, x, d ** -0.5, True)
        names = _kernels_launched(lambda: fused_attention_bwd(x, x, x, o, x, d ** -0.5, True))
        for kernel in want:
            assert any(kernel in n for n in names), (dtype, d, kernel, names)
        for kernel in not_want:
            assert not any(kernel in n for n in names), (dtype, d, kernel, names)


@pytest.mark.cuda
def test_cuda_fp32_backward_every_head_dim_and_unaligned_inputs():
    """Every head_dim the gate admits (1-256) in fp32: up to 128 the
    split-TF32 kernels (d % 4 != 0 takes element copies; d pads to 32, 64 or
    128), past it the scalar kernels; bases 4 bytes off a 16-byte boundary."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    for d in range(1, 257):
        for causal in (False, True):
            q, do = (torch.randn(1, 2, 70, d, generator=g).cuda() for _ in range(2))
            k, v = (torch.randn(1, 2, 45, d, generator=g).cuda() for _ in range(2))
            err, largest = _bwd_error(q, k, v, do, causal)
            assert err <= 1e-4 * largest, (d, causal, err, largest)
    sizes = (2 * 3 * 70 * 64,) * 4
    flat = torch.randn(sum(sizes) + 1, generator=g).cuda()
    q, k, v, do = (t.view(2, 3, 70, 64) for t in flat[1:].split(sizes))
    assert q.data_ptr() % 16 != 0
    for causal in (False, True):
        err, largest = _bwd_error(q, k, v, do, causal)
        assert err <= 1e-4 * largest, (causal, err, largest)


@pytest.mark.cuda
def test_cuda_fp32_backward_ignores_the_tf32_switch():
    """The split-TF32 backward gives the same gradients whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says."""
    _needs_cuda()
    g = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(4, 12, 197, 64, generator=g).cuda() for _ in range(4))
    o = fused_attention_fwd(q, k, v, 0.125)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        grads = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            grads.append(fused_attention_bwd(q, k, v, o, do, 0.125))
        want = fused_attention_bwd_reference(q, k, v, o, do, 0.125)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    largest = max(w.abs().max().item() for w in want)
    for a, b_, w in zip(*grads, want):
        assert torch.equal(a, b_)
        assert (a - w).abs().max().item() <= 1e-4 * largest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,rel_tol", [(torch.float32, 1e-4, 1e-4),
                                                    (torch.bfloat16, 2e-2, BF16_REL_TOL)])
@pytest.mark.parametrize("shape,causal", [((16, 16, 257, 88), False), ((16, 16, 77, 64), True)])
def test_cuda_vit_g14_shapes_match_plain_version(shape, causal, dtype, fwd_tol, rel_tol):
    """ViT-g-14's attention calls at batch 16: vision heads of 88 (the
    head-dim-128 instantiations with the tail zero-padded) and the causal
    text call; forward (absolute tolerance) and backward (of the largest
    |grad|) against the plain versions."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    q, k, v, do = [torch.randn(shape, generator=g).to("cuda", dtype) for _ in range(4)]
    scale = shape[-1] ** -0.5
    got = fused_attention_fwd(q, k, v, scale, causal)
    want = fused_attention_reference(q, k, v, scale, causal)
    assert (got.float() - want.float()).abs().max().item() <= fwd_tol
    err, largest = _bwd_error(q, k, v, do, causal)
    assert err <= rel_tol * largest, (err, largest)
