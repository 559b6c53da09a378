"""The port's flash attention and its dispatch against the JAX package.

On the CPU the port's ``flash_mha`` runs its plain version; it is held
against the JAX ``flash_mha``, whose Pallas kernel runs interpreted off the
TPU, on the same numpy inputs. Tolerances: 2e-5 absolute and relative in
fp32 (summation order only, as ``tests/test_flash_attention.py``); 2e-2 in
bf16, compared in fp32 (one bf16 ulp of outputs near 1 is 7.8e-3, and the
kernel rounds P relative to a running max where the plain version uses the
row max); gradients at 1e-4. The ``cuda``-marked tests hold the Hopper kernel
against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.attention import (
    dot_product_attention_xla,
    multi_head_attention,
)
from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_compatible,
    flash_attention_fwd,
    flash_attention_reference,
    flash_mha,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention_fwd,
)

FP32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4


def _qkv(b=1, h=2, lq=77, lk=None, d=64, seed=0):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return [rng.normal(size=(b, h, l, d)).astype(np.float32) for l in (lq, lk, lk)]


def _jax_flash(q, k, v, causal=False, dtype=None):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.flash_attention import (
        flash_mha as jax_flash_mha,
    )

    dtype = dtype or jnp.float32
    out = jax_flash_mha(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("l", [50, 77, 197, 257, 577, 1030])
def test_flash_matches_jax_kernel(l):
    q, k, v = _qkv(b=2 if l < 1000 else 1, lq=l, seed=l)
    got = flash_mha(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, _jax_flash(q, k, v), atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("l", [77, 577])
def test_flash_causal_matches_jax_kernel(l):
    q, k, v = _qkv(lq=l, seed=10 + l)
    got = flash_mha(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    np.testing.assert_allclose(got, _jax_flash(q, k, v, causal=True), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_cross_lengths_match_jax_kernel(causal):
    """Lq != Lk; the causal rule is the kernel's key <= query index."""
    q, k, v = _qkv(lq=600, lk=1030, seed=7)
    got = flash_mha(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, _jax_flash(q, k, v, causal=causal), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("d,causal", [(64, True), (80, False)])
def test_flash_bf16_matches_jax_kernel(d, causal):
    """At d = 80 the scale 80**-0.5 is not exact in bf16: both round it
    before pre-scaling Q in bf16."""
    import jax.numpy as jnp

    q, k, v = _qkv(lq=577, d=d, seed=d)
    got = flash_mha(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_flash(q, k, v, causal, jnp.bfloat16),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax_grad(causal):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.flash_attention import (
        flash_mha as jax_flash_mha,
    )

    q, k, v = _qkv(lq=577, seed=30 + causal)
    gj = jax.grad(lambda *a: jnp.sum(jax_flash_mha(*a, causal=causal) ** 2),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_mha(*tq, causal=causal) ** 2).sum().backward()
    for t, g in zip(tq, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_gate_checks_shapes_only():
    """The JAX gate without its TPU check: mask None, d <= 256, Lq >= 512,
    no upper bound on the length."""
    cases = [((1, 1, 512, 64), None, True), ((1, 1, 511, 64), None, False),
             ((1, 1, 577, 256), None, True), ((1, 1, 577, 257), None, False),
             ((1, 1, 4097, 64), None, True), ((1, 1, 577, 64), (577, 577), False)]
    for shape, mask, want in cases:
        t = torch.zeros(shape)
        m = None if mask is None else torch.zeros(mask)
        assert flash_attention_compatible(t, t, t, m) == want, shape


def test_query_length_bound_follows_the_route():
    """The wrapper's bound on Lq is what the route that runs can take: the
    CUDA grid counts at most 65535 query tiles, of 64 rows in the
    tensor-core kernels (bf16, fp32 up to head dim 128) and of 32 in the
    scalar fp32 kernel past 128; the CUDA entry checks the same."""
    from pathlib import Path

    from refining_clip_via_dinov2_representations_torch.ops import flash_attention as fm

    assert fm.max_query_len(torch.bfloat16, 256) == fm.MAX_QUERY_LEN == 65535 * 64
    assert fm.max_query_len(torch.float32, 128) == 65535 * 64
    assert fm.max_query_len(torch.float32, 129) == fm.MAX_QUERY_LEN_SCALAR == 65535 * 32
    src = (Path(fm.__file__).resolve().parents[1] / "csrc" / "flash_attention_fwd.cu").read_text()
    assert "const long long rows = dtype == 0 && d > 128 ? kBQ : fa::kMmaRows;" in src
    assert "if (lq > 65535 * rows) return cudaErrorInvalidValue;" in src
    assert "constexpr int kBQ = (kThreads / 32) * kRowsPerWarp;  // 32 query rows" in src
    assert "if (d <= 128)\n    return fa::launch_fwd_tf32<128>(" in src


def test_flash_mha_refuses_a_mask():
    q, k, v = map(torch.from_numpy, _qkv(lq=8))
    with pytest.raises(ValueError, match="mask"):
        flash_mha(q, k, v, mask=torch.zeros(8, 8))


def test_overlong_fused_falls_to_flash_as_in_jax():
    """``impl="fused"`` past the fused gate (L > 1024) takes flash, as JAX
    ``ops/attention.py`` does; on CPU tensors its plain version, and no
    fused launch."""
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.attention import (
        multi_head_attention as jax_mha,
    )

    q, k, v = _qkv(lq=1100, seed=11)
    tq = list(map(torch.from_numpy, (q, k, v)))
    before = fused_attention_fwd.launches, flash_attention_fwd.launches
    got = multi_head_attention(*tq, impl="fused")
    assert (fused_attention_fwd.launches, flash_attention_fwd.launches) == before
    torch.testing.assert_close(got, flash_attention_reference(*tq, 64 ** -0.5), atol=0, rtol=0)
    want = np.asarray(jax_mha(*map(jnp.asarray, (q, k, v)), impl="fused"))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("l,flash", [(577, True), (100, False)])
def test_flash_dispatch_on_cpu(l, flash):
    tq = list(map(torch.from_numpy, _qkv(lq=l, seed=12)))
    for causal in (False, True):
        got = multi_head_attention(*tq, causal=causal, impl="flash")
        if flash:
            want = flash_attention_reference(*tq, 64 ** -0.5, causal)
        else:
            mask = torch.full((l, l), float("-inf")).triu(1) if causal else None
            want = dot_product_attention_xla(*tq, mask=mask)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_backward_is_the_plain_attention_vjp():
    """``_flash_bwd_rule``: the gradients are those of the plain attention."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(lq=520, seed=13))
    do = torch.from_numpy(_qkv(lq=520, seed=14)[0])
    got = torch.autograd.grad(flash_attention(q, k, v, 0.125, True), (q, k, v), do)
    mask = torch.full((520, 520), float("-inf")).triu(1)
    want = torch.autograd.grad(dot_product_attention_xla(q, k, v, mask=mask, scale=0.125),
                               (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _cuda_qkv(b, h, lq, lk, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, l, d, generator=g).to("cuda", dtype) for l in (lq, lk, lk)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,causal", [
    ((2, 16, 577, 577, 64), False), ((2, 12, 577, 577, 64), True), ((1, 2, 512, 512, 64), False),
    ((1, 2, 513, 513, 64), True), ((1, 1, 1370, 1370, 64), False),
    ((1, 1, 4097, 4097, 64), True), ((2, 4, 600, 1030, 64), False),
    ((1, 2, 577, 577, 80), False), ((1, 2, 577, 577, 40), True), ((1, 1, 600, 600, 256), False),
    ((1, 1, 1, 1, 64), False), ((1, 1, 33, 70, 64), True),
])
def test_cuda_kernel_matches_plain_version(shape, causal, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, lq, lk, d = shape
    q, k, v = _cuda_qkv(b, h, lq, lk, d, dtype)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_reference(q, k, v, d ** -0.5, causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_overlong_fused_launches_flash_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = _cuda_qkv(1, 2, 1100, 1100, 64, torch.float32)
    before = fused_attention_fwd.launches, flash_attention_fwd.launches
    got = multi_head_attention(q, k, v, impl="fused")
    torch.cuda.synchronize()
    assert fused_attention_fwd.launches == before[0]
    assert flash_attention_fwd.launches == before[1] + 1
    torch.testing.assert_close(got, flash_attention_reference(q, k, v, 0.125), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 2, 600, 64, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn(1, 2, 64, 600, device="cuda").transpose(2, 3)
        flash_attention_fwd(t, t, t, 0.125)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_fwd(q, q.cpu(), q, 0.125)
    wide = torch.randn(1, 1, 600, 320, device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        flash_attention_fwd(wide, wide, wide, 0.125)


@pytest.mark.cuda
def test_cuda_each_dtype_runs_its_tensor_core_kernel():
    """bf16 inputs reach the mma.sync kernel; fp32 inputs the split-TF32
    kernel up to head dim 128 and no scalar kernel, the scalar kernel at
    head dim 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    scalar = "flash_attention_fwd_kernel<float"
    for dtype, d, want, not_want in (
            (torch.bfloat16, 64, "flash_attention_fwd_mma_kernel", scalar),
            (torch.float32, 64, "flash_attention_fwd_tf32_kernel", scalar),
            (torch.float32, 128, "flash_attention_fwd_tf32_kernel", scalar),
            (torch.float32, 256, scalar, "flash_attention_fwd_tf32_kernel")):
        x = torch.randn(1, 2, 600, d, device="cuda").to(dtype)
        flash_attention_fwd(x, x, x, 0.125, True)  # the first launch loads the module
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_fwd(x, x, x, 0.125, True)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        assert any(want in n for n in names), (dtype, d, names)
        assert not any(not_want in n for n in names), (dtype, d, names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_every_head_dim(causal, dtype, tol):
    """Every head_dim the gate admits (1-256), Lq != Lk. bf16: d % 8 != 0
    takes element copies, d % 8 == 0 the 16-byte cp.async copies. fp32: up
    to 128 the split-TF32 kernel (element copies where d % 4 != 0), past it
    the scalar kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for d in range(1, 257):
        q, k, v = _cuda_qkv(1, 2, 130, 100, d, dtype, seed=d)
        got = flash_attention_fwd(q, k, v, d ** -0.5, causal)
        want = flash_attention_reference(q, k, v, d ** -0.5, causal)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                                   msg=lambda m: f"head_dim {d}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("lq,lk", [(1, 1), (1, 9), (577, 577)])
def test_cuda_unaligned_and_strided_inputs(lq, lk, dtype, tol):
    """Bases one element off a 16-byte boundary (element copies) and
    transposed views made contiguous give the plain version's result; L = 1
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(2)
    sizes = (2 * 3 * lq * 64, 2 * 3 * lk * 64, 2 * 3 * lk * 64)
    flat = torch.randn(sum(sizes) + 1, generator=g).to("cuda", dtype)
    q, k, v = (t.view(2, 3, -1, 64) for t in flat[1:].split(sizes))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    strided = [torch.randn(2, 3, 64, n, generator=g).to("cuda", dtype)
               .transpose(2, 3).contiguous() for n in (lq, lk, lk)]
    for causal in (False, True):
        for args in ((q, k, v), strided):
            got = flash_attention_fwd(*args, 0.125, causal)
            want = flash_attention_reference(*args, 0.125, causal)
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
