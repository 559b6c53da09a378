"""The port's fused attention and dispatch against the JAX package.

On the CPU the port's ``fused_attention`` runs its plain version; it is held
against the JAX ``fused_attention`` (the Pallas kernel, interpreted off-TPU)
and ``dot_product_attention_xla`` on the same numpy inputs. Tolerances:
2e-5 absolute in fp32 (summation order only); 1e-2 in bf16, compared in
fp32 (one bf16 ulp of outputs near 1 is 7.8e-3). The ``cuda``-marked tests
hold the Hopper kernels against the plain version on the card: 1e-4 in fp32
(the split-TF32 tensor-core kernel up to head dim 128, the scalar kernel
past it), 2e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops import native
from refining_clip_via_dinov2_representations_torch.ops.attention import (
    dot_product_attention_xla,
    multi_head_attention,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_compatible,
    fused_attention_fwd,
    fused_attention_reference,
)

FP32_TOL = 2e-5
BF16_TOL = 1e-2


def _qkv(b=2, h=3, lq=23, lk=23, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, l, d)).astype(np.float32) for l in (lq, lk, lk)]


def _causal_mask_np(l):
    return np.triu(np.full((l, l), -np.inf, np.float32), k=1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [23, 77, 197])
def test_plain_version_matches_jax_kernel_and_xla(causal, l):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.attention import (
        dot_product_attention_xla as jax_xla,
    )
    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention as jax_fused,
    )

    q, k, v = _qkv(lq=l, lk=l, seed=l)
    scale = q.shape[-1] ** -0.5
    got = fused_attention(*map(torch.from_numpy, (q, k, v)), scale, causal).numpy()
    want_kernel = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), scale, causal))
    mask = jnp.asarray(_causal_mask_np(l)) if causal else None
    want_xla = np.asarray(jax_xla(*map(jnp.asarray, (q, k, v)), mask=mask))
    np.testing.assert_allclose(got, want_kernel, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got, want_xla, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_bf16_matches_jax_kernel(causal):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention as jax_fused,
    )

    q, k, v = _qkv(b=2, h=4, lq=77, lk=77, d=64, seed=5)
    scale = 64 ** -0.5
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fused_attention(*tq, scale, causal)
    assert got.dtype == torch.bfloat16
    jq = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_fused(*jq, scale, causal).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def test_gate_matches_jax():
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention_compatible as jax_gate,
    )

    for shape, mask in [((1, 1, 197, 64), None), ((1, 1, 197, 64), (197, 197)),
                        ((1, 1, 1024, 256), None), ((1, 1, 1025, 64), None),
                        ((1, 1, 77, 257), None)]:
        t = torch.zeros(shape)
        j = jnp.zeros(shape)
        tm = None if mask is None else torch.zeros(mask)
        jm = None if mask is None else jnp.zeros(mask)
        assert fused_attention_compatible(t, t, t, tm) == jax_gate(j, j, j, jm), shape


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_dispatch_on_cpu_takes_plain_version(impl):
    q, k, v = map(torch.from_numpy, _qkv(lq=50, lk=50))
    before = fused_attention_fwd.launches
    for causal in (False, True):
        got = multi_head_attention(q, k, v, causal=causal, impl=impl)
        want = fused_attention_reference(q, k, v, q.shape[-1] ** -0.5, causal)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert fused_attention_fwd.launches == before  # no kernel on CPU tensors


@pytest.mark.parametrize("impl", ["xla", "flash", "xla_bf16_bwd"])
def test_plain_paths_match_jax_xla(impl):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.attention import (
        dot_product_attention_xla as jax_xla,
    )

    q, k, v = _qkv(lq=41, lk=41, seed=3)
    rng = np.random.default_rng(4)
    for mask in (None, rng.normal(size=(1, 3, 41, 41)).astype(np.float32)):
        tmask = None if mask is None else torch.from_numpy(mask)
        got = multi_head_attention(*map(torch.from_numpy, (q, k, v)), mask=tmask, impl=impl)
        jm = None if mask is None else jnp.asarray(mask)
        want = np.asarray(jax_xla(*map(jnp.asarray, (q, k, v)), mask=jm))
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)
    # causal through the plain path equals the fused plain version
    got = multi_head_attention(*map(torch.from_numpy, (q, k, v)), causal=True, impl=impl)
    want = np.asarray(jax_xla(*map(jnp.asarray, (q, k, v)),
                              mask=jnp.asarray(_causal_mask_np(41))))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)


def test_fused_with_mask_or_long_sequence_takes_plain_path():
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=1, lq=9, lk=9))
    mask = torch.randn(9, 9)
    got = multi_head_attention(q, k, v, mask=mask, impl="fused")
    torch.testing.assert_close(got, dot_product_attention_xla(q, k, v, mask=mask))


def test_unknown_impl_raises():
    q, k, v = map(torch.from_numpy, _qkv())
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="cudnn")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,causal", [
    ((8, 12, 197, 64), False), ((8, 8, 77, 64), True), ((8, 12, 50, 64), False),
    ((3, 5, 23, 64), True), ((1, 1, 1, 64), False), ((1, 2, 1024, 64), True),
    ((2, 3, 65, 40), True), ((1, 2, 300, 256), False),
])
def test_cuda_kernel_matches_plain_version(shape, causal, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(0)
    q, k, v = [torch.randn(shape, generator=g).to("cuda", dtype) for _ in range(3)]
    scale = shape[-1] ** -0.5
    before = fused_attention_fwd.launches
    got = fused_attention(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fused_attention_fwd.launches == before + 1
    want = fused_attention_reference(q, k, v, scale, causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(TypeError):
        fused_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        fused_attention(t, t, t, 0.125)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_attention(q, q.cpu(), q, 0.125)
    big = torch.randn(1, 1, 1025, 64, device="cuda")
    with pytest.raises(ValueError, match="exceed"):
        fused_attention(big, big, big, 0.125)


def _kernels_launched(fn) -> set:
    """Names of the CUDA kernels that ``fn`` launches, from torch.profiler.
    ``fn`` runs once before the profiled call: a kernel's first launch loads
    its module, and the profiler can miss the kernels of that launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.cuda
def test_cuda_bf16_runs_the_tensor_core_kernel():
    """bf16 inputs reach the bf16 mma.sync kernel; fp32 inputs up to head dim
    128 the split-TF32 mma.sync kernel, past it the scalar one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scalar, tf32 = "fused_attention_fwd_kernel<float", "fused_attention_fwd_tf32_kernel"
    for dtype, d, want, not_want in (
            (torch.bfloat16, 64, "fused_attention_fwd_mma_kernel", (scalar, tf32)),
            (torch.float32, 64, tf32, (scalar, "fused_attention_fwd_mma_kernel")),
            (torch.float32, 128, tf32, (scalar,)),
            (torch.float32, 256, scalar, (tf32,))):
        x = torch.randn(2, 3, 77, d, device="cuda").to(dtype)
        names = _kernels_launched(lambda: fused_attention_fwd(x, x, x, d ** -0.5, True))
        assert any(want in n for n in names), (dtype, d, names)
        assert not any(k in n for k in not_want for n in names), (dtype, d, names)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d", [(197, 197, 64), (70, 45, 64), (45, 130, 64), (197, 150, 80),
                                     (77, 120, 128), (300, 1024, 128), (1024, 300, 80),
                                     (1, 9, 64), (9, 1, 128)])
def test_cuda_fp32_tensor_core_route_matches_plain_version(lq, lk, d, causal):
    """fp32 on the split-TF32 kernel: Lq != Lk both ways, head dims 64, 80
    and 128, within the fp32 contract of the plain version and of float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(lq * 7 + lk + d)
    q = torch.randn(2, 3, lq, d, generator=g).cuda()
    k, v = (torch.randn(2, 3, lk, d, generator=g).cuda() for _ in range(2))
    got = fused_attention_fwd(q, k, v, d ** -0.5, causal)
    want = fused_attention_reference(q, k, v, d ** -0.5, causal)
    exact = fused_attention_reference(q.double(), k.double(), v.double(), d ** -0.5, causal)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.double(), exact, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_fp32_every_head_dim_and_unaligned_inputs():
    """Every head_dim the gate admits (1-256) in fp32: d % 4 != 0 takes
    element copies, d pads to 32/64/128 on the tensor-core kernel and the
    scalar kernel takes d > 128; bases 4 bytes off a 16-byte boundary too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    for d in range(1, 257):
        for causal in (False, True):
            q = torch.randn(1, 2, 70, d, generator=g).cuda()
            k, v = (torch.randn(1, 2, 45, d, generator=g).cuda() for _ in range(2))
            torch.testing.assert_close(fused_attention_fwd(q, k, v, d ** -0.5, causal),
                                       fused_attention_reference(q, k, v, d ** -0.5, causal),
                                       atol=1e-4, rtol=0, msg=lambda m: f"head_dim {d}: {m}")
    n = 2 * 3 * 70 * 64
    flat = torch.randn(3 * n + 1, generator=g).cuda()
    q, k, v = (t.view(2, 3, 70, 64) for t in flat[1:].split(n))
    assert q.data_ptr() % 16 != 0
    torch.testing.assert_close(fused_attention_fwd(q, k, v, 0.125, True),
                               fused_attention_reference(q, k, v, 0.125, True), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_fp32_kernel_ignores_the_tf32_switch():
    """The split-TF32 kernel keeps fp32 accuracy whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (the reference is taken
    with it off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(8, 12, 197, 64, generator=g).cuda() for _ in range(3))
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = fused_attention_reference(q, k, v, 0.125)
        outs = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            outs.append(fused_attention_fwd(q, k, v, 0.125))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_bf16_every_head_dim(causal):
    """Every head_dim the gate admits (1-256): d % 8 != 0 takes element
    copies, d % 8 == 0 the 16-byte cp.async copies; d pads to 32/64/128/256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(1)
    for d in range(1, 257):
        q = torch.randn(1, 2, 70, d, generator=g).to("cuda", torch.bfloat16)
        k, v = (torch.randn(1, 2, 45, d, generator=g).to("cuda", torch.bfloat16)
                for _ in range(2))
        got = fused_attention_fwd(q, k, v, d ** -0.5, causal)
        want = fused_attention_reference(q, k, v, d ** -0.5, causal)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0,
                                   msg=lambda m: f"head_dim {d}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(1, 1), (1, 9), (70, 70)])
def test_cuda_bf16_unaligned_and_strided_inputs(lq, lk):
    """Bases 2 bytes off a 16-byte boundary (element copies) and transposed
    views made contiguous give the plain version's result; L = 1 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(2)
    sizes = (2 * 3 * lq * 64, 2 * 3 * lk * 64, 2 * 3 * lk * 64)
    flat = torch.randn(sum(sizes) + 1, generator=g).to("cuda", torch.bfloat16)
    q, k, v = (t.view(2, 3, -1, 64) for t in flat[1:].split(sizes))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    strided = [torch.randn(2, 3, 64, n, generator=g).to("cuda", torch.bfloat16)
               .transpose(2, 3).contiguous() for n in (lq, lk, lk)]
    for causal in (False, True):
        for args in ((q, k, v), strided):
            got = fused_attention_fwd(*args, 0.125, causal)
            want = fused_attention_reference(*args, 0.125, causal)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
