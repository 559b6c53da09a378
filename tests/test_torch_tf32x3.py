"""Models of the fp32 tensor-core (split-TF32) schedules of the fused kernels.

The fp32 route of ``csrc/fused_attention_fwd.cu`` and
``csrc/fused_attention_bwd.cu`` forms every product on mma.sync m16n8k8 in
TF32 with each fp32 operand split as x = hi + lo (``csrc/attention_tf32.cuh``).
The CUDA kernels do not run on the CPU, so their arithmetic is modelled here
in PyTorch, step for step:

* ``tf32_round``: ``cvt.rna.tf32.f32``, nearest with ties away from zero, to
  10 mantissa bits (the value stays in an fp32 container).
* ``mm_3xtf32``: a product in 8-deep k-steps, each accumulating
  a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32; ``mm_tf32`` the single TF32
  product, for the counter-test.
* ``pv_permuted``: the products that take an accumulator as their A operand
  read its columns (and the B operand's rows) in the permuted k order
  ``PERM`` of each k-step; ``mma_from_lanes`` holds that mapping lane by lane.
* ``fused_fwd_tf32``: the one-pass forward (64-row blocks, 32-key tiles, an
  online softmax in base 2 on the scores times scale * log2(e), the division
  after P V): in fp32 the TPU kernel's cast of P to V's dtype is the
  identity, so dividing after the product computes the same function up to
  fp32 rounding.
* ``flash_fwd_tf32``: the flash kernel's fp32 route, the same body with Q
  pre-scaled in fp32 before it is split, the pre-scaled scores times
  log2(e), keys masked (and m started) at -1e30, O = acc / max(l, 1e-30).
* ``fused_bwd_tf32``: the dQ kernel's statistics pass (the forward's tiles
  and arithmetic), p = 2^(s - m) / l as 2^(s - m) (1 / l), dS = P (dP -
  delta) and dS K per 16-key chunk; the dK/dV kernel's walk over 16-query
  chunks with those statistics (m in base-2 units and 1 / l).

Each model is held against the JAX package's Pallas kernels, interpreted on
the CPU, in fp32 on seeded numpy inputs: ``_fwd_kernel`` and
``_flash_fwd_kernel`` (through the JAX ``flash_mha``) within ``FWD_TOL``
absolute and ``jax.vjp`` of ``_fused_bwd`` within ``BWD_REL_TOL`` of the
largest |grad|, both ten times inside the kernels' fp32 contract (1e-4, and
1e-4 of the largest |grad|: ``chip_smoke.TOL``, ``BWD_REL_TOL``). The
counter-test shows why the split exists: one TF32 product misses the 1e-4
contract where the split meets it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention_bwd_reference,
    fused_attention_reference,
)
from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
    flash_attention_reference,
)
from tests.test_torch_attention_schedule import FLASH_SHAPES, _blocks
from tests.test_torch_flash_attention import _jax_flash

CSRC = (Path(__file__).resolve().parents[1] / "refining_clip_via_dinov2_representations_torch"
        / "csrc")
ROWS = 64  # query rows (forward, dQ) or keys (dK/dV) per block: 4 warps x m16
TILE = 32  # keys per K/V tile of the fp32 kernels
CHUNK = 16  # keys (dQ) or queries (dK/dV) per product step of the backward
KSTEP = 8  # the k of mma.sync m16n8k8
# slot s of a permuted k-step holds key 2s (s < 4) or 2(s - 4) + 1
PERM = [0, 2, 4, 6, 1, 3, 5, 7]
LOG2E = np.float32(1.4426950408889634)  # the kernels' kLog2e
FLASH_MASKED = -1e30  # the flash kernel's mask value and m's start, as the TPU kernel's NEG_INF
CONTRACT = 1e-4  # the fp32 kernels' tolerance on the card
FWD_TOL = 1e-5  # absolute, model vs the interpreted _fwd_kernel
BWD_REL_TOL = 1e-5  # of the largest |grad|, model vs jax.vjp of _fused_bwd


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, nearest with
    ties away from zero (fp32 in, fp32 out). On the sign-magnitude bit
    pattern, adding half of the 13 dropped bits' range raises the magnitude
    whatever the sign; clearing them truncates."""
    bits = x.detach().to(torch.float32).contiguous().numpy().view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(out.copy())


def split_tf32(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as the kernels form it: 8-deep k-steps,
    each adding a_lo b_hi, a_hi b_lo and a_hi b_hi to an fp32 sum."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], KSTEP):
        ks = slice(k0, k0 + KSTEP)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = acc + torch.matmul(x[..., ks], y[..., ks, :])
    return acc


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product with one TF32 term: what plain TF32 would give."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], KSTEP):
        acc = acc + torch.matmul(a_hi[..., k0:k0 + KSTEP], b_hi[..., k0:k0 + KSTEP, :])
    return acc


def pv_permuted(p: torch.Tensor, y: torch.Tensor, mm=mm_3xtf32) -> torch.Tensor:
    """p [..., M, n] @ y [..., n, N] with p an accumulator tile: each 8-deep
    k-step takes p's columns and y's rows in the order ``PERM`` (zero past n)."""
    n = p.shape[-1]
    pad = -n % KSTEP
    p = torch.nn.functional.pad(p, (0, pad))
    y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    order = torch.tensor([k0 + s for k0 in range(0, n + pad, KSTEP) for s in PERM])
    return mm(p[..., order], y[..., order, :])


def _scale2(scale: float) -> float:
    """scale * log2(e), rounded to fp32 as the kernels form it."""
    return float(np.float32(scale) * LOG2E)


def _masked_scores(qb, kt, q0, j0, scale2, causal, mm, masked=float("-inf")):
    """One tile of S = Q K^T * scale2 (scale * log2(e), or log2(e) where Q
    is pre-scaled), keys past a query's index ``masked`` when causal (keys
    past Lk are not in the slice)."""
    s = mm(qb, kt.transpose(-1, -2)) * scale2
    if causal:
        rows = torch.arange(q0, q0 + qb.shape[-2])[:, None]
        keys = torch.arange(j0, j0 + kt.shape[-2])[None, :]
        s = s.masked_fill(keys > rows, masked)
    return s


def _online_stats(qb, k, q0, tiles, scale2, causal, mm, v=None, masked=float("-inf")):
    """The forward's pass over the key tiles (and the dQ kernel's statistics
    pass, v None), in base 2: running m and l, and with v the unnormalised
    P V. m starts at ``masked``, the kernels' mask value."""
    m = torch.full(qb.shape[:-1] + (1,), masked)
    l = torch.zeros_like(m)
    acc = torch.zeros(qb.shape)
    for j0 in tiles:
        s = _masked_scores(qb, k[..., j0:j0 + TILE, :], q0, j0, scale2, causal, mm, masked)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if v is not None:
            acc = acc * alpha + pv_permuted(p, v[..., j0:j0 + TILE, :], mm)
        m = m_new
    return m, l, acc


def fused_fwd_tf32(q, k, v, scale, causal=False, mm=mm_3xtf32):
    """The fp32 forward kernel's arithmetic: one online pass, then O = acc / l."""
    q, k, v = (x.float() for x in (q, k, v))
    out = torch.empty(q.shape)
    for q0, tiles in _blocks(q.shape[-2], k.shape[-2], causal, ROWS, TILE):
        qb = q[..., q0:q0 + ROWS, :]
        _, l, acc = _online_stats(qb, k, q0, tiles, _scale2(scale), causal, mm, v)
        out[..., q0:q0 + ROWS, :] = acc / l
    return out


def flash_fwd_tf32(q, k, v, scale, causal=False, mm=mm_3xtf32):
    """The flash kernel's fp32 route (``csrc/attention_fwd_tf32.cuh`` with
    FLASH): Q pre-scaled once in fp32 (the scale rounded to fp32), then the
    fused forward's online pass in base 2 on the pre-scaled scores times
    log2(e), keys masked and m started at -1e30, O = acc / max(l, 1e-30)."""
    q, k, v = (x.float() for x in (q, k, v))
    qs = q * torch.tensor(scale, dtype=torch.float32)
    out = torch.empty(q.shape)
    for q0, tiles in _blocks(q.shape[-2], k.shape[-2], causal, ROWS, TILE):
        qb = qs[..., q0:q0 + ROWS, :]
        _, l, acc = _online_stats(qb, k, q0, tiles, float(LOG2E), causal, mm, v, FLASH_MASKED)
        out[..., q0:q0 + ROWS, :] = acc / l.clamp_min(1e-30)
    return out


def fused_bwd_tf32(q, k, v, o, do, scale, causal=False, mm=mm_3xtf32):
    """The fp32 backward kernels' arithmetic -> (dq, dk, dv).

    dQ kernel: per 64-row block the forward's statistics pass, delta =
    rowsum(dO O); per 16-key chunk p = 2^(s - m) (1 / l) and dS = p (dP -
    delta), dQ += dS K (permuted k). dK/dV kernel: per 64-key block, 16-query chunks
    from the block's first key (causal) or from 0: S^T = K Q^T, dP^T = V dO^T,
    dV += P^T dO and dK += dS^T Q (permuted k)."""
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    lq, lk = q.shape[-2], k.shape[-2]
    neg, scale2 = float("-inf"), _scale2(scale)
    dq = torch.empty(q.shape)
    m_all = torch.empty(q.shape[:-1] + (1,))
    inv_l_all, delta_all = torch.empty_like(m_all), torch.empty_like(m_all)
    for q0, tiles in _blocks(lq, lk, causal, ROWS, TILE):
        qb, dob = q[..., q0:q0 + ROWS, :], do[..., q0:q0 + ROWS, :]
        m, l, _ = _online_stats(qb, k, q0, tiles, scale2, causal, mm)
        inv_l = 1 / l
        delta = (dob * o[..., q0:q0 + ROWS, :]).sum(-1, keepdim=True)
        acc = torch.zeros(qb.shape)
        for j0 in range(0, tiles.stop, CHUNK):
            kc, vc = k[..., j0:j0 + CHUNK, :], v[..., j0:j0 + CHUNK, :]
            s = _masked_scores(qb, kc, q0, j0, scale2, causal, mm)
            dp = mm(dob, vc.transpose(-1, -2))
            acc = acc + pv_permuted(torch.exp2(s - m) * inv_l * (dp - delta), kc, mm)
        dq[..., q0:q0 + ROWS, :] = acc * scale
        m_all[..., q0:q0 + ROWS, :], inv_l_all[..., q0:q0 + ROWS, :] = m, inv_l
        delta_all[..., q0:q0 + ROWS, :] = delta
    dk, dv = torch.empty(k.shape), torch.empty(v.shape)
    for j0 in range(0, lk, ROWS):
        kb, vb = k[..., j0:j0 + ROWS, :], v[..., j0:j0 + ROWS, :]
        acc_dk, acc_dv = torch.zeros(kb.shape), torch.zeros(vb.shape)
        for i0 in range(j0 if causal else 0, lq, CHUNK):
            qc, dc = q[..., i0:i0 + CHUNK, :], do[..., i0:i0 + CHUNK, :]
            st = mm(kb, qc.transpose(-1, -2)) * scale2
            if causal:
                keys = torch.arange(j0, j0 + kb.shape[-2])[:, None]
                queries = torch.arange(i0, i0 + qc.shape[-2])[None, :]
                st = st.masked_fill(keys > queries, neg)
            stat = lambda x: x[..., i0:i0 + CHUNK, 0].unsqueeze(-2)  # noqa: E731
            p = torch.exp2(st - stat(m_all)) * stat(inv_l_all)
            ds = p * (mm(vb, dc.transpose(-1, -2)) - stat(delta_all))
            acc_dv = acc_dv + pv_permuted(p, dc, mm)
            acc_dk = acc_dk + pv_permuted(ds, qc, mm)
        dk[..., j0:j0 + ROWS, :], dv[..., j0:j0 + ROWS, :] = acc_dk * scale, acc_dv
    return dq, dk, dv


def _inputs(b, h, lq, lk, d, seed):
    """Seeded q, k, v and the cotangent do."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (lq, lk, lk, lq)]


def _jax_fused_fwd(q, k, v, scale, causal):
    """The interpreted ``_fwd_kernel`` (``_fused_fwd``) in fp32."""
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import _fused_fwd

    return torch.from_numpy(np.array(_fused_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                                scale, causal)))


def _jax_vjp(q, k, v, do, scale, causal):
    """o and jax.vjp of the JAX ``fused_attention`` (its VJP is the interpreted
    ``_bwd_kernel``), fp32."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention as jax_fused,
    )

    o, vjp = jax.vjp(lambda q_, k_, v_: jax_fused(q_, k_, v_, scale, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return torch.from_numpy(np.array(o)), [torch.from_numpy(np.array(g))
                                           for g in vjp(jnp.asarray(do))]


# the serving / training image call (197 tokens) and the causal text call (77)
# at ViT-B-16's head width, cut to batch 2
MAIN_SHAPES = [((2, 12, 197, 197, 64), False), ((2, 8, 77, 77, 64), True)]


def test_tf32_round_is_cvt_rna():
    one = 1.0
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      one + 1.5 * ulp, 0.0, -0.0, 3.0e-39, 1.0e30], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, one + 2 * ulp, 0.0, -0.0],
                        dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got[:7], want)  # ties away from zero, in both signs
    assert torch.signbit(got[6])
    # every result has its 13 low mantissa bits clear and lies within half a TF32 ulp
    g = torch.Generator().manual_seed(0)
    r = torch.randn(100_000, generator=g) * torch.exp(torch.randn(100_000, generator=g) * 5)
    rounded = tf32_round(r)
    assert not (rounded.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    rel = ((rounded.double() - r.double()).abs() / r.double().abs()).max().item()
    assert rel <= 2.0 ** -11
    # nearest: no other TF32 value (one ulp up or down) is closer
    step = torch.ldexp(torch.ones_like(r), torch.frexp(rounded)[1] - 11).double()
    for other in (rounded.double() + step, rounded.double() - step):
        assert bool(((other - r.double()).abs() >= (rounded.double() - r.double()).abs()).all())


def test_split_keeps_fp32_accuracy_and_one_tf32_term_does_not():
    """hi + lo reproduces x to about 2^-22; the three-term product to about
    fp32's own error, where the one-term product is off by about 2^-11."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4096, generator=g)
    hi, lo = split_tf32(x)
    assert ((hi + lo - x).abs() / x.abs()).max().item() <= 2.0 ** -21
    a, b = torch.randn(64, 197, generator=g), torch.randn(197, 96, generator=g)
    exact = torch.matmul(a.double(), b.double())
    norm = torch.matmul(a.double().abs(), b.double().abs())  # the error's natural scale
    err3 = ((mm_3xtf32(a, b).double() - exact).abs() / norm).max().item()
    err1 = ((mm_tf32(a, b).double() - exact).abs() / norm).max().item()
    err32 = ((torch.matmul(a, b).double() - exact).abs() / norm).max().item()
    assert err3 < 4 * max(err32, 2.0 ** -24) and err3 < 1e-6, (err3, err32)
    assert err1 > 100 * err3 and err1 > 1e-4, (err1, err3)


def mma_from_lanes(a_frags, b_frags):
    """D = A B of one mma.m16n8k8 (.tf32) from the 32 lanes' fragments, as
    the PTX ISA lays them out: lane l, g = l // 4, t = l % 4; a = (a0..a3) at
    (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (b0, b1) at
    (k = t, n = g), (k = t + 4, n = g)."""
    a, b = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_frags[lane]
        b[t, g], b[t + 4, g] = b_frags[lane]
    return a @ b


def acc_frags(c):
    """Each lane's accumulator elements of a 16 x 8 tile: (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1)."""
    return [(c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_accumulator_feeds_the_next_product_in_the_permuted_order():
    """The kernels take an accumulator tile (P, dS) as the A operand of the
    next product with a = (c0, c2, c1, c3) and read the B operand's rows 2t
    and 2t + 1: lane for lane this is P Y exactly. Taking the accumulator in
    its own order with Y's rows t and t + 4 is not."""
    g = torch.Generator().manual_seed(2)
    p, y = torch.randn(16, 8, generator=g).double(), torch.randn(8, 8, generator=g).double()
    c = acc_frags(p)
    lanes = [divmod(lane, 4) for lane in range(32)]
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in c]
    b = [(y[2 * t, gg], y[2 * t + 1, gg]) for gg, t in lanes]
    torch.testing.assert_close(mma_from_lanes(a, b), p @ y, atol=1e-12, rtol=0)
    assert [2 * s if s < 4 else 2 * (s - 4) + 1 for s in range(8)] == PERM
    naive = mma_from_lanes(c, [(y[t, gg], y[t + 4, gg]) for gg, t in lanes])
    assert (naive - p @ y).abs().max().item() > 1e-3
    # the CUDA source does what the model does
    src = (CSRC / "attention_tf32.cuh").read_text()
    body = re.search(r"void acc_as_a\(.*?\n}\n", src, re.S).group(0)
    assert re.findall(r"split_tf32\(c\[(\d)\]", body) == ["0", "2", "1", "3"]
    assert "ys + 2 * (lane & 3) * kStride + (lane >> 2)" in src  # row 2t, column g
    assert "ld_cols<kStride, YLO>(b, yl + kk * 8 * kStride + n * 8)" in src
    assert "b[0][1] = __float_as_uint(p[S])" in src  # b1 the next row, 2t + 1


@pytest.mark.parametrize("dp", [32, 64, 128])
def test_one_pad_keeps_both_read_patterns_free_of_bank_conflicts(dp):
    """At a row stride of DP + 4 floats the 8 rows of an ldmatrix (16 bytes
    each) and the permuted column reads (row 2t, column g) both touch 32
    different banks; column reads in natural row order (row t) would not."""
    stride = dp + 4
    ldmatrix = {(r * stride + w) % 32 for r in range(8) for w in range(4)}
    permuted = {(2 * t * stride + g) % 32 for g in range(8) for t in range(4)}
    natural = {(t * stride + g) % 32 for g in range(8) for t in range(4)}
    assert len(ldmatrix) == 32 and len(permuted) == 32
    assert len(natural) < 32
    src = (CSRC / "attention_tf32.cuh").read_text()
    assert "constexpr int tf32_stride() { return DP + 4; }" in src


@pytest.mark.parametrize("shape,causal", MAIN_SHAPES)
def test_one_pass_fp32_forward_matches_interpreted_fwd_kernel(shape, causal):
    b, h, lq, lk, d = shape
    q, k, v, _ = _inputs(b, h, lq, lk, d, seed=lq + d)
    scale = d ** -0.5
    got = fused_fwd_tf32(*map(torch.from_numpy, (q, k, v)), scale, causal)
    want = _jax_fused_fwd(q, k, v, scale, causal)
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("shape,causal", MAIN_SHAPES)
def test_fp32_backward_schedule_matches_jax_vjp(shape, causal):
    b, h, lq, lk, d = shape
    q, k, v, do = _inputs(b, h, lq, lk, d, seed=lq + lk + d)
    scale = d ** -0.5
    o, want = _jax_vjp(q, k, v, do, scale, causal)
    got = fused_bwd_tf32(*map(torch.from_numpy, (q, k, v)), o, torch.from_numpy(do), scale,
                         causal)
    largest = max(w.abs().max().item() for w in want)
    for g_, w, name in zip(got, want, "qkv"):
        assert g_.shape == w.shape
        err = (g_ - w).abs().max().item()
        assert err <= BWD_REL_TOL * largest, (name, err, largest)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 70, 150, 80), (1, 2, 130, 45, 128), (2, 3, 33, 33, 40)])
def test_tf32_schedules_compute_the_plain_functions(shape, causal):
    """Lq != Lk both ways, head dims 40, 80 and 128 (padded to 64 and 128),
    partial tiles and chunks: the models give the plain versions' functions
    within the same tolerances."""
    b, h, lq, lk, d = shape
    q, k, v, do = map(torch.from_numpy, _inputs(b, h, lq, lk, d, seed=lq * lk))
    scale = d ** -0.5
    o = fused_attention_reference(q, k, v, scale, causal)
    torch.testing.assert_close(fused_fwd_tf32(q, k, v, scale, causal), o, atol=FWD_TOL, rtol=0)
    want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    largest = max(w.abs().max().item() for w in want)
    for g_, w in zip(fused_bwd_tf32(q, k, v, o, do, scale, causal), want):
        assert (g_ - w).abs().max().item() <= BWD_REL_TOL * largest


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_fp32_route_matches_interpreted_flash_kernel(shape, causal):
    """The ViT-L-14-336 length (577) at head dims 64 and 80, Lq < Lk and
    Lq > Lk (head dim 40): the model of the flash kernel's fp32 route
    against ``_flash_fwd_kernel`` interpreted through the JAX ``flash_mha``
    (its 128 x 128 tiles), in fp32."""
    b, h, lq, lk, d = shape
    q, k, v, _ = _inputs(b, h, lq, lk, d, seed=lq + lk + d)
    got = flash_fwd_tf32(*map(torch.from_numpy, (q, k, v)), d ** -0.5, causal)
    want = torch.from_numpy(_jax_flash(q, k, v, causal).copy())
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 130, 45, 128), (1, 2, 65, 200, 128), (2, 3, 1, 33, 64),
                                   (1, 2, 97, 70, 7)])
def test_flash_fp32_route_computes_the_plain_function(shape, causal):
    """Head dim 128 (the widest the route takes), partial query blocks and
    key tiles, one query row, and a head dim that is not a multiple of 8:
    the model gives ``flash_attention_reference``'s function."""
    b, h, lq, lk, d = shape
    q, k, v = map(torch.from_numpy, _inputs(b, h, lq, lk, d, seed=lq * lk + d)[:3])
    want = flash_attention_reference(q, k, v, d ** -0.5, causal)
    torch.testing.assert_close(flash_fwd_tf32(q, k, v, d ** -0.5, causal), want, atol=FWD_TOL,
                               rtol=0)


def test_one_tf32_product_misses_the_contract_in_the_flash_route():
    """At the ViT-L-14-336 vision call cut to batch 1 ([1,16,577,64]) the
    flash route through single TF32 products is off the interpreted
    ``_flash_fwd_kernel`` by about 3.8e-4, past the 1e-4 contract; through
    3xTF32 by under 1e-6."""
    b, h, l, d = 1, 16, 577, 64
    q, k, v, _ = _inputs(b, h, l, l, d, seed=11)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = torch.from_numpy(_jax_flash(q, k, v).copy())
    err1 = (flash_fwd_tf32(tq, tk, tv, d ** -0.5, mm=mm_tf32) - want).abs().max().item()
    err3 = (flash_fwd_tf32(tq, tk, tv, d ** -0.5) - want).abs().max().item()
    assert err1 > CONTRACT and err3 <= FWD_TOL, (err1, err3)


def test_one_tf32_product_misses_the_contract_and_the_split_meets_it():
    """Why the split exists. At the serving image shape cut to batch 1
    ([1,12,197,64]) with standard normal inputs (as the card's checks draw
    them), the forward through single TF32 products is off the interpreted
    ``_fwd_kernel`` by about 5e-4, past the 1e-4 contract, and its backward
    by about 6e-4 of the largest |grad|; through 3xTF32 both stay under 1e-6,
    ten times inside the tolerances here."""
    b, h, l, d = 1, 12, 197, 64
    q, k, v, do = _inputs(b, h, l, l, d, seed=7)
    scale = d ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    want = _jax_fused_fwd(q, k, v, scale, False)
    err1 = (fused_fwd_tf32(tq, tk, tv, scale, mm=mm_tf32) - want).abs().max().item()
    err3 = (fused_fwd_tf32(tq, tk, tv, scale) - want).abs().max().item()
    assert err1 > CONTRACT and err3 <= FWD_TOL, (err1, err3)
    o, grads = _jax_vjp(q, k, v, do, scale, False)
    largest = max(g_.abs().max().item() for g_ in grads)

    def worst(mm):
        got = fused_bwd_tf32(tq, tk, tv, o, tdo, scale, mm=mm)
        return max((g_ - w).abs().max().item() for g_, w in zip(got, grads)) / largest

    bwd1, bwd3 = worst(mm_tf32), worst(mm_3xtf32)
    assert bwd1 > CONTRACT and bwd3 <= BWD_REL_TOL, (bwd1, bwd3)


def test_models_use_the_kernels_tiles():
    """The models' block height, key tile, chunk and k-step are the CUDA
    sources', and the fp32 routes go through the split primitives."""
    tf32 = (CSRC / "attention_tf32.cuh").read_text()
    assert int(re.search(r"constexpr int kTf32Tile = (\d+);", tf32).group(1)) == TILE
    assert float(re.search(r"constexpr float kLog2e = ([\d.]+)f;", tf32).group(1)) == LOG2E
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in tf32
    # tf32_round's rounding, as the kernels split
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in tf32
    mma = (CSRC / "attention_mma.cuh").read_text()
    assert int(re.search(r"constexpr int kMmaRows = (\d+);", mma).group(1)) == ROWS
    # the forward's body, shared by the fused and the flash kernels' fp32 routes
    body = (CSRC / "attention_fwd_tf32.cuh").read_text()
    for used in ("tile_scores_f32<DP, kTile,", "tile_pv_f32<DP, kTile,", "online_softmax<kTile,",
                 "kTile = kTf32Tile", "kRows = kMmaRows",
                 "const float kMasked = FLASH ? -1e30f : -INFINITY;",
                 "float m[2] = {kMasked, kMasked}",
                 "const float scale2 = FLASH ? kLog2e : scale * kLog2e;",
                 "y.x * scale, y.y * scale, y.z * scale, y.w * scale",
                 "if constexpr (FLASH) l[0] = fmaxf(l[0], 1e-30f), l[1] = fmaxf(l[1], 1e-30f);"):
        assert used in body, used
    assert float(re.search(r"FLASH \? (-1e30)f", body).group(1)) == FLASH_MASKED
    # Q is scaled before its fragments are split, where the TPU kernel scales it
    assert body.index("y.x * scale") < body.index("load_a_frags<DP>(qf, qw, lane)")
    fwd = (CSRC / "fused_attention_fwd.cu").read_text()
    for used in ("fa::attention_fwd_tf32<DP, false>(", "(fa::tf32_min_blocks<DP, false>())",
                 "if (dtype == 0) return dispatch_tf32(",
                 "if (d <= 128)\n    return fa::launch_fwd_tf32<128>(fused_attention_fwd_tf32_kernel"):
        assert used in fwd, used
    flash = (CSRC / "flash_attention_fwd.cu").read_text()
    for used in ("fa::attention_fwd_tf32<DP, true>(", "(fa::tf32_min_blocks<DP, true>())",
                 "if (dtype == 0) return dispatch_f32(",
                 "if (d <= 128)\n    return fa::launch_fwd_tf32<128>(flash_attention_fwd_tf32_kernel",
                 "return launch<float, 256>(",
                 "const long long rows = dtype == 0 && d > 128 ? kBQ : fa::kMmaRows;"):
        assert used in flash, used
    bwd = (CSRC / "fused_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", bwd).group(1)) == CHUNK
    for used in ("fa::tile_scores_f32<DP, kTile, kRegs,", "fa::tile_scores_f32<DP, kChunk,",
                 "fa::tile_pv_f32<DP, kChunk,", "fa::online_softmax<kTile,",
                 "if (dtype == 0) return dispatch_f32("):
        assert used in bwd, used
