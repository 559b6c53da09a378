"""Models of the bf16 tensor-core schedules of the attention kernels.

The CUDA kernels do not run on the CPU, so their arithmetic is modelled here
in PyTorch, step for step: 64-row query blocks, key tiles of 64 (32 at head
dim > 128), scores accumulated in fp32 from bf16 operands, and bf16 rounding
exactly where the kernels round.

* ``flash_schedule`` (``csrc/flash_attention_fwd.cu``): Q scaled in bf16 once,
  an online softmax over the key tiles with m and l in fp32, p rounded to
  bf16 in registers for the P V product, the division after it.
* ``fused_two_pass`` (``csrc/fused_attention_fwd.cu``): pass 1 takes each
  row's max and sum over the key tiles (online), pass 2 recomputes S and
  forms the normalised p in fp32 before rounding it to bf16 for P V.

* ``fused_bwd_schedule`` (``csrc/fused_attention_bwd.cu``, bf16 up to head
  dim 128): the dQ kernel's statistics pass (the fused forward's pass 1),
  then dS = P (dP - delta) in fp32 rounded to bf16 for dS K; the dK/dV
  kernel's walk over the query chunks with those statistics, P rounded to
  bf16 for P^T dO and dS for dS^T Q.

Each model is held against the JAX package's Pallas kernel, interpreted on
the CPU, on the same bf16 inputs. Tolerances, compared in fp32: the fused
model against ``_fwd_kernel`` 2e-3 absolute (the two round at the same
points; they differ by summation order, which flips a bf16 rounding of P or
of the output now and then, and one output ulp at |o| < 0.5 is <= 2e-3);
the flash model against ``_flash_fwd_kernel`` 2e-2, as the flash tests
(its 64-key tiles round p relative to other running maxima than the TPU
kernel's 128-key tiles), and 2e-3 with the TPU kernel's own tiles; the
backward model against ``jax.vjp`` of ``fused_attention`` (``_bwd_kernel``)
2e-2 of the largest |grad|, as the backward tests (a dS that flips by one
bf16 ulp moves a gradient by a few ulps). Without bf16 rounding each model
is the plain version's function within 2e-5 (summation order only).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
    flash_attention_reference,
)
from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
    fused_attention_bwd_reference,
    fused_attention_reference,
)

CSRC = Path(__file__).resolve().parents[1] / "refining_clip_via_dinov2_representations_torch" / "csrc"
ROWS = 64  # query rows per block: 4 warps x the m16 of mma.sync m16n8k16
CHUNK = 16  # keys (dQ) or queries (dK/dV) per product step of the backward
NEG_INF = -1e30  # the flash kernel's mask value
SAME_POINTS_TOL = 2e-3
FLASH_TILE_TOL = 2e-2
FP32_TOL = 2e-5
BWD_REL_TOL = 2e-2  # of the largest |grad|, as tests/test_torch_fused_attention_bwd.py


def key_tile(d: int) -> int:
    """Keys per tile at head dim d: d is padded to DP in {32, 64, 128, 256},
    and DP = 256 takes 32-key tiles."""
    return 32 if d > 128 else 64


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to fp32 (bf16 where the kernels round;
    a no-op for fp32 inputs, where the models show the tile order alone)."""
    return x.to(dtype).float()


def _blocks(lq: int, lk: int, causal: bool, rows: int, tile: int):
    """(query block start, key tile starts) in the kernels' order; causal
    blocks stop at their last row's diagonal tile."""
    for q0 in range(0, lq, rows):
        n_keys = min(lk, q0 + rows) if causal else lk
        yield q0, range(0, n_keys, tile)


def _scores(qb, k, q0, j0, tile, causal, fill):
    """One tile of S = Q K^T in fp32 with keys past the query's index set
    to ``fill`` when causal (keys past Lk are not in the slice: the kernels
    mask them, which adds nothing)."""
    kt = k[..., j0:j0 + tile, :]
    s = torch.matmul(qb, kt.transpose(-1, -2))
    if causal:
        rows = torch.arange(q0, q0 + qb.shape[-2])[:, None]
        keys = torch.arange(j0, j0 + kt.shape[-2])[None, :]
        s = s.masked_fill(keys > rows, fill)
    return s


def flash_schedule(q, k, v, scale, causal=False, rows=ROWS, tile=None):
    """The bf16 flash kernel's arithmetic. q: [B,H,Lq,D]; k, v: [B,H,Lk,D]."""
    tile = tile or key_tile(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    qs = _round(q.float() * _round(torch.tensor(scale), q.dtype), q.dtype)
    kf, vf = k.float(), v.float()
    out = torch.empty(qs.shape)
    for q0, tiles in _blocks(lq, lk, causal, rows, tile):
        qb = qs[..., q0:q0 + rows, :]
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape)
        for j0 in tiles:
            s = _scores(qb, kf, q0, j0, tile, causal, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(_round(p, v.dtype), vf[..., j0:j0 + tile, :])
            m = m_new
        out[..., q0:q0 + rows, :] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def fused_two_pass(q, k, v, scale, causal=False, rows=ROWS, tile=None):
    """The bf16 fused kernel's arithmetic: two passes over the key tiles."""
    tile = tile or key_tile(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(qf.shape)
    for q0, tiles in _blocks(lq, lk, causal, rows, tile):
        qb = qf[..., q0:q0 + rows, :]
        m = torch.full(qb.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        for j0 in tiles:  # pass 1: row max and sum in fp32
            s = _scores(qb, kf, q0, j0, tile, causal, float("-inf")) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
            m = m_new
        acc = torch.zeros(qb.shape)
        for j0 in tiles:  # pass 2: normalised p in fp32, rounded for P V
            s = _scores(qb, kf, q0, j0, tile, causal, float("-inf")) * scale
            p = torch.exp(s - m) / l
            acc = acc + torch.matmul(_round(p, v.dtype), vf[..., j0:j0 + tile, :])
        out[..., q0:q0 + rows, :] = acc
    return out.to(q.dtype)


def fused_divide_after(q, k, v, scale, causal=False, rows=ROWS, tile=None):
    """What a flash-style epilogue would compute for the fused kernel: one
    online pass, unnormalised p rounded for P V, the division after it."""
    tile = tile or key_tile(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(qf.shape)
    for q0, tiles in _blocks(lq, lk, causal, rows, tile):
        qb = qf[..., q0:q0 + rows, :]
        m = torch.full(qb.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape)
        for j0 in tiles:
            s = _scores(qb, kf, q0, j0, tile, causal, float("-inf")) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(_round(p, v.dtype), vf[..., j0:j0 + tile, :])
            m = m_new
        out[..., q0:q0 + rows, :] = acc / l
    return out.to(q.dtype)


def fused_bwd_schedule(q, k, v, o, do, scale, causal=False, rows=ROWS, tile=None,
                       chunk=CHUNK):
    """The bf16 backward kernels' arithmetic: q, o, do [B,H,Lq,D]; k, v
    [B,H,Lk,D] -> (dq, dk, dv) in q's dtype.

    dQ kernel: per 64-row block, pass 1 takes each row's max m and sum l
    over the key tiles (online, as the fused forward); delta = rowsum(dO O)
    in fp32; pass 2, a chunk of keys at a time, forms p = exp(s - m) / l and
    dS = p (dP - delta) in fp32, rounds dS and accumulates dS K.
    dK/dV kernel: per 64-key block, the query chunks from the block's first
    key on (causal) or from 0, with the first kernel's m, l and delta:
    dV += (P rounded)^T dO, dK += dS^T Q."""
    tile = tile or key_tile(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    neg = float("-inf")
    dq = torch.empty(qf.shape)
    m_all = torch.empty(qf.shape[:-1] + (1,))
    l_all, delta_all = torch.empty_like(m_all), torch.empty_like(m_all)
    for q0, tiles in _blocks(lq, lk, causal, rows, tile):
        qb, dob = qf[..., q0:q0 + rows, :], dof[..., q0:q0 + rows, :]
        m = torch.full(qb.shape[:-1] + (1,), neg)
        l = torch.zeros_like(m)
        for j0 in tiles:  # pass 1
            s = _scores(qb, kf, q0, j0, tile, causal, neg) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
            m = m_new
        delta = (dob * of[..., q0:q0 + rows, :]).sum(-1, keepdim=True)
        acc = torch.zeros(qb.shape)
        for j0 in range(0, tiles.stop, chunk):  # pass 2
            s = _scores(qb, kf, q0, j0, chunk, causal, neg) * scale
            dp = torch.matmul(dob, vf[..., j0:j0 + chunk, :].transpose(-1, -2))
            ds = _round(torch.exp(s - m) / l * (dp - delta), q.dtype)
            acc = acc + torch.matmul(ds, kf[..., j0:j0 + chunk, :])
        dq[..., q0:q0 + rows, :] = acc * scale
        m_all[..., q0:q0 + rows, :], l_all[..., q0:q0 + rows, :] = m, l
        delta_all[..., q0:q0 + rows, :] = delta
    dk, dv = torch.empty(kf.shape), torch.empty(vf.shape)
    for j0 in range(0, lk, rows):
        kb, vb = kf[..., j0:j0 + rows, :], vf[..., j0:j0 + rows, :]
        acc_dk, acc_dv = torch.zeros(kb.shape), torch.zeros(vb.shape)
        for i0 in range(j0 if causal else 0, lq, chunk):
            qc, dc = qf[..., i0:i0 + chunk, :], dof[..., i0:i0 + chunk, :]
            st = _scores(qc, kf, i0, j0, rows, causal, neg).transpose(-1, -2) * scale
            stat = lambda x: x[..., i0:i0 + chunk, 0].unsqueeze(-2)  # noqa: E731
            p = torch.exp(st - stat(m_all)) / stat(l_all)
            dpt = torch.matmul(vb, dc.transpose(-1, -2))
            ds = _round(p * (dpt - stat(delta_all)), q.dtype)
            acc_dv = acc_dv + torch.matmul(_round(p, v.dtype), dc)
            acc_dk = acc_dk + torch.matmul(ds, qc)
        dk[..., j0:j0 + rows, :], dv[..., j0:j0 + rows, :] = acc_dk * scale, acc_dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _qkv(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (lq, lk, lk)]


def _bf16_pair(arrays):
    """The same bf16 values as torch tensors and as JAX arrays."""
    import jax.numpy as jnp

    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in arrays]
    jq = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tq]
    return tq, jq


def _jax_fused(jq, scale, causal):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import _fused_fwd

    return torch.from_numpy(np.array(_fused_fwd(*jq, scale, causal).astype(jnp.float32)))


def _jax_flash(jq, causal, block_q=128, block_k=128):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.flash_attention import flash_mha

    out = flash_mha(*jq, causal=causal, block_q=block_q, block_k=block_k)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# (B, H, Lq, Lk, D): the shapes the fused tests use (23 and 197 tokens at
# head dim 16, 77 at 64), Lq != Lk, and head dim 40 (padded to 64)
FUSED_SHAPES = [(2, 3, 23, 23, 16), (2, 4, 77, 77, 64), (1, 3, 197, 197, 16),
                (2, 3, 50, 90, 40), (1, 2, 130, 70, 64)]
# the flash tests' 577 tokens at head dim 64 and 80, Lq != Lk, head dim 40
FLASH_SHAPES = [(1, 2, 577, 577, 64), (1, 2, 577, 577, 80), (1, 2, 600, 1030, 64),
                (1, 2, 520, 300, 40)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_two_pass_matches_jax_kernel_bf16(shape, causal):
    b, h, lq, lk, d = shape
    tq, jq = _bf16_pair(_qkv(b, h, lq, lk, d, seed=lq + d))
    scale = d ** -0.5
    got = fused_two_pass(*tq, scale, causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), _jax_fused(jq, scale, causal),
                               atol=SAME_POINTS_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_schedule_matches_jax_kernel_bf16(shape, causal):
    b, h, lq, lk, d = shape
    tq, jq = _bf16_pair(_qkv(b, h, lq, lk, d, seed=lq + d))
    got = flash_schedule(*tq, d ** -0.5, causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), _jax_flash(jq, causal), atol=FLASH_TILE_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_model_at_the_tpu_tiles_reproduces_the_kernel(causal):
    """With the TPU kernel's 128-row blocks and 128-key tiles the model
    rounds where ``_flash_fwd_kernel`` rounds, relative to the same running
    maxima: the model is the kernel's arithmetic, and the Hopper kernel's
    only change to it is the tile order."""
    tq, jq = _bf16_pair(_qkv(1, 2, 577, 577, 64, seed=3))
    got = flash_schedule(*tq, 0.125, causal, rows=128, tile=128)
    torch.testing.assert_close(got.float(), _jax_flash(jq, causal), atol=SAME_POINTS_TOL, rtol=0)


def test_fused_kernel_needs_two_passes():
    """``_fwd_kernel`` normalises P before rounding it: the two-pass model
    reproduces it where the flash-style division after the product does
    not. Counted over bf16 outputs that differ from the TPU kernel's."""
    tq, jq = _bf16_pair(_qkv(2, 4, 197, 197, 64, seed=21))
    want = _jax_fused(jq, 0.125, False)
    two_pass = fused_two_pass(*tq, 0.125).float()
    after = fused_divide_after(*tq, 0.125).float()
    off_two_pass = (two_pass != want).float().mean().item()
    off_after = (after != want).float().mean().item()
    assert off_two_pass < 0.01, off_two_pass
    assert off_after > 10 * max(off_two_pass, 1e-3), (off_after, off_two_pass)
    torch.testing.assert_close(two_pass, want, atol=SAME_POINTS_TOL, rtol=0)
    assert (after - want).abs().max().item() > SAME_POINTS_TOL


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 150, 150, 64), (1, 2, 70, 200, 40),
                                   (1, 2, 100, 80, 200)])
def test_schedules_compute_the_plain_functions_in_fp32(shape, causal):
    """Without bf16 rounding, tile order and masking give the plain
    versions' functions: 64-row blocks, key tiles of 64 and, at head dim
    200, of 32, the causal stop, Lq != Lk."""
    b, h, lq, lk, d = shape
    q, k, v = map(torch.from_numpy, _qkv(b, h, lq, lk, d, seed=lq * lk))
    scale = d ** -0.5
    torch.testing.assert_close(fused_two_pass(q, k, v, scale, causal),
                               fused_attention_reference(q, k, v, scale, causal),
                               atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(flash_schedule(q, k, v, scale, causal),
                               flash_attention_reference(q, k, v, scale, causal),
                               atol=FP32_TOL, rtol=FP32_TOL)


def _jax_fused_vjp(jq, jdo, scale, causal):
    """o and the gradients of the JAX ``fused_attention`` (its VJP is the
    interpreted ``_bwd_kernel``), as fp32 torch tensors."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.ops.fused_attention import (
        fused_attention as jax_fused,
    )

    o, vjp = jax.vjp(lambda q_, k_, v_: jax_fused(q_, k_, v_, scale, causal), *jq)
    as_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))  # noqa: E731
    return as_torch(o), [as_torch(g) for g in vjp(jdo)]


# (B, H, Lq, Lk, D): the text (77) and image (197) lengths at head dim 64,
# Lq != Lk both ways, head dims 40 and 80 (padded to 64 and 128)
BWD_SHAPES = [(2, 4, 77, 77, 64), (1, 3, 197, 197, 64), (2, 3, 50, 90, 40),
              (1, 2, 130, 70, 80), (1, 2, 70, 150, 80)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_fused_bwd_schedule_matches_jax_vjp_bf16(shape, causal):
    b, h, lq, lk, d = shape
    arrays = _qkv(b, h, lq, lk, d, seed=lq + lk + d)
    arrays.append(np.random.default_rng(d).normal(size=(b, h, lq, d)).astype(np.float32))
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _bf16_pair(arrays)
    scale = d ** -0.5
    o, want = _jax_fused_vjp((jq, jk, jv), jdo, scale, causal)
    got = fused_bwd_schedule(tq, tk, tv, o.to(torch.bfloat16), tdo, scale, causal)
    largest = max(w.abs().max().item() for w in want)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        assert err <= BWD_REL_TOL * largest, (name, err, largest)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 150, 150, 64), (1, 2, 70, 200, 40),
                                   (1, 2, 130, 90, 128)])
def test_fused_bwd_schedule_computes_the_plain_backward_in_fp32(shape, causal):
    """Without bf16 rounding, the two kernels' blocks, chunks, statistics
    and causal walks give ``fused_attention_bwd_reference``'s function."""
    b, h, lq, lk, d = shape
    q, k, v = map(torch.from_numpy, _qkv(b, h, lq, lk, d, seed=lq * lk))
    do = torch.from_numpy(np.random.default_rng(d).normal(size=(b, h, lq, d)).astype(np.float32))
    scale = d ** -0.5
    o = fused_attention_reference(q, k, v, scale, causal)
    got = fused_bwd_schedule(q, k, v, o, do, scale, causal)
    want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=FP32_TOL, rtol=FP32_TOL)


def test_models_use_the_kernels_tiles():
    """The models' block height, key tiles and backward chunk are the CUDA
    sources'."""
    src = (CSRC / "attention_mma.cuh").read_text()
    assert int(re.search(r"constexpr int kMmaRows = (\d+);", src).group(1)) == ROWS
    big, small = re.search(r"return DP >= 256 \? (\d+) : (\d+);", src).groups()
    assert (int(big), int(small)) == (key_tile(256), key_tile(64))
    for name in ("fused_attention_fwd.cu", "flash_attention_fwd.cu"):
        kernel = (CSRC / name).read_text()
        for used in ("fa::tile_scores<DP, kTile,", "fa::tile_pv<DP, kTile,",
                     "kTile = fa::mma_key_tile<DP>()", "kRows = fa::kMmaRows"):
            assert used in kernel, (name, used)
    bwd = (CSRC / "fused_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", bwd).group(1)) == CHUNK
    # pass 1 on whole key tiles; the products of pass 2 and of dK/dV on chunks
    for used in ("fa::tile_scores<DP, kTile, true,", "fa::tile_scores<DP, kChunk,",
                 "fa::tile_pv<DP, kChunk,", "kTile = fa::mma_key_tile<DP>()",
                 "kRows = fa::kMmaRows"):
        assert used in bwd, used
