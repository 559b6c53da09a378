"""Models of the bf16 tensor-core schedules of the two forward kernels.

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

Each model is held against the JAX package's Pallas kernel, interpreted on
the CPU, on the same bf16 inputs. Tolerances, compared in fp32: the fused
model against ``_fwd_kernel`` 2e-3 absolute (the two round at the same
points; they differ by summation order, which flips a bf16 rounding of P or
of the output now and then, and one output ulp at |o| < 0.5 is <= 2e-3);
the flash model against ``_flash_fwd_kernel`` 2e-2, as the flash tests
(its 64-key tiles round p relative to other running maxima than the TPU
kernel's 128-key tiles), and 2e-3 with the TPU kernel's own tiles.
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
    fused_attention_reference,
)

CSRC = Path(__file__).resolve().parents[1] / "refining_clip_via_dinov2_representations_torch" / "csrc"
ROWS = 64  # query rows per block: 4 warps x the m16 of mma.sync m16n8k16
NEG_INF = -1e30  # the flash kernel's mask value
SAME_POINTS_TOL = 2e-3
FLASH_TILE_TOL = 2e-2
FP32_TOL = 2e-5


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


def test_models_use_the_kernels_tiles():
    """The models' block height and key tiles are the CUDA sources'."""
    src = (CSRC / "attention_mma.cuh").read_text()
    assert int(re.search(r"constexpr int kMmaRows = (\d+);", src).group(1)) == ROWS
    big, small = re.search(r"return DP >= 256 \? (\d+) : (\d+);", src).groups()
    assert (int(big), int(small)) == (key_tile(256), key_tile(64))
    for name in ("fused_attention_fwd.cu", "flash_attention_fwd.cu"):
        kernel = (CSRC / name).read_text()
        for used in ("fa::tile_scores<DP, kTile,", "fa::tile_pv<DP, kTile,",
                     "kTile = fa::mma_key_tile<DP>()", "kRows = fa::kMmaRows"):
            assert used in kernel, (name, used)
