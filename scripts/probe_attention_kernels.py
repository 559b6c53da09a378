#!/usr/bin/env python3
"""A short first call on the card after a change to an attention kernel.

    python3 scripts/probe_attention_kernels.py

Builds the kernels (printing ptxas's registers and spills for each), holds
both forward kernels against their plain versions and the float64 versions
at every ``chip_smoke.KERNEL_CASES`` / ``FLASH_CASES`` shape in bfloat16 and
float32, then at head dims that are not multiples of 4, 8 or 16 and with
bases off a 16-byte boundary (2 bytes in bfloat16, 4 in float32: element
copies), in both dtypes; the same for the backward kernel
(``chip_smoke.bwd_cases()``, Lq != Lk among them). Both dtypes run the
tensor-core kernels up to head dim 128 (float32 through split-TF32
products, both forwards sharing one body); both float32 forwards and both
backwards past 128 the scalar kernels. Then it times the training and
serving shapes, each beside the scalar kernels' time it replaced where
recorded. Unlike ``chip_smoke.py`` it
reports every case before it fails, and it runs no model. Exits non-zero if
any case disagrees.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

ODD_HEAD_DIMS = (1, 7, 20, 33, 40, 72, 100, 129, 200, 255, 256)
TIMED = [(64, 12, 197, 64, False), (64, 8, 77, 64, True), (32, 12, 197, 64, False),
         (8, 12, 197, 64, False), (32, 8, 77, 64, True)]


def _misaligned(dtype):
    """q, k, v [2,3,70,64] whose bases lie one element off a 16-byte boundary."""
    import torch

    n = 2 * 3 * 70 * 64
    flat = torch.randn(3 * n + 1, device="cuda").to(dtype)
    return [flat[1 + i * n:1 + (i + 1) * n].view(2, 3, 70, 64) for i in range(3)]


def main() -> None:
    import torch

    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd, fused_attention_reference,
    )

    cs.phase_device()
    cs.phase_build()
    kernels = {"fused": (fused_attention_fwd, fused_attention_reference, cs._attention_fp64),
               "flash": (flash_attention_fwd, flash_attention_reference, cs._flash_fp64)}
    cases = [("fused", b, h, l, l, d, c, i) for i, (b, h, l, d, c) in enumerate(cs.KERNEL_CASES)]
    cases += [("flash", *case, 300 + i) for i, case in enumerate(cs.FLASH_CASES)]
    bad = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind, b, h, lq, lk, d, causal, seed in cases:
            fn, ref, exact = kernels[kind]
            q, k, v = cs._qkv(b, h, lq, d, dtype, seed=seed, lk=lk)
            got = fn(q, k, v, d ** -0.5, causal)
            torch.cuda.synchronize()
            err = (got.float() - ref(q, k, v, d ** -0.5, causal).float()).abs().max().item()
            err64 = (got.double() - exact(q, k, v, d ** -0.5, causal)).abs().max().item()
            ok = max(err, err64) <= cs.TOL[name] and bool(torch.isfinite(got.float()).all())
            bad += not ok
            print(f"{kind} {name} [{b},{h},{lq},{d}] x {lk} causal={causal}: {err:.3e} vs plain, "
                  f"{err64:.3e} vs float64 {'ok' if ok else 'MISMATCH'}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kind, (fn, ref, _) in kernels.items():
            lq, lk = (70, 90) if kind == "fused" else (130, 100)
            for d in ODD_HEAD_DIMS:
                for causal in (False, True):
                    q, k, v = cs._qkv(2, 3, lq, d, dtype, seed=d, lk=lk)
                    err = (fn(q, k, v, d ** -0.5, causal).float()
                           - ref(q, k, v, d ** -0.5, causal).float()).abs().max().item()
                    bad += err > cs.TOL[name]
                    print(f"{kind} {name} head_dim {d} causal={causal}: {err:.3e} vs plain",
                          flush=True)
            q, k, v = _misaligned(dtype)
            err = (fn(q, k, v, 0.125, True).float() - ref(q, k, v, 0.125, True).float()).abs().max()
            bad += err.item() > cs.TOL[name]
            print(f"{kind} {name} bases {q.element_size()} bytes off 16: {err.item():.3e} vs "
                  f"plain", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for i, case in enumerate(cs.bwd_cases()):
            bad += not cs.check_bwd_case(*case, dtype, seed=i)[1]
        for d in ODD_HEAD_DIMS + (80, 128):
            for causal in (False, True):
                bad += not cs.check_bwd_case(2, 3, 70, 90, d, causal, dtype, seed=d)[1]
        q, k, v = _misaligned(dtype)
        print(f"backward, bases {q.element_size()} bytes off 16:", flush=True)
        bad += not cs.check_bwd_case(2, 3, 70, 70, 64, True, dtype, seed=7, qkv=(q, k, v))[1]
    for dtype_name in ("bfloat16", "float32"):
        cs.phase_bwd_times(dtype_name)
    for dtype_name in ("bfloat16", "float32"):
        for b, h, l, d, causal in TIMED:
            q, k, v = cs._qkv(b, h, l, d, getattr(torch, dtype_name), seed=100)
            ms = cs.time_ms(lambda: fused_attention_fwd(q, k, v, d ** -0.5, causal))
            before = cs.SCALAR_FUSED_MS.get((dtype_name, (b, h, l, d, causal)))
            print(f"time fused {dtype_name} [{b},{h},{l},{d}] causal={causal}: {ms:.4f} ms; "
                  f"{cs._beside_scalar(before, ms)} [{cs.CARD}]", flush=True)
    for b, h, lq, lk, d, causal, dtype_name in cs.FLASH_TIMED:
        q, k, v = cs._qkv(b, h, lq, d, getattr(torch, dtype_name), seed=500, lk=lk)
        ms = cs.time_ms(lambda: flash_attention_fwd(q, k, v, d ** -0.5, causal), iters=20)
        before = cs.SCALAR_FLASH_MS.get((b, h, lq, lk, d, causal, dtype_name))
        print(f"time flash {dtype_name} [{b},{h},{lq},{d}]: {ms:.4f} ms; "
              f"{cs._beside_scalar(before, ms)} [{cs.CARD}]", flush=True)
    print(f"probe: {bad} case(s) disagree", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
