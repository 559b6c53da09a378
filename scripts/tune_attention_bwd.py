#!/usr/bin/env python3
"""Compare build variants of the fused-attention backward on one card.

    python3 scripts/tune_attention_bwd.py

Each variant is ``csrc/fused_attention_bwd.cu`` with a few source lines
replaced (blocks an SM, the product chunk). All variants are compiled at once with the flags
of ``ops/native.py`` into ``build/tune_bwd/`` and loaded with ctypes. For
each, at the bf16 training shapes: the largest difference from the plain
version (over the largest |grad|), the time per call by CUDA events and the
time of each of its two kernels by ``torch.profiler``. ptxas's registers and
spills are printed per variant and kernel. Exits non-zero if a variant does
not build or disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

BLOCKS = "constexpr int mma_bwd_min_blocks() { return DP <= 64 ? 4 : 2; }"
CHUNK = "constexpr int kChunk = 16;"
VARIANTS = {
    "as committed": [],
    "32-wide chunks": [(CHUNK, CHUNK.replace("16", "32"))],
    "3 blocks an SM": [(BLOCKS, BLOCKS.replace("4 : 2", "3 : 2"))],
}


def build_variants(native, out_dir: Path) -> dict:
    """{variant: path of its library}; prints ptxas lines per kernel."""
    src = (native.CSRC_DIR / "fused_attention_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                cs.fail(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, lib = out_dir / f"variant{i}.cu", out_dir / f"variant{i}.so"
        cu.write_text(text)
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC_DIR), "-o", str(lib),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {name!r} did not build:\n{log}")
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = cs._kernel_name(entry.group(1))
            elif "mma_kernel" in kernel and ("registers" in line or "spill" in line):
                print(f"  ptxas[{name}] {kernel}: {line.strip()}", flush=True)
        libs[name] = lib
    return libs


def bind(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_attention_bwd.argtypes = [p] * 9 + [i, i, i, i, ctypes.c_float, i, i, p]
    lib.fused_attention_bwd.restype = i

    def bwd(q, k, v, o, do, scale, causal):
        import torch

        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        b, h, lq, d = q.shape
        stats = torch.empty(3 * b * h * lq, dtype=torch.float32, device=q.device)
        err = lib.fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b * h, lq,
            k.shape[2], d, float(scale), int(causal), 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_attention_bwd launch failed ({err})")
        return dq, dk, dv

    return bwd


def kernel_ms(fn, calls: int = 20) -> dict:
    """Device time per call of each backward kernel, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"fused_attention_bwd_(\w+?)_mma_kernel", e.key)
        if found:
            total = getattr(e, "device_time_total", None) or e.cuda_time_total
            out[found.group(1)] = total / calls / 1e3
    return out


def main() -> None:
    import torch

    from refining_clip_via_dinov2_representations_torch.ops import native
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd_reference, fused_attention_fwd,
    )

    cs.phase_device()
    libs = build_variants(native, native.BUILD_DIR.parent / "tune_bwd")
    bad = 0
    for b, h, l, d, causal in cs.TRAIN_CASES:
        q, k, v = cs._qkv(b, h, l, d, torch.bfloat16, seed=200)
        do = cs._qkv(b, h, l, d, torch.bfloat16, seed=201)[0]
        scale = d ** -0.5
        o = fused_attention_fwd(q, k, v, scale, causal)
        want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
        largest = max(w.float().abs().max().item() for w in want)
        for name, path in libs.items():
            bwd = bind(path)
            got = bwd(q, k, v, o, do, scale, causal)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            ok = err <= cs.BWD_REL_TOL["bfloat16"] * largest
            bad += not ok
            ms = cs.time_ms(lambda: bwd(q, k, v, o, do, scale, causal), iters=20)
            split = kernel_ms(lambda: bwd(q, k, v, o, do, scale, causal))
            print(f"variant {name!r} bfloat16 [{b},{h},{l},{d}] causal={causal}: {ms:.4f} ms "
                  f"(dq {split.get('dq', 0):.4f}, dkdv {split.get('dkdv', 0):.4f} ms by the "
                  f"profiler), max_abs_err {err:.3e} vs plain {'ok' if ok else 'MISMATCH'} "
                  f"[{cs.CARD}]", flush=True)
    print(f"tune: {bad} variant case(s) disagree", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
