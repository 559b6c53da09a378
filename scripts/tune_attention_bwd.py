#!/usr/bin/env python3
"""Compare build variants of the attention kernels on one card.

    python3 scripts/tune_attention_bwd.py [variant ...]

Each variant is ``csrc/`` with a few source lines replaced (blocks an SM,
the backward's product chunk, the fp32 route's key tile, where its split
TF32 operands are split, which of its fragments stay in registers). The
fp32 forward's body (``csrc/attention_fwd_tf32.cuh``) is shared by the
fused and the flash kernels, so a forward variant changes both. Every
variant's copy of ``csrc/`` goes into its own directory under
``build/tune_bwd/``, and the two fused sources and the flash source of all
variants are compiled at once with the flags of ``ops/native.py`` and
loaded with ctypes. For each variant, at the training shapes of the
backward (bf16 and fp32), the serving and training shapes of the fp32 fused
forward and the ViT-L-14-336 and ViT-B-16@384 vision calls of the fp32
flash forward: the largest difference from the plain version (over the
largest |grad| for the backward), the time per call by CUDA events and, for
the backward, the time of each of its two kernels by ``torch.profiler``.
ptxas's registers and spills are printed per variant and tensor-core
kernel. With arguments, only the named variants (and the committed build)
run, and ``--forward`` leaves out the backward's cases. Exits non-zero if a
variant does not build or disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

BWD = "fused_attention_bwd.cu"
FWD = "fused_attention_fwd.cu"
FLASH = "flash_attention_fwd.cu"
TF32 = "attention_tf32.cuh"
FWD_BODY = "attention_fwd_tf32.cuh"
BLOCKS = "constexpr int mma_bwd_min_blocks() { return DP <= 64 ? 4 : 2; }"
CHUNK = "constexpr int kChunk = 16;"
BWD_PRESPLIT = "constexpr bool tf32_bwd_presplit() { return DP <= 64; }"
TF32_TILE = "constexpr int kTf32Tile = 32;"
FWD_BLOCKS = "constexpr int tf32_min_blocks() { return DP <= 64 ? (FLASH ? 4 : 3) : 2; }"
DKDV_BLOCKS = "kTf32BwdBlocks)\n    fused_attention_bwd_dkdv_tf32_kernel"
Q_REGS = "constexpr bool tf32_q_regs() { return DP <= (FLASH ? 32 : 64); }"
ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
CVT_RNA = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
           "  return r;")
# the forward's K and V tiles split once where they land (hi plane, lo plane
# kPlane floats on), at the cost of a barrier a tile and twice the planes
FWD_LANDS = [
    (FWD_BODY, "float* buf = kv + (t & 1) * 2 * kPlane;", "float* buf = kv + (t & 1) * 4 * kPlane;"),
    (FWD_BODY, "load_tile_f32<DP, kTile>(buf + kPlane, v,", "load_tile_f32<DP, kTile>(buf + 2 * kPlane, v,"),
    (FWD_BODY, "    float* ks = kv + (t & 1) * 2 * kPlane;\n",
     "    float* ks = kv + (t & 1) * 4 * kPlane;\n    split_tile<DP, kTile, kPlane>(ks);\n"
     "    split_tile<DP, kTile, kPlane>(ks + 2 * kPlane);\n    __syncthreads();\n"),
    (FWD_BODY, "tile_scores_f32<DP, kTile, kQRegs, kPartial, 0, 0>(",
     "tile_scores_f32<DP, kTile, kQRegs, kPartial, 0, kPlane>("),
    (FWD_BODY, "tile_pv_f32<DP, kTile, kPartial, 0>(acc, s, ks + kPlane,",
     "tile_pv_f32<DP, kTile, kPartial, kPlane>(acc, s, ks + 2 * kPlane,"),
    (FWD_BODY, "(kMmaRows + 4 * kTf32Tile)", "(kMmaRows + 8 * kTf32Tile)"),
]
# variant -> [(file, old text, new text)]
VARIANTS = {
    "as committed": [],
    "32-wide chunks": [(BWD, CHUNK, CHUNK.replace("16", "32"))],
    "bf16 3 blocks an SM": [(BWD, BLOCKS, BLOCKS.replace("4 : 2", "3 : 2"))],
    "fp32 backward split on read": [
        (TF32, BWD_PRESPLIT, BWD_PRESPLIT.replace("DP <= 64", "false"))],
    "fp32 64-key tiles": [(TF32, TF32_TILE, TF32_TILE.replace("= 32", "= 64"))],
    "fp32 split by cvt.rna": [(TF32, ROUND, CVT_RNA)],
    "fp32 dK/dV 3 blocks an SM": [(BWD, DKDV_BLOCKS, DKDV_BLOCKS.replace("kTf32BwdBlocks", "3"))],
    # up to DP = 64 the fused forward holds Q's fragments in registers at
    # three blocks an SM, the flash forward reads them from shared memory at
    # four; these variants set both kernels alike
    "fp32 forward 3 blocks an SM": [(FWD_BODY, FWD_BLOCKS, FWD_BLOCKS.replace("(FLASH ? 4 : 3)", "3"))],
    "fp32 forward 4 blocks an SM": [(FWD_BODY, FWD_BLOCKS, FWD_BLOCKS.replace("(FLASH ? 4 : 3)", "4"))],
    "fp32 forward 2 blocks an SM": [(FWD_BODY, FWD_BLOCKS, FWD_BLOCKS.replace("(FLASH ? 4 : 3)", "2"))],
    "fp32 forward Q from shared memory": [
        (FWD_BODY, Q_REGS, Q_REGS.replace("(FLASH ? 32 : 64)", "32"))],
    "fp32 forward Q in registers, 3 blocks an SM": [
        (FWD_BODY, Q_REGS, Q_REGS.replace("(FLASH ? 32 : 64)", "64")),
        (FWD_BODY, FWD_BLOCKS, FWD_BLOCKS.replace("(FLASH ? 4 : 3)", "3"))],
    "fp32 forward Q from shared memory, 4 blocks an SM": [
        (FWD_BODY, Q_REGS, Q_REGS.replace("(FLASH ? 32 : 64)", "32")),
        (FWD_BODY, FWD_BLOCKS, FWD_BLOCKS.replace("(FLASH ? 4 : 3)", "4"))],
    "fp32 forward split where tiles land": FWD_LANDS,
}
FWD_TIMED = [(8, 12, 197, 64, False), (32, 12, 197, 64, False), (64, 12, 197, 64, False),
             (8, 8, 77, 64, True), (32, 8, 77, 64, True)]
# the fp32 flash forward: the ViT-L-14-336 and ViT-B-16@384 vision calls
FLASH_TIMED = [(32, 16, 577, 64, False), (32, 12, 577, 64, False)]


def build_variants(native, out_dir: Path, names) -> dict:
    """{variant: {source: path of its library}}; prints ptxas lines per kernel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        src_dir = out_dir / f"variant{i}"
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(native.CSRC_DIR, src_dir)
        for file, old, new in VARIANTS[name]:
            path = src_dir / file
            text = path.read_text()
            if old not in text:
                cs.fail(f"variant {name!r}: {old!r} is not in {file}")
            path.write_text(text.replace(old, new))
        for source in (FWD, BWD, FLASH):
            lib = src_dir / f"{Path(source).stem}.so"
            cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(src_dir / source)]
            procs[(name, source)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (name, source), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {name!r} did not build {source}:\n{log}")
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = cs._kernel_name(entry.group(1))
            elif ("mma_kernel" in kernel or "tf32_kernel" in kernel) and (
                    "registers" in line or "spill" in line):
                print(f"  ptxas[{name}] {kernel}: {line.strip()}", flush=True)
        libs.setdefault(name, {})[source] = lib
    return libs


def sass_census(native, libs) -> None:
    """Static SASS instruction counts of the committed build's fp32 and bf16
    tensor-core kernels at DP = 64 (``cuobjdump -sass``): the opcodes that
    make up each unrolled kernel, the mma (HMMA) among them."""
    cuobjdump = Path(native._nvcc()).with_name("cuobjdump")
    for source, lib in libs["as committed"].items():
        out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                             text=True).stdout
        for block in out.split("Function : ")[1:]:
            name = cs._kernel_name(block.split(None, 1)[0])
            if not re.search(r"(tf32|mma)_kernel<64>", name):
                continue
            ops = {}
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", block):
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
            print(f"sass {name}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in top), flush=True)


def bind_bwd(path: Path):
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
            k.shape[2], d, float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_attention_bwd launch failed ({err})")
        return dq, dk, dv

    return bwd


def bind_fwd(path: Path, name: str = "fused_attention_fwd"):
    """The forward entry ``name`` (``fused_attention_fwd`` or
    ``flash_attention_fwd``: one signature) of a built library."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = getattr(lib, name)
    entry.argtypes = [p] * 4 + [i, i, i, i, ctypes.c_float, i, i, p]
    entry.restype = i

    def fwd(q, k, v, scale, causal):
        import torch

        out = torch.empty_like(q)
        b, h, lq, d = q.shape
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, k.shape[2], d,
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed ({err})")
        return out

    return fwd


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
        found = re.search(r"fused_attention_bwd_(dq|dkdv)_", e.key)
        if found:
            total = getattr(e, "device_time_total", None) or e.cuda_time_total
            out[found.group(1)] = out.get(found.group(1), 0.0) + total / calls / 1e3
    return out


def main() -> None:
    import torch

    from refining_clip_via_dinov2_representations_torch.ops import native
    from refining_clip_via_dinov2_representations_torch.ops.flash_attention import (
        flash_attention_reference,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd_reference, fused_attention_fwd, fused_attention_reference,
    )

    args = [a for a in sys.argv[1:] if a != "--forward"]
    names = ["as committed"] + [n for n in args if n != "as committed"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        cs.fail(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if not args:
        names = list(VARIANTS)
    cs.phase_device()
    libs = build_variants(native, native.BUILD_DIR.parent / "tune_bwd", names)
    sass_census(native, libs)
    bad = 0
    for dtype in () if "--forward" in sys.argv else (torch.bfloat16, torch.float32):
        name_t = str(dtype).split(".")[-1]
        for b, h, l, d, causal in cs.TRAIN_CASES:
            q, k, v = cs._qkv(b, h, l, d, dtype, seed=200)
            do = cs._qkv(b, h, l, d, dtype, seed=201)[0]
            scale = d ** -0.5
            o = fused_attention_fwd(q, k, v, scale, causal)
            want = fused_attention_bwd_reference(q, k, v, o, do, scale, causal)
            largest = max(w.float().abs().max().item() for w in want)
            for name in names:
                bwd = bind_bwd(libs[name][BWD])
                got = bwd(q, k, v, o, do, scale, causal)
                torch.cuda.synchronize()
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                ok = err <= cs.BWD_REL_TOL[name_t] * largest
                bad += not ok
                ms = cs.time_ms(lambda: bwd(q, k, v, o, do, scale, causal), iters=20)
                split = kernel_ms(lambda: bwd(q, k, v, o, do, scale, causal))
                print(f"variant {name!r} backward {name_t} [{b},{h},{l},{d}] causal={causal}: "
                      f"{ms:.4f} ms (dq {split.get('dq', 0):.4f}, dkdv {split.get('dkdv', 0):.4f} "
                      f"ms by the profiler), max_abs_err {err:.3e} vs plain, largest |grad| "
                      f"{largest:.3e} {'ok' if ok else 'MISMATCH'} [{cs.CARD}]", flush=True)
    for b, h, l, d, causal in FWD_TIMED:
        q, k, v = cs._qkv(b, h, l, d, torch.float32, seed=100)
        scale = d ** -0.5
        want = fused_attention_reference(q, k, v, scale, causal)
        for name in names:
            fwd = bind_fwd(libs[name][FWD])
            got = fwd(q, k, v, scale, causal)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = err <= cs.TOL["float32"]
            bad += not ok
            ms = cs.time_ms(lambda: fwd(q, k, v, scale, causal))
            print(f"variant {name!r} forward float32 [{b},{h},{l},{d}] causal={causal}: "
                  f"{ms:.4f} ms, max_abs_err {err:.3e} vs plain {'ok' if ok else 'MISMATCH'} "
                  f"[{cs.CARD}]", flush=True)
    for b, h, l, d, causal in FLASH_TIMED:
        q, k, v = cs._qkv(b, h, l, d, torch.float32, seed=500)
        scale = d ** -0.5
        want = flash_attention_reference(q, k, v, scale, causal)
        for name in names:
            fwd = bind_fwd(libs[name][FLASH], "flash_attention_fwd")
            got = fwd(q, k, v, scale, causal)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = err <= cs.TOL["float32"]
            bad += not ok
            ms = cs.time_ms(lambda: fwd(q, k, v, scale, causal), iters=20)
            print(f"variant {name!r} flash float32 [{b},{h},{l},{d}] causal={causal}: "
                  f"{ms:.4f} ms, max_abs_err {err:.3e} vs plain {'ok' if ok else 'MISMATCH'} "
                  f"[{cs.CARD}]", flush=True)
    print(f"tune: {bad} variant case(s) disagree", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
