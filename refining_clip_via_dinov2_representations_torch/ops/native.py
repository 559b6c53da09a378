"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Libraries are cached in
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew. Nothing is compiled when a module is
imported: the package imports on machines without ``nvcc`` or a GPU, where
only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("fused_attention_fwd.cu", "fused_attention_bwd.cu", "flash_attention_fwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# source name -> nvcc's output of its last build here (ptxas reports each
# kernel's registers, shared memory and spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on a machine with "
        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / name
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{src.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source that has no cached library, one ``nvcc``
    process per source, all started together. Returns the seconds each
    build took (0.0 for a cache hit); raises with nvcc's output on failure."""
    names = list(names)
    started = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
