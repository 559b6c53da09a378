"""Host-side native cores: the CLIP BPE merge loop and a DCT-scaled JPEG
decoder, in C++ behind a plain C interface loaded with ``ctypes``.

The port's own copy of the JAX package's ``native/`` (its two ``.cpp``
files, copied beside this module). Each source is compiled with ``g++`` at
first use into ``build/host_native/`` at the root of the checkout, named by
a hash of the source, the flags and the platform, so an edited source
builds anew and no stale binary is loaded. The directory must belong to
the current user and be writable by no one else, or nothing is loaded from
it.

* ``NativeBPE(merges, vocab).encode_word(mapped)``: the ids of one
  byte-mapped word. Each call writes into a buffer of its own thread, so
  loader threads sharing one ``NativeBPE`` never see each other's ids
  (the JAX wrapper shares one buffer between threads).
* ``decode_jpeg(data, target_min)``: RGB uint8 ``[H, W, 3]``, decoded by
  libjpeg at the smallest M/8 scale whose shortest edge is still at least
  ``target_min``; None where the library did not build (no libjpeg
  headers: logged once at warning), for a stream that is not a JPEG, CMYK,
  truncated or corrupt. The caller then decodes with PIL.

Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
BPE_SOURCE = SRC_DIR / "bpe_tokenizer.cpp"
JPEG_SOURCE = SRC_DIR / "jpeg_decoder.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}  # source name -> CDLL, or None after a failed build


def _cache_dir() -> Path:
    BUILD_DIR.mkdir(mode=0o700, parents=True, exist_ok=True)
    st = BUILD_DIR.stat()
    if st.st_uid != os.getuid() or st.st_mode & 0o022:
        raise RuntimeError(f"native build directory {BUILD_DIR} is not owned by the current "
                           "user alone; refusing to load shared objects from it")
    return BUILD_DIR


def library_path(src: Path, libs: Sequence[str] = ()) -> Path:
    key = src.read_bytes() + " ".join((*CXX_FLAGS, *libs, platform.platform())).encode()
    return _cache_dir() / f"{src.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(src: Path, libs: Sequence[str]) -> Tuple[Optional[Path], str]:
    """(path of the built library or None, g++'s output)."""
    out = library_path(src, libs)
    if out.exists():
        return out, ""
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp), *libs],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return None, repr(e)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent builder never sees a partial file
    return out, proc.stderr


def _load(src: Path, libs: Sequence[str], declare) -> Optional[ctypes.CDLL]:
    with _lock:
        if src.name in _libs:
            return _libs[src.name]
        path, log = _build(src, libs)
        lib = None
        if path is None:
            logging.warning("native %s did not build (%s); the Python path runs instead",
                            src.name, log.strip().splitlines()[-1] if log.strip() else "g++")
        else:
            try:
                lib = ctypes.CDLL(str(path))
                declare(lib)
            except OSError as e:  # e.g. a library another machine built
                logging.warning("native %s did not load (%s); the Python path runs instead",
                                src.name, e)
                lib = None
        _libs[src.name] = lib
        return lib


def _declare_bpe(lib: ctypes.CDLL) -> None:
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.bpe_encode_word.restype = ctypes.c_int
    lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    lib.rcd_jpeg_decode.restype = ctypes.c_int
    lib.rcd_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.rcd_jpeg_free.restype = None
    lib.rcd_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]


def load_native() -> Optional[ctypes.CDLL]:
    """The BPE core (built first if needed), or None where ``g++`` fails."""
    return _load(BPE_SOURCE, (), _declare_bpe)


def load_native_jpeg() -> Optional[ctypes.CDLL]:
    """The JPEG decoder (built first if needed, linked to libjpeg), or None
    where it does not build."""
    return _load(JPEG_SOURCE, ("-ljpeg",), _declare_jpeg)


def jpeg_decoder() -> str:
    """Which decoder ``apply_bytes`` reaches for JPEGs: ``"native"`` or
    ``"PIL"``."""
    return "native" if load_native_jpeg() is not None else "PIL"


class NativeBPE:
    """The C++ BPE core over one vocabulary. ``encode_word`` is safe to call
    from many threads at once: each thread writes into its own buffer, and
    the core's memo takes a lock."""

    MAX_IDS = 1024

    def __init__(self, merges: Sequence[Tuple[str, str]], vocab_tokens: Sequence[str]):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native BPE unavailable: g++ did not build "
                               f"{BPE_SOURCE.name}")
        self._lib = lib
        merges_blob = "\n".join(" ".join(m) for m in merges).encode("utf-8")
        vocab_blob = "\n".join(vocab_tokens).encode("utf-8")
        self._handle = lib.bpe_create(merges_blob, vocab_blob)
        self._local = threading.local()

    def encode_word(self, mapped_word: str) -> List[int]:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = self._local.buf = (ctypes.c_int32 * self.MAX_IDS)()
        n = self._lib.bpe_encode_word(self._handle, mapped_word.encode("utf-8"), buf,
                                      self.MAX_IDS)
        if n < 0:
            raise ValueError("word produced too many tokens")
        return buf[:n]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_destroy(handle)
            self._handle = None


def decode_jpeg(data: bytes, target_min: int = 0) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 ``[H, W, 3]`` RGB, DCT-downscaled so that the
    shortest edge is the smallest M/8 multiple still ``>= target_min``
    (``target_min <= 0``: full size); None where the decoder did not build
    or the stream is not one it takes (the caller decodes with PIL)."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        return None
    lib = load_native_jpeg()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_ubyte)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.rcd_jpeg_decode(data, len(data), int(target_min), ctypes.byref(out),
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.rcd_jpeg_free(out)
