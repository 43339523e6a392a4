"""ctypes binding to the repository's native host-IO runtime
(native/neurons_io.cpp): the threaded GIF codec and the thread-pooled
pread.

Counterpart of neurons_tpu/native_io.py. The library is compiled on first
use with g++ and the flags of native/Makefile into
`neurons_tpu_torch/_build/libneurons_io-<digest>.so` (git-ignored), keyed
by the digest of the source and the flags as ops/cuda_build.py keys the
CUDA libraries; nothing is written into native/. Without a compiler every
entry point returns None and the callers take their Python fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "neurons_io.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libneurons_io-{digest[:12]}.so"


def _build() -> Optional[Path]:
    """The library for the current source, compiled if missing; None when
    the source or the compiler is missing or the compile fails."""
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gif_encode.restype = ctypes.c_int
        lib.gif_encode.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64)]
        lib.gif_decode.restype = ctypes.c_int
        lib.gif_decode.argtypes = [
            u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.neurons_free.restype = None
        lib.neurons_free.argtypes = [ctypes.c_void_p]
        lib.parallel_read.restype = ctypes.c_int
        lib.parallel_read.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(u8p),
            ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def encode_gif(frames: np.ndarray, delay_ms: int = 125,
               threads: int = 8) -> Optional[bytes]:
    """frames [F, H, W, 3] uint8 -> GIF bytes, or None if native missing."""
    lib = _load()
    if lib is None:
        return None
    f = np.ascontiguousarray(frames, dtype=np.uint8)
    if f.ndim != 4 or f.shape[-1] != 3:
        raise ValueError(f"frames must be [F, H, W, 3], got {f.shape}")
    n, h, w, _ = f.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.gif_encode(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        int(delay_ms), threads, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.neurons_free(out)


def decode_gif(data: bytes) -> Optional[np.ndarray]:
    """GIF bytes -> [F, H, W, 3] uint8, or None on unsupported input."""
    lib = _load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.gif_decode(buf, len(data), ctypes.byref(n), ctypes.byref(h),
                        ctypes.byref(w), None)
    if rc != 0 or n.value <= 0:
        return None
    out = np.empty((n.value, h.value, w.value, 3), np.uint8)
    rc = lib.gif_decode(buf, len(data), ctypes.byref(n), ctypes.byref(h),
                        ctypes.byref(w), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out


def parallel_read(paths: Sequence[str], offsets: Sequence[int],
                  sizes: Sequence[int], threads: int = 8
                  ) -> Optional[List[np.ndarray]]:
    """Thread-pooled pread of byte ranges -> list of uint8 arrays, or None
    if the native library is unavailable or a read failed."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    bufs = [np.empty(int(s), np.uint8) for s in sizes]
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_off = (ctypes.c_int64 * n)(*[int(o) for o in offsets])
    c_sz = (ctypes.c_int64 * n)(*[int(s) for s in sizes])
    c_dst = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    if lib.parallel_read(c_paths, c_off, c_sz, c_dst, n, threads):
        return None
    return bufs
