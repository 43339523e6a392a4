"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use into `_build/lib<name>-<digest>.so` beside the package (the
directory is listed in .gitignore). The digest is that of the source, the
shared headers `csrc/*.cuh` and the flags, so an edited source or header
builds anew and a stale library is never
loaded. Nothing is built at import time: this module only runs nvcc when a
kernel is first launched, or when `build` is called to start several
builds at once.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A kernel wrapper's launches, in total and by shape key (and, for a
    wrapper with several kernels, by (route, key)); the wrapper adds one
    where it launches its kernel, and nowhere else."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0
        self.by_shape = collections.Counter()
        self.by_route = collections.Counter()

    def add(self, key, route=None):
        self.total += 1
        self.by_shape[key] += 1
        if route is not None:
            self.by_route[(route, key)] += 1


def on_device(device):
    """A context that makes `device` current for a launch: nothing when it
    already is (the usual case, which costs no context switch a call)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the port's CUDA kernels are "
                       "built from source on first use")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # every shared header too: an edited header rebuilds each source
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (registers, shared memory, spills per kernel)."""
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source that has no current library, one nvcc
    process per source, all started together. Raises on any failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(log_path(name), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          f"{log_path(name).read_text()[-4000:]}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
