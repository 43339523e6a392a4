"""Helpers shared by the tests/test_torch_port_*.py parity tests.

JAX parameter trees are initialised at tiny configs, then every leaf is
overwritten with seeded numpy values: zero-initialised heads (UNet
out_conv, transformer proj_out) and unit/zero norms would otherwise make
the comparisons vacuous. Both sides then run in f32 on the CPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# native/Makefile's compile of the JAX package's codec (CXXFLAGS, -shared)
JAX_NATIVE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
                    "-shared")


def randomize(params, seed: int):
    """Nested dict of numpy f32 arrays, every leaf drawn anew. `params`
    may hold arrays or shape structs (`jax.eval_shape` of an init)."""
    rng = np.random.default_rng(seed)

    def fill(name, leaf):
        shape = tuple(leaf.shape)
        if name == "bias":
            return 0.1 * rng.standard_normal(shape, dtype=np.float32)
        if name in ("scale", "g"):
            return 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        if len(shape) <= 1:
            return 0.5 + 0.25 * rng.standard_normal(shape, dtype=np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(fan_in)))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) or hasattr(v, "items")
                else fill(k, v) for k, v in tree.items()}

    return walk(params)


def t(x) -> torch.Tensor:
    """numpy/JAX array -> f32 (or integer) CPU tensor."""
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _whole_elf(path: Path) -> bool:
    """Whether `path` is a whole 64-bit ELF file: the magic, and the file
    reaching the end of its section header table (a linker writing the
    file in place writes that table, and the header naming it, last)."""
    try:
        data = path.read_bytes()
    except OSError:
        return False
    if len(data) < 64 or data[:4] != b"\x7fELF" or data[4] != 2:
        return False
    shoff = int.from_bytes(data[0x28:0x30], "little")
    shentsize = int.from_bytes(data[0x3A:0x3C], "little")
    shnum = int.from_bytes(data[0x3C:0x3E], "little")
    return shoff > 0 and len(data) >= shoff + shentsize * shnum


def ensure_jax_native_io() -> Optional[str]:
    """Make the JAX package's native codec library (native/libneurons_io.so,
    its own git-ignored build product) whole and loadable before this
    process's next call into `neurons_tpu.native_io`; None when it loads,
    else why not.

    `neurons_tpu.native_io` runs `make -C native` when the library is
    missing, and make links straight onto it: another test worker can find
    the file half written, fail to load it and cache that failure for its
    process, so its GIFs come from imageio instead. Here, under an
    exclusive lock on the codec's source (held by every test worker that
    calls this), a library that is not a whole ELF file is compiled anew
    with native/Makefile's flags to a temporary name and moved into place
    atomically, then loaded with ctypes; a failed load that the JAX module
    cached earlier in this process is cleared, so that its next call loads
    the library. Two workers that both run the JAX package's own make can
    still race; that is not repairable from here."""
    from neurons_tpu import native_io as jnative

    lib = Path(jnative._LIB_PATH)
    src = Path(jnative._NATIVE_DIR) / "neurons_io.cpp"
    why = None
    with open(src, "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _whole_elf(lib):
                cxx = shutil.which(os.environ.get("CXX", "g++"))
                if cxx is None:
                    why = "no C++ compiler to build native/libneurons_io.so"
                else:
                    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                    res = subprocess.run(
                        [cxx, *JAX_NATIVE_FLAGS, "-o", str(tmp), str(src)],
                        capture_output=True, text=True, timeout=300)
                    if res.returncode == 0:
                        os.replace(tmp, lib)
                    else:
                        tmp.unlink(missing_ok=True)
                        why = ("native/libneurons_io.so failed to compile: "
                               + res.stderr[-500:])
            if why is None:
                try:
                    ctypes.CDLL(str(lib))
                except OSError as e:
                    why = f"native/libneurons_io.so does not load: {e}"
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if why is None and jnative._lib is None:
        jnative._tried = False
    return why
