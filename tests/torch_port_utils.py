"""Helpers shared by the tests/test_torch_port_*.py parity tests.

JAX parameter trees are initialised at tiny configs, then every leaf is
overwritten with seeded numpy values: zero-initialised heads (UNet
out_conv, transformer proj_out) and unit/zero norms would otherwise make
the comparisons vacuous. Both sides then run in f32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


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
