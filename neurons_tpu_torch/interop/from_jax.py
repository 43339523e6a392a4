"""Carry a flax parameter tree of the JAX package into a port module.

The port's modules use the flax submodule names as attribute names
(`to_q`, `in_norm`, `block_0`, `mid_attn`, flax's automatic `Dense_0` and
`LayerNorm_0`, ...), so one generic walk fills them:

  Dense  kernel [in, out]        -> Linear.weight [out, in]
  Conv   kernel HWIO             -> Conv2d.weight OIHW
  Conv   kernel DHWIO (3-D)      -> Conv3d.weight OIDHW
  norm   scale                   -> weight
  Embed  embedding               -> weight
  any other leaf (bias, raw `self.param` leaves such as `null_kv`, `g`,
  `wte`)                         -> the parameter of the same name

The walk is strict: a port parameter left unfilled, a JAX leaf left unused
or a shape that differs raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _target(module: nn.Module, key: str, arr: np.ndarray):
    """(port parameter name, array in the port's layout) for one leaf."""
    if key == "kernel":
        if isinstance(module, nn.Linear):
            return "weight", arr.T
        if isinstance(module, nn.Conv2d):
            return "weight", arr.transpose(3, 2, 0, 1)
        if isinstance(module, nn.Conv3d):
            return "weight", arr.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"a flax kernel maps to no parameter of "
                         f"{type(module).__name__}")
    if key in ("scale", "embedding"):
        return "weight", arr
    return key, arr


def _walk(module: nn.Module, params: Mapping, unused: list):
    """Yield (port parameter name, parameter, array in the port's layout)
    for every leaf of `params` that names a parameter of `module`; leaves
    that name none go to `unused`. Shapes must agree."""
    names = {id(p): n for n, p in module.named_parameters()}

    def walk(mod: nn.Module, tree: Mapping, prefix: str):
        for key, val in tree.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                child = mod._modules.get(key)
                if child is None:
                    unused.append(path + "/...")
                else:
                    yield from walk(child, val, path + "/")
                continue
            arr = np.asarray(val)
            if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            jax_shape = arr.shape
            name, arr = _target(mod, key, arr)
            param = mod._parameters.get(name)
            if param is None:
                unused.append(path)
                continue
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{path}: JAX shape {jax_shape} (as "
                                 f"{tuple(arr.shape)} in the port's layout) "
                                 f"!= port shape {tuple(param.shape)}")
            yield names[id(param)], param, arr

    yield from walk(module, params, "")


def load_jax_params(module: nn.Module, params: Mapping,
                    strict: bool = True) -> int:
    """Fill the parameters of `module` from `params`, the flax "params"
    tree as nested dicts of numpy arrays (each cast to the parameter's
    dtype on its device). Strict: every parameter filled and every leaf
    used, else this raises; `strict=False` is the JAX package's
    `restore_into` layering (parameters the tree lacks keep their values,
    leaves the module lacks are dropped). Returns how many were filled."""
    expected = {id(p): name for name, p in module.named_parameters()}
    filled = set()
    unused: list = []
    for _, param, arr in _walk(module, params, unused):
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        filled.add(id(param))
    missing = sorted(name for pid, name in expected.items()
                     if pid not in filled)
    if strict and (missing or unused):
        raise ValueError(f"load_jax_params: port parameters left unfilled "
                         f"{missing}; JAX leaves left unused {unused}")
    return len(filled)


def jax_named_tensors(module: nn.Module, params: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """{port parameter name: CPU f32 tensor} of the leaves of `params`
    that name a parameter of `module` (which may live on the meta
    device): a partial flax tree as an overlay of the port's names."""
    return {name: torch.from_numpy(np.ascontiguousarray(arr))
            for name, _, arr in _walk(module, params, [])}
