"""The saved-artifact resize dialect: torchvision-0.16 bilinear.

Counterpart of neurons_tpu/ops/resize.py. The reference saves its stage-3
recons through `transforms.Resize((256, 256))` on a tensor under
torchvision 0.16, whose tensor default is `antialias=False`: plain
`F.interpolate(mode="bilinear", align_corners=False)` two-tap sampling.
SSIM and PSNR of the saved artifacts are computed after this resize, so
the taps must match it exactly.

Both semantics are dense separable weight matrices applied with two
matrix products (the same weight builders as the JAX package):

  resize_reference(x, (h, w))                 torchvision-0.16 tensor
                                              dialect (antialias=False)
  resize_reference(x, (h, w), antialias=True) the antialiased triangle
                                              filter (F.interpolate(...,
                                              antialias=True))
  resize_np(x, (h, w))                        the same taps on host numpy,
                                              two GEMMs, never a 3-operand
                                              einsum

This is not `pipelines/e2e.py:resize_linear`, the antialiased
`jax.image.resize(..., "linear")` glue of the bench and of stage 5's
inputs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _weights_noaa(in_size: int, out_size: int) -> np.ndarray:
    """Plain bilinear (align_corners=False, half-pixel centres): two taps
    at floor/ceil of src = (i + 0.5) * scale - 0.5, src clamped at 0."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        i0 = int(np.floor(src))
        i0 = min(i0, in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        w[i, i0] += 1.0 - frac
        w[i, i1] += frac
    return w


def _weights_aa(in_size: int, out_size: int) -> np.ndarray:
    """Antialiased bilinear, the triangle filter of torch's
    `_upsample_bilinear2d_aa`: support stretched by the downsampling
    factor, weights normalised per output pixel."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    support = max(scale, 1.0)
    invscale = 1.0 / max(scale, 1.0)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        t = (np.arange(lo, hi) - center + 0.5) * invscale
        taps = np.maximum(0.0, 1.0 - np.abs(t))
        s = taps.sum()
        if s > 0:
            w[i, lo:hi] = taps / s
    return w


@functools.lru_cache(maxsize=64)
def _weight_pair(in_h: int, in_w: int, out_h: int, out_w: int,
                 antialias: bool) -> Tuple[np.ndarray, np.ndarray]:
    fn = _weights_aa if antialias else _weights_noaa
    return (fn(in_h, out_h).astype(np.float32),
            fn(in_w, out_w).astype(np.float32))


def resize_np(x: np.ndarray, out_hw: Tuple[int, int],
              antialias: bool = False) -> np.ndarray:
    """Host-numpy twin of `resize_reference` (the same taps): resizes the
    trailing (H, W) axes with two GEMMs. A 3-operand einsum here is a
    nested loop over every (out, in) pair: 94 s for one [6,3,224,224] clip
    on the JAX package's host, against about 0.1 s for the pair."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    fn = _weights_aa if antialias else _weights_noaa
    wh, ww = fn(in_h, out_h), fn(in_w, out_w)
    y = (wh @ x.astype(np.float32)) @ ww.T
    return y.astype(x.dtype)


def resize_reference(x: torch.Tensor, out_hw: Tuple[int, int],
                     antialias: bool = False) -> torch.Tensor:
    """Resize the trailing (H, W) axes of `x` with the reference's torch
    semantics (see the module docstring), in f32 on `x`'s device; returns
    the input dtype."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh, ww = _weight_pair(in_h, in_w, out_h, out_w, bool(antialias))
    wh = torch.from_numpy(wh).to(x.device)
    ww = torch.from_numpy(ww).to(x.device)
    y = torch.matmul(torch.matmul(wh, x.float()), ww.T)
    return y.to(x.dtype)
