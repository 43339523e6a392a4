"""Precomputed frozen-encoder tables for stage-1/2 training.

Counterpart of neurons_tpu/data/precompute.py. The reference runs its
frozen encoders inside the train loop every epoch (a CLIP-bigG forward and
a VAE encode per batch, the class-name text embeds); the JAX package runs
each frozen tower once ahead of training and streams the tables from
disk, and so does the port. This module writes:

  clip_targets_{split}.npy   [N, F, 256, 1664] fp16   (vision tokens)
  vae_latents_{split}.npy    [N, F, 4, h/8, w/8] fp16 (scaled latents)
  class_text_embeds.npy      [51, 1280] fp32          (CLS_DICT names)

Tables are written incrementally through np.lib.format.open_memmap, so a
4320-clip table never resides in RAM. The tail batch is padded with its
last frame up to `batch_size`, as the JAX package pads it, so every tower
call has one shape. The callables are torch functions: each takes a host
f32 tensor and returns a tensor (on any device); they run under
`torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from neurons_tpu_torch.data.categories import CLS_DICT

TensorFn = Callable[[torch.Tensor], torch.Tensor]


def _memmap(path: str, shape, dtype=np.float16):
    return np.lib.format.open_memmap(path, mode="w+", shape=tuple(shape),
                                     dtype=dtype)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _batches(images: np.ndarray, batch_size: int):
    """(start, stop, f32 batch of `batch_size` frames, padded with the last
    frame) over the [N, F, ...] images flattened to frames."""
    n, f = images.shape[:2]
    flat = images.reshape((n * f,) + images.shape[2:])
    for start in range(0, n * f, batch_size):
        stop = min(start + batch_size, n * f)
        batch = np.asarray(flat[start:stop], np.float32)
        if stop - start < batch_size:  # one shape: pad the tail
            pad = batch_size - (stop - start)
            batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)])
        yield start, stop, torch.from_numpy(batch)


@torch.inference_mode()
def precompute_clip_targets(images: np.ndarray, vision_tokens: TensorFn,
                            out_path: str, batch_size: int = 16,
                            log_every: int = 50) -> str:
    """images [N, F, 3, H, W] in [0, 1]; `vision_tokens` maps a
    [B, 3, H, W] batch to [B, 256, 1664] CLIP-bigG tokens."""
    n, f = images.shape[:2]
    probe = _host(vision_tokens(torch.from_numpy(
        np.asarray(images[:1, 0], np.float32))))
    table = _memmap(out_path, (n, f) + probe.shape[1:])
    rows = table.reshape((n * f,) + table.shape[2:])
    for start, stop, batch in _batches(images, batch_size):
        out = _host(vision_tokens(batch))[: stop - start]
        rows[start:stop] = out.astype(np.float16)
        if (start // batch_size) % log_every == 0:
            print(f"clip targets {stop}/{n * f}", flush=True)
    table.flush()
    return out_path


@torch.inference_mode()
def precompute_vae_latents(images: np.ndarray, vae_encode_mode: TensorFn,
                           out_path: str, scale: float = 0.18215,
                           batch_size: int = 16) -> str:
    """images [N, F, 3, H, W] in [0, 1]; encodes (2x - 1) through the VAE
    posterior mode and scales it (the reference's training latents)."""
    n, f = images.shape[:2]
    probe = _host(vae_encode_mode(torch.from_numpy(
        np.asarray(images[:1, 0], np.float32) * 2 - 1)))
    table = _memmap(out_path, (n, f) + probe.shape[1:])
    rows = table.reshape((n * f,) + table.shape[2:])
    for start, stop, batch in _batches(images, batch_size):
        z = _host(vae_encode_mode(batch * 2 - 1))[: stop - start] * scale
        rows[start:stop] = z.astype(np.float16)
    table.flush()
    return out_path


@torch.inference_mode()
def precompute_class_text_embeds(
        text_pooled: TensorFn,
        tokenize: Callable[[Sequence[str]], np.ndarray],
        out_path: str,
        class_names: Optional[Sequence[str]] = None) -> str:
    """Pooled CLIP text embeds of the 51 concept names (CLS_DICT, the
    reference's class table)."""
    names = list(class_names) if class_names is not None else [
        CLS_DICT[i] for i in sorted(CLS_DICT)]
    toks = torch.from_numpy(np.asarray(tokenize(names), np.int64))
    emb = _host(text_pooled(toks))
    np.save(out_path, emb.astype(np.float32))
    return out_path
