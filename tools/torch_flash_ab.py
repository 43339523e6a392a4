#!/usr/bin/env python3
"""Time two checkouts' flash-attention forward (#1/#2/#3), flash-attention
backward (#4/#5), temporal attention (#6), GroupNorm+SiLU (#7) and
GroupNorm+SiLU+3x3-conv kernel (#8) on one CUDA card, in turns, at every
shape the main paths launch.

    python3 tools/torch_flash_ab.py OTHER_ROOT [--only flash,f32,bwd,conv,temporal,gnsilu] [--json PATH]

OTHER_ROOT is a second checkout of the repository, e.g. the parent commit
unpacked with `git archive` into a directory that .gitignore lists. Each
checkout runs in its own process (it builds its own kernels), in the order
other, this, this, other. Shapes: the flash forward at every attention
shape of the full-width clip, of an SVD clip (its VideoUNet at d 64, its
VAE encoder and temporal decoder at d 512), of the fast clip's gated
steps and of a caption batch (bf16, no bias, no log-sum-exp) and at the
stage-2 step's training sites (with lse, and the prior's bias); the
forward's f32 (TF32) route ("f32") at every f32 shape of a path: stage 6's
three classifier shapes, the DecoderVideo's three sizes of the seg panel
(24 rows) and of the CLI's stage e (12 rows), the prior's f32 check
(bias and lse), validate's three most launched shapes (the host's
microseconds a call at three of these, the median of five runs), and
past d 128 the VAE's d 512 in f32: the autoencoder step's [4, 1, 1024,
1024, 512] with lse (the generator step) and without (the discriminator
step) and precompute's VAE encoder [16, 1, 784, 784, 512]; the backward
at the same four step sites (bf16, from the forward's out and lse, with
a random output gradient) and ("bwd") at the
autoencoder step's f32 d 512 and at the f32 stage-2 step's four sites
(the prior's bias; the DecoderVideo's three sizes; each with the host's
microseconds a call, the library's f32 backward alone and the bound at
the TF32 rate); #6 at the clip's four
motion-module levels
(bf16, 16 frames, 8 heads, no autograd) and at validate's eight (f32, the
CFG batch and one clip); #7 in bf16 (bf16 GroupNorm
parameters, as the bf16 models hold them) at every shape of the fused clip
and the fused step; #8 in bf16 at every shape of the fused clip.
Each shape gets two times, each the mean over 20 launches (5 at the
largest shapes) after a warm-up: on CUDA events around the launches (what
a caller waits, the host's launch cost included where it exceeds the
kernel's), and ("device") on CUDA events around the same launches queued
behind a kernel that keeps the card busy until the host has enqueued them
all (every launch of a call and the backward wrapper's own small kernels
included); for the backward also each of its kernels by name under
torch.profiler and, at the bf16 step sites, the library's backward alone
(autograd.grad of one scaled_dot_product_attention) by device time and
the bound (10 Tq Tk D at 989 TFLOP/s, or the bytes) beside the two
passes' exponentials, for #7 the library composite F.silu(F.group_norm(...))
by events, for #8 the library composite F.conv2d(F.silu(F.group_norm(
...))) by device time and the bound (2 M Cout 9 Cin at 989 TFLOP/s, or
x, the weights and y at 3.35 TB/s), and for the bf16 forward the
library's fused attention by device time (the backend it picks named on
a line of its own: flash attention takes no head dim past 256), the bound
and the exponentials' bound, at d 512 each kernel of the route by name
under torch.profiler (the key parts' combine apart), and at two shapes
the host's microseconds to enqueue one call (`host_us`). The
last lines give, per shape, each run's ms, and for each kernel the sum of
launches x ms over a clip (and a step) for each run; with --json the
whole record also goes to PATH.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import sdpa_backend  # noqa: E402

# (site, (B, H, Tq, Tk, D), launches a clip) of the unfused clip's flash
# forward (inference: no bias, no lse)
FLASH_CLIP = [
    ("unet self 48x48", (2, 10, 2304, 2304, 64), 380),
    ("unet cross 48x48", (2, 10, 2304, 256, 64), 380),
    ("unet self 24x24", (2, 20, 576, 576, 64), 2280),
    ("unet cross 24x24", (2, 20, 576, 256, 64), 2280),
    ("decoder 16x16", (6, 1, 256, 256, 128), 6),
    ("decoder 32x32", (6, 1, 1024, 1024, 64), 4),
    ("decoder 64x64", (6, 1, 4096, 4096, 32), 4),
    ("vae blurry 64x64", (1, 1, 4096, 4096, 512), 6),
    ("vae keyframe 96x96", (1, 1, 9216, 9216, 512), 1),
    ("unet3d self 32x32", (32, 8, 1024, 1024, 40), 175),
    ("unet3d self 16x16", (32, 8, 256, 256, 80), 175),
    ("vae 16 frames 32x32", (16, 1, 1024, 1024, 512), 2),
    ("vae keyframe 32x32", (1, 1, 1024, 1024, 512), 1),
]

# (site, (B, H, Tq, Tk, D), launches a path) of the other bf16 forward
# launches (inference): at d <= 128 an SVD clip's VideoUNet self-attention
# (14 frames, the CFG batch of 28 rows, 25 steps; `svd_launches` in
# chip_smoke.py), the fast clip's gated steps (the CFG batch collapsed to
# one clip; launches as chip_smoke.py's "max" fast clip counts them) and a
# caption batch's BLIP-2 vision tower (39 layers, heads of 88); at d 512
# an SVD clip's VAE attention
FLASH_OTHER = [
    ("svd 72x128", (28, 5, 9216, 9216, 64), {"svd clip": 125}),
    ("svd 36x64", (28, 10, 2304, 2304, 64), {"svd clip": 125}),
    ("svd 18x32", (28, 20, 576, 576, 64), {"svd clip": 125}),
    ("svd 9x16", (28, 20, 144, 144, 64), {"svd clip": 25}),
    ("unet self 48x48 gated", (1, 10, 2304, 2304, 64), {}),
    ("unet self 24x24 gated", (1, 20, 576, 576, 64), {}),
    ("unet3d self 32x32 gated", (16, 8, 1024, 1024, 40), {}),
    ("unet3d self 16x16 gated", (16, 8, 256, 256, 80), {}),
    ("blip2 vision 16x16+cls", (8, 16, 257, 257, 88), {"caption batch": 39}),
    # an SVD clip's d 512 launches: the VAE encoder's mid attention on the
    # conditioning frame, the temporal decoder's spatial one a chunk of 7
    ("svd vae encoder 72x128", (1, 1, 9216, 9216, 512), {"svd clip": 1}),
    ("svd decoder 7 frames 72x128", (7, 1, 9216, 9216, 512),
     {"svd clip": 2}),
]

# (site, (B, H, Tq, Tk, D, kv heads), bias shape, forward launches a step,
# backward launches a step) of the stage-2 step's flash attention (the
# forward with lse)
FLASH_STEP = [
    ("prior", (10, 32, 513, 514, 52, 1), (32, 513, 514), 6, 6),
    ("decoder 16x16", (60, 1, 256, 256, 128, 1), None, 12, 6),
    ("decoder 32x32", (60, 1, 1024, 1024, 64, 1), None, 8, 4),
    ("decoder 64x64", (60, 1, 4096, 4096, 32, 1), None, 8, 4),
]

# (site, (B, H, Tq, Tk, D, kv heads), bias shape, lse, {path: launches})
# of the flash forward's f32 route: a scored clip (stage 6), a seg panel
# and the stage e of a 2-clip CLI run (one DecoderVideo forward: 3 launches
# at 16 x 16, 2 at 32 x 32, 2 at 64 x 64), the prior's f32 check (lse, one
# a check), a validate run's three most launched shapes (13375 of its
# 16530 launches); past d 128, an autoencoder step pair (the VAE's two mid
# attentions: with lse in the generator step, without in the
# discriminator's) and precompute's VAE encoder (one a batch of 16 frames)
FLASH_F32 = [
    ("vit-b frame", (1, 12, 197, 197, 64, 12), None, False,
     {"scored clip": 288}),
    ("videomae 6 frames", (1, 12, 588, 588, 64, 12), None, False,
     {"scored clip": 48}),
    ("clip vit-l 6 frames", (6, 16, 257, 257, 64, 16), None, False,
     {"scored clip": 24}),
    ("decoder 16x16 panel", (24, 1, 256, 256, 128, 1), None, False,
     {"panel": 3}),
    ("decoder 32x32 panel", (24, 1, 1024, 1024, 64, 1), None, False,
     {"panel": 2}),
    ("decoder 64x64 panel", (24, 1, 4096, 4096, 32, 1), None, False,
     {"panel": 2}),
    ("decoder 16x16 stage e", (12, 1, 256, 256, 128, 1), None, False,
     {"stage e": 3}),
    ("decoder 32x32 stage e", (12, 1, 1024, 1024, 64, 1), None, False,
     {"stage e": 2}),
    ("decoder 64x64 stage e", (12, 1, 4096, 4096, 32, 1), None, False,
     {"stage e": 2}),
    ("prior (train)", (10, 32, 513, 514, 52, 1), (32, 513, 514), True,
     {"prior check": 1}),
    ("validate 2x20x256", (2, 20, 256, 256, 64, 20), None, False,
     {"validate run": 12120}),
    ("validate 2x10x1024", (2, 10, 1024, 1024, 64, 10), None, False,
     {"validate run": 1010}),
    ("validate 32x8x1024 d40", (32, 8, 1024, 1024, 40, 8), None, False,
     {"validate run": 245}),
    ("vae d512 ae (lse)", (4, 1, 1024, 1024, 512, 1), None, True,
     {"ae step pair": 2}),
    ("vae d512 ae", (4, 1, 1024, 1024, 512, 1), None, False,
     {"ae step pair": 2}),
    ("vae d512 encoder 16 frames", (16, 1, 784, 784, 512, 1), None, False,
     {"precompute batch": 1}),
]

# (site, (B, H, Tq, Tk, D, kv heads), bias shape, {path: launches}) of the
# flash backward on f32: past d 128 the autoencoder's generator step; up to
# d 128 the f32 stage-2 step (bf16_autocast off: the prior and the
# DecoderVideo's three sizes, the launches of STEP_LAUNCHES)
FLASH_BWD_F32 = [
    ("vae d512 ae", (4, 1, 1024, 1024, 512, 1), None, {"ae step pair": 2}),
    ("prior", (10, 32, 513, 514, 52, 1), (32, 513, 514), {"f32 step": 6}),
    ("decoder 16x16", (60, 1, 256, 256, 128, 1), None, {"f32 step": 6}),
    ("decoder 32x32", (60, 1, 1024, 1024, 64, 1), None, {"f32 step": 4}),
    ("decoder 64x64", (60, 1, 4096, 4096, 32, 1), None, {"f32 step": 4}),
]

# ((N, Cin, H, W, Cout), launches a fused clip) of #8, 32 groups
CONV_CLIP = [
    ((2, 320, 48, 48, 640), 38), ((2, 320, 96, 96, 4), 38),
    ((2, 320, 96, 96, 320), 266), ((2, 640, 24, 24, 1280), 38),
    ((2, 640, 48, 48, 640), 228), ((2, 640, 96, 96, 320), 76),
    ((2, 960, 48, 48, 640), 38), ((2, 960, 96, 96, 320), 38),
    ((2, 1280, 24, 24, 1280), 380), ((2, 1280, 48, 48, 640), 38),
    ((2, 1920, 24, 24, 1280), 38), ((2, 1920, 48, 48, 640), 38),
    ((2, 2560, 24, 24, 1280), 76), ((32, 320, 16, 16, 640), 50),
    ((32, 320, 32, 32, 320), 275), ((32, 640, 8, 8, 1280), 50),
    ((32, 640, 16, 16, 640), 225), ((32, 640, 32, 32, 320), 50),
    ((32, 960, 16, 16, 640), 25), ((32, 960, 32, 32, 320), 25),
    ((32, 1280, 4, 4, 1280), 475), ((32, 1280, 8, 8, 1280), 225),
    ((32, 1280, 16, 16, 640), 25), ((32, 1920, 8, 8, 1280), 25),
    ((32, 1920, 16, 16, 640), 25), ((32, 2560, 4, 4, 1280), 75),
    ((32, 2560, 8, 8, 1280), 50),
]


# ((B F), D, C) of #6, 300 launches a clip at each level (F = 16, H = 8)
TEMPORAL_CLIP = [("motion 32x32", (32, 1024, 320)),
                 ("motion 16x16", (32, 256, 640)),
                 ("motion 8x8", (32, 64, 1280)),
                 ("motion 4x4", (32, 16, 1280))]
TEMPORAL_LAUNCHES = 300
# (site, ((B F), D, C), launches a validate run) of #6 in f32: validate's
# UNet3D at the CFG batch (420 launches a level) and at one clip (80)
TEMPORAL_F32 = [("validate 32x32", (32, 1024, 320), 420),
                ("validate 16x16", (32, 256, 640), 420),
                ("validate 8x8", (32, 64, 1280), 420),
                ("validate 4x4", (32, 16, 1280), 420),
                ("validate 32x32, 1 clip", (16, 1024, 320), 80),
                ("validate 16x16, 1 clip", (16, 256, 640), 80),
                ("validate 8x8, 1 clip", (16, 64, 1280), 80),
                ("validate 4x4, 1 clip", (16, 16, 1280), 80)]

# (x shape, launches a fused clip, launches a fused step) of #7, 32 groups,
# as chip_smoke.py's record counts them
GN_SHAPES = [
    ((1, 128, 128, 128), 1, 0), ((1, 128, 256, 256), 4, 0),
    ((1, 128, 512, 512), 36, 0), ((1, 128, 768, 768), 6, 0),
    ((1, 256, 64, 64), 1, 0), ((1, 256, 128, 128), 3, 0),
    ((1, 256, 256, 256), 30, 0), ((1, 256, 384, 384), 5, 0),
    ((1, 256, 512, 512), 6, 0), ((1, 256, 768, 768), 1, 0),
    ((1, 512, 32, 32), 9, 0), ((1, 512, 64, 64), 63, 0),
    ((1, 512, 96, 96), 10, 0), ((1, 512, 128, 128), 36, 0),
    ((1, 512, 192, 192), 6, 0), ((1, 512, 256, 256), 6, 0),
    ((1, 512, 384, 384), 1, 0), ((6, 32, 64, 64), 8, 0),
    ((6, 64, 32, 32), 6, 0), ((6, 64, 64, 64), 2, 0),
    ((6, 128, 16, 16), 16, 0), ((6, 128, 32, 32), 2, 0),
    ((16, 128, 128, 128), 1, 0), ((16, 128, 256, 256), 10, 0),
    ((16, 256, 64, 64), 1, 0), ((16, 256, 128, 128), 8, 0),
    ((16, 256, 256, 256), 1, 0), ((16, 512, 32, 32), 19, 0),
    ((16, 512, 64, 64), 9, 0), ((16, 512, 128, 128), 1, 0),
    ((60, 32, 64, 64), 0, 16), ((60, 64, 32, 32), 0, 12),
    ((60, 64, 64, 64), 0, 4), ((60, 128, 16, 16), 0, 32),
    ((60, 128, 32, 32), 0, 4),
]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches after one warm-up."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of fn() per call: `reps` calls queued behind a kernel
    that keeps the card busy until the host has enqueued them all, timed
    by CUDA events around the calls, so the host's cost per call (which
    `cuda_ms` counts where the host is slower than the card) is hidden;
    every launch of a call and the card's gaps between them counted.
    Doubles the wait until it outlasts the enqueueing."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wait_s = max(1e-3, 4 * reps * (time.perf_counter() - t0))
    clock_hz = 2.0e9  # above the H100's top SM clock: the wait only lengthens
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(6):
        marks[0].record()
        torch.cuda._sleep(int(wait_s * clock_hz))
        marks[1].record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        marks[2].record()
        enqueue_ms = 1e3 * (time.perf_counter() - h0)
        torch.cuda.synchronize()
        if enqueue_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        wait_s *= 2
    raise SystemExit("device_ms: the host never got ahead of the card")


def host_us(fn, reps: int) -> float:
    """The host's time to enqueue one call of fn(), in us: `reps` calls
    queued behind a kernel that keeps the card busy, so none waits on it
    (the wrapper's checks, allocation and launch)."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2.0e9 * max(1e-3, reps * 200e-6)))
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - h0
    torch.cuda.synchronize()
    return 1e6 * took / reps


def attention_bounds(b, h, tq, tk, d):
    """(bound, exponentials' bound) of a bf16 forward in ms on an H100:
    max(4 Tq Tk D / 989 TFLOP/s, q, k, v and the output's bytes / 3.35
    TB/s), and Tq Tk ex2 at 3.9 T/s (the MUFU unit)."""
    ops = 4.0 * b * h * tq * tk * d
    nbytes = 2 * (2 * b * h * tq * d + 2 * b * h * tk * d)
    return (1e3 * max(ops / 989e12, nbytes / 3.35e12),
            1e3 * b * h * tq * tk / 3.9e12)


def attention_bwd_bounds(b, h, tq, tk, d, hkv, bias_elems, esize=2,
                         peak=989e12):
    """(bound, exponentials' bound) of a bf16 (or, with esize 4 and the
    TF32 peak, f32) backward in ms on an H100: max(10 Tq Tk D / 989
    TFLOP/s, q, k, v, g, the f32 lse (and the bias) read and dq, dk, dv
    (and the f32 dbias) written / 3.35 TB/s), and the two passes' 2 Tq Tk
    ex2 at 3.9 T/s (the MUFU unit)."""
    ops = 10.0 * b * h * tq * tk * d
    nbytes = (esize * (3 * b * h * tq * d + 4 * b * hkv * tk * d
                       + bias_elems)
              + 4 * b * h * tq + 4 * bias_elems)
    return (1e3 * max(ops / peak, nbytes / 3.35e12),
            1e3 * 2 * b * h * tq * tk / 3.9e12)


def kernel_ms(fn, reps: int, prefix: str):
    """{kernel: device ms per call} of the kernels whose names start with
    `prefix` (the name up to its template arguments), under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            name = e.key.replace("(anonymous namespace)::", "")
            m = re.search(r"\b(\w+)(<[^(]*>)?\(", name)
            key = m.group(1) + (m.group(2) or "") if m else name
            if key.startswith(prefix):
                per[key] = per.get(key, 0.0) + us / 1e3 / reps
    return per


def time_here(root: str, only: str):
    """Times of `root`'s kernels (`only`: a comma list of the groups, or
    "all"), one JSON line on stdout."""
    only = set(only.split(","))
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn
    from neurons_tpu_torch.ops import fused_conv as fc
    from neurons_tpu_torch.ops import fused_norm as fn_
    from neurons_tpu_torch.ops import temporal_attention as ta

    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    out, backends = {}, {}
    if "all" in only or "flash" in only:
        for name, (b, h, tq, tk, d), _ in FLASH_CLIP + FLASH_OTHER:
            q, k, v = rand(b, h, tq, d), rand(b, h, tk, d), rand(b, h, tk, d)
            reps = 5 if tq * tk > 10_000_000 else 20
            fn = lambda: attn.flash_attention_fwd(q, k, v)  # noqa: E731
            out[f"flash {name}"] = cuda_ms(fn, reps)
            out[f"device flash {name}"] = device_ms(fn, reps)
            # the yardsticks: the library's fused attention by device time
            # (its backend named), the bound and the exponentials' bound
            out[f"library flash {name}"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), reps)
            backends[name] = sdpa_backend(q, k, v)
            (out[f"bound flash {name}"],
             out[f"exp bound flash {name}"]) = attention_bounds(
                b, h, tq, tk, d)
            if d > 128:  # each kernel of the d 512 route (a combine apart)
                for kernel, ms in kernel_ms(fn, reps, "flash_fwd_").items():
                    out[f"device flash {name}: {kernel}"] = ms
            if name in ("unet self 48x48", "unet cross 24x24"):
                out[f"host us flash {name}"] = host_us(fn, 200)
        for name, (b, h, tq, tk, d, hkv), bshape, _, _ in FLASH_STEP:
            q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
            bias = rand(*bshape) if bshape else None
            reps = 5 if b * h * tq * tk > 2e8 else 20
            fn = lambda: attn.flash_attention_fwd(  # noqa: E731
                q, k, v, bias=bias, return_lse=True)
            out[f"flash {name} (train)"] = cuda_ms(fn, reps)
            out[f"device flash {name} (train)"] = device_ms(fn, reps)
        del q, k, v
        torch.cuda.empty_cache()
    if "all" in only or "f32" in only:
        for name, (b, h, tq, tk, d, hkv), bshape, lse, _ in FLASH_F32:
            q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
            k, v = (torch.randn((b, hkv, tk, d), generator=gen, device="cuda")
                    for _ in range(2))
            bias = (torch.randn(bshape, generator=gen, device="cuda")
                    if bshape else None)
            reps = 5 if b * h * tq * tk > 2e8 else 20
            fn = lambda: attn.flash_attention_fwd(  # noqa: E731
                q, k, v, bias=bias, return_lse=lse)
            out[f"f32 {name}"] = cuda_ms(fn, reps)
            out[f"device f32 {name}"] = device_ms(fn, reps)
            if name in ("vit-b frame", "validate 2x20x256",
                        "decoder 32x32 panel"):  # the median of 5 runs
                out[f"host us f32 {name}"] = sorted(
                    host_us(fn, 200) for _ in range(5))[2]
            out[f"profiled f32 {name}"] = sum(
                kernel_ms(fn, reps, "flash_fwd_").values())
        del q, k, v, bias
        torch.cuda.empty_cache()
    if "all" in only or "bwd" in only:
        for name, (b, h, tq, tk, d, hkv), bshape, _, _ in FLASH_STEP:
            q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
            bias = rand(*bshape) if bshape else None
            g = rand(b, h, tq, d)
            scale = d ** -0.5
            o, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                              return_lse=True)
            reps = 5 if b * h * tq * tk > 2e8 else 20
            fn = lambda: attn.flash_attention_bwd(  # noqa: E731
                q, k, v, bias, g, o, lse, scale)
            out[f"bwd {name}"] = cuda_ms(fn, reps)
            out[f"device bwd {name}"] = device_ms(fn, reps)
            for kernel, ms in kernel_ms(fn, reps, "flash_bwd_").items():
                out[f"device bwd {name}: {kernel}"] = ms
            # the yardsticks: the library's backward alone (its forward
            # once, outside the timer; k/v materialised over the heads, the
            # bias as attn_mask) by device time, and the bound
            lib_in = [x.detach().expand(b, h, -1, d).contiguous()
                      .requires_grad_() for x in (q, k, v)]
            lib_bias = None if bias is None else bias.detach().requires_grad_()
            lib_out = F.scaled_dot_product_attention(
                *lib_in, attn_mask=lib_bias, scale=scale)
            wrt = lib_in + ([] if lib_bias is None else [lib_bias])
            out[f"library bwd {name}"] = device_ms(
                lambda: torch.autograd.grad(lib_out, wrt, g,
                                            retain_graph=True), reps)
            (out[f"bound bwd {name}"],
             out[f"exp bound bwd {name}"]) = attention_bwd_bounds(
                b, h, tq, tk, d, hkv, 0 if bias is None else bias.numel())
            del lib_in, lib_bias, lib_out, wrt
        for name, (b, h, tq, tk, d, hkv), bshape, _ in FLASH_BWD_F32:
            q, g = (torch.randn((b, h, tq, d), generator=gen, device="cuda")
                    for _ in range(2))
            k, v = (torch.randn((b, hkv, tk, d), generator=gen, device="cuda")
                    for _ in range(2))
            bias = (torch.randn(bshape, generator=gen, device="cuda")
                    if bshape else None)
            scale = d ** -0.5
            o, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                              return_lse=True)
            fn = lambda: attn.flash_attention_bwd(  # noqa: E731
                q, k, v, bias, g, o, lse, scale)
            reps = 5 if b * h * tq * tk > 2e8 else 10
            out[f"bwd f32 {name}"] = cuda_ms(fn, reps)
            out[f"device bwd f32 {name}"] = device_ms(fn, reps)
            for kernel, ms in kernel_ms(fn, reps, "flash_bwd_").items():
                out[f"device bwd f32 {name}: {kernel}"] = ms
            # the host's microseconds a call (the median of five runs), the
            # library's backward alone (TF32 products allowed, as for the
            # port) by device time, the bound at the TF32 rate
            out[f"host us bwd f32 {name}"] = sorted(
                host_us(fn, 50) for _ in range(5))[2]
            torch.backends.cuda.matmul.allow_tf32 = True
            lib_in = [x.detach().expand(b, h, -1, d).contiguous()
                      .requires_grad_() for x in (q, k, v)]
            lib_bias = None if bias is None else bias.detach().requires_grad_()
            lib_out = F.scaled_dot_product_attention(
                *lib_in, attn_mask=lib_bias, scale=scale)
            wrt = lib_in + ([] if lib_bias is None else [lib_bias])
            out[f"library bwd f32 {name}"] = device_ms(
                lambda: torch.autograd.grad(lib_out, wrt, g,
                                            retain_graph=True), reps)
            torch.backends.cuda.matmul.allow_tf32 = False
            (out[f"bound bwd f32 {name}"],
             out[f"exp bound bwd f32 {name}"]) = attention_bwd_bounds(
                b, h, tq, tk, d, hkv, 0 if bias is None else bias.numel(),
                esize=4, peak=495e12)
            del lib_in, lib_bias, lib_out, wrt
        del q, k, v, g, o, lse, bias
        torch.cuda.empty_cache()
    if "all" in only or "conv" in only:
        for (n, cin, h, w, cout), _ in CONV_CLIP:
            x = rand(n, cin, h, w)
            gw, gb = 1.0 + 0.1 * rand(cin), 0.1 * rand(cin)
            cw = rand(cout, cin, 3, 3) / (9 * cin) ** 0.5
            cb = 0.1 * rand(cout)
            fn = lambda: fc.gn_silu_conv_fwd(  # noqa: E731
                x, gw, gb, cw, cb, 32, 1e-5)
            key = f"{n},{cin},{h},{w}->{cout}"
            out[f"conv {key}"] = cuda_ms(fn, 20)
            out[f"device conv {key}"] = device_ms(fn, 20)
            # the yardsticks: the library composite by device time, and the
            # bound (each input read once, y written once)
            out[f"library conv {key}"] = device_ms(
                lambda: F.conv2d(F.silu(F.group_norm(x, 32, gw, gb, 1e-5)),
                                 cw, cb, padding=1), 20)
            out[f"bound conv {key}"] = 1e3 * max(
                2.0 * n * h * w * cout * 9 * cin / 989e12,
                2.0 * (x.numel() + 2 * cin + cw.numel() + cout
                       + n * cout * h * w) / 3.35e12)
            del x, cw
        torch.cuda.empty_cache()
    if "all" in only or "temporal" in only:
        for name, (bf, d, c) in TEMPORAL_CLIP:
            q, k, v = rand(bf, d, c), rand(bf, d, c), rand(bf, d, c)
            scale = (c // 8) ** -0.5
            fn = lambda: ta.temporal_attention_fwd(  # noqa: E731
                q, k, v, 16, 8, scale)
            out[f"temporal {name}"] = cuda_ms(fn, 20)
            out[f"device temporal {name}"] = device_ms(fn, 20)
        for name, (bf, d, c), _ in TEMPORAL_F32:
            q, k, v = (torch.randn((bf, d, c), generator=gen, device="cuda")
                       for _ in range(3))
            scale = (c // 8) ** -0.5
            fn = lambda: ta.temporal_attention_fwd(  # noqa: E731
                q, k, v, 16, 8, scale)
            out[f"temporal f32 {name}"] = cuda_ms(fn, 20)
            out[f"device temporal f32 {name}"] = device_ms(fn, 20)
        del q, k, v
        torch.cuda.empty_cache()
    if "all" in only or "gnsilu" in only:
        for shape, _, _ in GN_SHAPES:
            x = rand(*shape)
            gw, gb = 1.0 + 0.1 * rand(shape[1]), 0.1 * rand(shape[1])
            reps = 5 if x.numel() > 5e7 else 20
            fn = lambda: fn_.gn_silu_fwd(x, gw, gb, 32, 1e-5)  # noqa: E731
            key = ",".join(map(str, shape))
            out[f"gnsilu {key}"] = cuda_ms(fn, reps)
            out[f"device gnsilu {key}"] = device_ms(fn, reps)
            # the library composite, a yardstick by events
            out[f"library gnsilu {key}"] = cuda_ms(
                lambda: F.silu(F.group_norm(x, 32, gw, gb, 1e-5)), reps)
            del x
        torch.cuda.empty_cache()
    print(json.dumps({"times": out, "sdpa backends": backends}))


def totals(times):
    """Sum of launches x ms over a clip (flash d <= 128, flash d = 512, #6,
    #7, #8), over an SVD clip's and a caption batch's bf16 flash
    launches at d <= 128, over a step (flash forward, flash backward, #7) and over the
    f32 route's paths (a scored clip, a seg panel, a 2-clip stage e, an
    autoencoder step pair's forwards and backwards, a precompute batch's
    VAE encoder, an f32 stage-2 step's backwards) and over a validate
    run's f32 #6, from one run's times:
    event times, and ("device ...") the profiler's device times."""
    sums = {}
    for pre in ("", "device "):
        for name, (_, _, _, _, d), n in FLASH_CLIP:
            key = pre + ("flash clip d=512" if d > 128
                         else "flash clip d<=128")
            sums[key] = sums.get(key, 0.0) + n * times.get(
                f"{pre}flash {name}", 0.0)
        for name, _, paths in FLASH_OTHER:
            for path, n in paths.items():
                key = f"{pre}flash {path}"
                sums[key] = sums.get(key, 0.0) + n * times.get(
                    f"{pre}flash {name}", 0.0)
        for name, _, bias, n, n_bwd in FLASH_STEP:
            sums[pre + "flash step"] = sums.get(pre + "flash step", 0.0) \
                + n * times.get(f"{pre}flash {name} (train)", 0.0)
            sums[pre + "flash bwd step"] = sums.get(
                pre + "flash bwd step", 0.0) + n_bwd * times.get(
                f"{pre}bwd {name}", 0.0)
            # the DecoderVideo's sites (#4) apart from the prior's (#5)
            if bias is None:
                sums[pre + "flash bwd #4 step"] = sums.get(
                    pre + "flash bwd #4 step", 0.0) + n_bwd * times.get(
                    f"{pre}bwd {name}", 0.0)
        for name, _, _, _, paths in FLASH_F32:
            for path, n in paths.items():
                key = f"{pre}f32 {path}"
                sums[key] = sums.get(key, 0.0) + n * times.get(
                    f"{pre}f32 {name}", 0.0)
        for name, _, _, paths in FLASH_BWD_F32:
            for path, n in paths.items():
                key = f"{pre}bwd f32 {path}"
                sums[key] = sums.get(key, 0.0) + n * times.get(
                    f"{pre}bwd f32 {name}", 0.0)
        for (n, cin, h, w, cout), launches in CONV_CLIP:
            sums[pre + "conv fused clip"] = sums.get(
                pre + "conv fused clip", 0.0) + launches * times.get(
                f"{pre}conv {n},{cin},{h},{w}->{cout}", 0.0)
        for name, _ in TEMPORAL_CLIP:
            sums[pre + "temporal clip"] = sums.get(
                pre + "temporal clip", 0.0) + TEMPORAL_LAUNCHES * times.get(
                f"{pre}temporal {name}", 0.0)
        for name, _, n in TEMPORAL_F32:
            sums[pre + "temporal f32 validate"] = sums.get(
                pre + "temporal f32 validate", 0.0) + n * times.get(
                f"{pre}temporal f32 {name}", 0.0)
    for pre in ("library ", "bound "):
        for (n, cin, h, w, cout), launches in CONV_CLIP:
            sums[pre + "conv fused clip"] = sums.get(
                pre + "conv fused clip", 0.0) + launches * times.get(
                f"{pre}conv {n},{cin},{h},{w}->{cout}", 0.0)
    for pre in ("library ", "bound ", "exp bound "):
        for name, _, _, paths in FLASH_BWD_F32:
            for path, n in paths.items():
                key = f"{pre}bwd f32 {path}"
                sums[key] = sums.get(key, 0.0) + n * times.get(
                    f"{pre}bwd f32 {name}", 0.0)
        for name, _, bias, _, n_bwd in FLASH_STEP:
            for key in ("flash bwd step",) + (("flash bwd #4 step",)
                                              if bias is None else ()):
                sums[pre + key] = sums.get(pre + key, 0.0) + n_bwd * \
                    times.get(f"{pre}bwd {name}", 0.0)
        for name, (_, _, _, _, d), n in FLASH_CLIP:
            key = pre + ("flash clip d=512" if d > 128
                         else "flash clip d<=128")
            sums[key] = sums.get(key, 0.0) + n * times.get(
                f"{pre}flash {name}", 0.0)
        for name, _, paths in FLASH_OTHER:
            for path, n in paths.items():
                key = f"{pre}flash {path}"
                sums[key] = sums.get(key, 0.0) + n * times.get(
                    f"{pre}flash {name}", 0.0)
    for pre in ("", "device ", "library "):
        for shape, n_clip, n_step in GN_SHAPES:
            ms = times.get(f"{pre}gnsilu {','.join(map(str, shape))}", 0.0)
            for path, n in (("fused clip", n_clip), ("fused step", n_step)):
                key = f"{pre}gnsilu {path}"
                sums[key] = sums.get(key, 0.0) + n * ms
    return sums


def main():
    if sys.argv[1] == "--time":
        return time_here(sys.argv[2], sys.argv[3])
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--only", default="all",
                    help="a comma list of flash, f32, bwd, conv, temporal, "
                         "gnsilu (default all)")
    ap.add_argument("--json", help="also write the record here")
    args = ap.parse_args()
    groups = {"all", "flash", "f32", "bwd", "conv", "temporal", "gnsilu"}
    if not set(args.only.split(",")) <= groups:
        ap.error(f"--only takes a comma list of {sorted(groups)}")
    other = str(Path(args.other).resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs, backends = [], {}
    for label, root in (("other", other), ("this", str(REPO)),
                        ("this", str(REPO)), ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--time", root,
                              args.only], capture_output=True, text=True,
                             cwd=root, timeout=1200)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise SystemExit(f"{label} run at {root} failed "
                             f"(exit {res.returncode})")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((label, rec["times"]))
        backends = rec["sdpa backends"]
    if backends:
        print("the library's sdpa backend by site: " + ", ".join(
            f"{site} {name}" for site, name in backends.items()), flush=True)
    # the kernels by name may differ between the checkouts
    names = list(dict.fromkeys(n for _, times in runs for n in times))
    for name in names:
        cells = "  ".join(f"{label} {times[name]:.4f}" if name in times
                          else f"{label} -" for label, times in runs)
        print(f"A/B {name:41s} ms: {cells}")
    sums = [(label, totals(times)) for label, times in runs]
    for key in sums[0][1]:
        if not any(s[key] for _, s in sums):  # a kernel this run left out
            continue
        cells = "  ".join(f"{label} {s[key] / 1e3:.4f}" for label, s in sums)
        print(f"A/B sum of launches x time, {key:25s} s: {cells}")
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs, "sums": sums,
                                   "sdpa backends": backends}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
