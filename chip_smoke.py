#!/usr/bin/env python3
"""Drive the PyTorch port of stages 3 and 5 (inference, exact and fast
paths), stages 4 and 6 (captions and the metric suite, through the port's
CLI) and stages 1 and 2 (training, checkpoints and resume) on one CUDA
card, in the default configuration and in the fused-norm one, and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

The fused-norm configuration is the JAX package's: NEURONS_TPU_FUSED_NORM=1
(every GroupNorm+SiLU through kernel #7, csrc/gn_silu.cu) and
NEURONS_TPU_FUSED_GNCONV=1 (the res blocks' GN -> SiLU -> 3x3 conv pairs
through kernel #8, csrc/gn_silu_conv.cu). The script sets and unsets both
itself, whatever the environment holds.

Phases, in order:
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA source of the port (one nvcc per source, started together);
  2. kernel phase: the flash-attention kernel at every attention shape of
     the full-width clip (stage 3 and stage 5, and the fast clip's gated
     steps at one clip's batch), in bf16 (and two shapes in f32), and at
     the stage-2 seg panels' three DecoderVideo shapes (24 rows) in f32,
     at stage 4's BLIP-2 vision shape (bf16, heads of 88, 257 tokens) and
     stage 6's three classifier shapes (f32: ViT-B's 197 tokens,
     VideoMAE's 588, CLIP ViT-L's 257 for 6 frames), against an f32
     reference; its error must be no worse than 1.5x the plain version's
     at the kernel's precision (bf16 operands; for f32, operands rounded
     to TF32 as the kernel rounds them). The
     temporal-attention kernel at its four stage-5 shapes and their four
     gated ones in bf16 (and one in f32), against the float64 result on
     the same inputs, by the same 1.5x rule. Times: kernel (by CUDA events
     and its device time: `device_ms`), plain version, one
     PyTorch library call (scaled_dot_product_attention, a yardstick the
     port never calls), and the bound max(ops / peak, bytes / 3.35 TB/s).
     Then the training kernels at every stage-2 shape (the prior's biased
     multi-query attention, the DecoderVideo's three sizes), in bf16 (and
     the prior's in f32): the forward with log-sum-exp and the backward, against float64
     autograd of `attention_reference` on the same inputs, each of out,
     lse, dq, dk, dv (and dbias) within 1.5x the plain path's error (plain
     forward, then `flash_attention_bwd_reference` at the kernel's
     precision); library = scaled_dot_product_attention forward (+
     backward, and the backward alone through autograd.grad of one
     forward), the float bias as attn_mask;
  3. small check, unfused then fused: the tiny stage-3 pipeline (f32,
     attention sites of 256 and 1024 tokens, so the flash kernel runs) and
     the tiny stage-5 `reconstruct_video` (16x16 latents: flash at 256
     tokens, the temporal kernel at every level) on the card against the
     same pipelines on the CPU, where every attention is the plain version;
     and one f32 stage-2 train step of the tiny config widened to 64 CLIP
     tokens (the prior's 129 x 130 and the decoder's 256 and 1024 tokens
     take both kernels) on the card against the CPU, the same weights,
     batch, draws and dropout masks: the seven losses and every trainable
     gradient. Fused, #7 and #8 run on the card under the same gates.
     Then, unfused, the small fast check: every fast branch at tiny size,
     f32, card against CPU under the same 2e-2 gate (`unclip_sample`'s
     TGATE, TGATE x PAB, PAB, DeepCache and encoder reuse;
     `reconstruct_video`'s TGATE, TGATE x PAB, PAB and encoder reuse with
     SparseCtrl, each over 6 steps so that every branch takes its capture
     and reuse arms; the RGB-condition SparseCtrl; `ddim_inversion`).
     Then a reduced BLIP-2 (257 vision tokens at heads of 88, so the flash
     kernel runs; a 2-layer Q-Former and OPT) card against CPU, f32: the
     cached greedy decode equal to `generate_nocache` on each and across
     the two, the logits within 2e-2 * max; and the ViT-B, VideoMAE and
     CLIP ViT-L towers at their real token counts and reduced width, their
     outputs within 2e-2 * max;
  4. slice phase: the full-width clip (`PipelineConfig()`, `GPT2Config()`,
     `CLIPTextConfig.sd15()`) in bf16 with seeded random weights: stage 3
     (`reconstruct_keyframes(enhance=True)`, the blurry-video decode and
     the 256-px artifact resize) then stage 5 (SD-1.5 text tower, 25-step
     CFG-8.5 DDIM through UNet3D + SparseCtrl over 16 frames of 32x32
     latents, VAE decode) for 2 voxel requests one at a time, unfused and
     then fused on the same models and seeds; the kernels' launch counts
     are zeroed just before and read just after each, #7/#8 held to the
     count from the code, the unfused clip's flash and temporal launches
     to the count from the step schedule (`sampler_launches`). After each,
     one more clip under torch.profiler (device activity only), outside
     the counted run: its wall time and the device's busy time (the sum of
     kernel and copy times) in the same run, the idle share they give,
     each kernel's share of busy time, and the top kernels. Between the
     two, unfused, the fast clips (`fast_phase`): the CLI's "max" preset
     (TGATE at step 10 with PAB every 2nd gated step, both stages) for 2
     counted requests and 1 profiled, then one request each of PAB,
     encoder reuse and DeepCache (bench.py's knobs), each with s/clip by
     stage, peak memory, its flash and temporal launches held to the
     count from the step schedule, and its rms deviation from the exact
     clip's first request on the same draws (for the preset also stage 5
     alone on the exact stage-3 artifacts). Then one full-width UNet2D and
     one UNet3D forward,
     fused and unfused in bf16 on the same input against the same forward
     in f32 (the fused error within 1.5x the unfused one);
  4b. stage 4 and stage 6 at full width through `neurons_tpu_torch.cli`
     (`stage46_phase`): 16 stage-3 keyframe artifacts (the clip's and
     synthetic ones), `caption --synthetic` (`Blip2Config()`, bf16, batch
     8, 30 tokens; s a batch, peak memory, flash launches 39 a batch); 4
     stage-5 GIFs from the clip's video through the native codec (built
     into `neurons_tpu_torch/_build/`, nothing written into `native/`),
     then `eval` with pixel metrics only and with the three full-width
     classifiers written as HF state dicts (s a scored clip, peak memory,
     flash launches 360 a clip, the report's ranges);
  5. train phase: stage 2 at full width (`PipelineConfig()`, `GPT2Config()`,
     `TrainConfig()`: batch 10, 6 frames, bf16 autocast, the cycle
     schedule, the core held in bf16) with seeded random weights and random
     batches at the real tables' shapes: a short `training/loop.py:
     run_stage2` (one epoch of 2 steps with its checkpoints and seg panel:
     `ckpt_dir`, `last_save_every=1`, `image_log_every=1`; the kernels'
     launch counts zeroed just before and read just after; each tag's
     bytes and save seconds; the tags overlaid by `load_decoupler_params`
     onto a fresh ensemble, equal to the trained state bitwise), then 1
     warm-up and 3 timed steps of
     `make_stage2_train_step` on one fixed batch and draws (ms/step, peak
     memory, launches per step against the count predicted from the code,
     the loss falling, the core bitwise unchanged, the trainable weights
     moved), then one more step under torch.profiler; then the same fixed
     steps fused (#7 launches per step against the count from the code,
     the first step's losses within 2e-2 of the unfused first step's) and
     one fused step under the profiler. Then stage 1 at full width
     (`PipelineConfig().brain`, `TrainConfig()`: batch 10, bf16 autocast):
     1 warm-up and 3 timed steps of `make_stage1_train_step` on a fixed
     batch and draws (ms/step, peak memory, the loss falling, clipproj
     bitwise unchanged, every other tensor with a nonzero gradient
     moved), one profiled step
     (AdamW's and the GEMMs' shares of busy time), the eval step over
     100 rows and the background writer's device snapshot of the full
     state; then the checkpoint phase, every tag in a directory of the
     checkout that is deleted afterwards (its disk's free bytes printed
     first): `run_stage1` at full width over 2 epochs of 2 steps,
     preempted after the first and resumed (each tag's bytes and save
     seconds, copy and write apart; the resume's peak device memory above
     the live state, at most the largest tensor; each full-width tag
     written once, which keeps the run's disk under 45 GiB); the same
     preempted run against an uninterrupted one at
     a reduced width (hidden 256, 16 CLIP tokens), equal bits; and the
     tiny chain, card against CPU: stage 1 ->
     `load_stage1_core` -> stage 2 -> `load_decoupler_params` -> stage 3;
  6. kernel phase for #7 and #8 at every (shape, dtype) the fused clip and
     the fused step launched, against float64 on the same inputs by the
     1.5x rule; times: kernel (by events, and its device time, every
     launch of a call, with calls queued behind a kernel that keeps the
     card busy while the host enqueues them (`device_ms`): the plain events
     measure the host's cost per call where it exceeds the device's work),
     plain version, the library composite (`F.silu(F.group_norm(...))`, then
     `F.conv2d` for #8) and the bound; #7's launch plan per shape.
Then one line of per-kernel totals for one clip or one step (launches x
time summed: kernel by events and, for #6-#8, by device time, bound,
library call), which gives the redesign order from one run, and one line
of the same sums by the Pallas kernel each launch replaces. The last
two lines are the kernels' JSON record (each (kernel, shape) of the main
paths, the "max" fast clip's among them, those totals, the f32 flash checks with their bound and library
time, each kernel's registers and spills from nvcc's -Xptxas -v log) and
the device JSON. Any failure raises and exits non-zero; without CUDA the
script exits 2 before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12    # dense TF32
PEAK_F32_FLOPS = 67e12      # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SEED = 0
CLIP_REQUESTS = 2   # full-width clips a configuration
FIXED_STEPS = 4     # fixed-batch train steps a configuration

# (B, H, Tq, Tk, D) of every flash-attention launch of the full-width clip
FLASH_SHAPES = [
    ("unet self 48x48", (2, 10, 2304, 2304, 64)),
    ("unet cross 48x48", (2, 10, 2304, 256, 64)),
    ("unet self 24x24", (2, 20, 576, 576, 64)),
    ("unet cross 24x24", (2, 20, 576, 256, 64)),
    ("decoder 16x16", (6, 1, 256, 256, 128)),
    ("decoder 32x32", (6, 1, 1024, 1024, 64)),
    ("decoder 64x64", (6, 1, 4096, 4096, 32)),
    ("vae blurry 64x64", (1, 1, 4096, 4096, 512)),
    ("vae keyframe 96x96", (1, 1, 9216, 9216, 512)),
    ("unet3d self 32x32", (32, 8, 1024, 1024, 40)),
    ("unet3d self 16x16", (32, 8, 256, 256, 80)),
    ("vae 16 frames 32x32", (16, 1, 1024, 1024, 512)),
    ("vae keyframe 32x32", (1, 1, 1024, 1024, 512)),
    # the fast clip's gated steps: the CFG batch collapsed to one clip
    ("unet self 48x48 gated", (1, 10, 2304, 2304, 64)),
    ("unet self 24x24 gated", (1, 20, 576, 576, 64)),
    ("unet3d self 32x32 gated", (16, 8, 1024, 1024, 40)),
    ("unet3d self 16x16 gated", (16, 8, 256, 256, 80)),
]
F32_CHECKS = ["unet cross 48x48", "vae blurry 64x64"]
# the stage-2 seg panels' launches (`make_stage2_seg_panel_fn`, min(4, B) =
# 4 clips of 6 frames, f32 as the JAX package's panel runs, no grad): the
# DecoderVideo's three sizes at 24 rows; the prior's biased forward takes
# the plain version without autograd
PANEL_SHAPES = [
    ("decoder 16x16 panel", (24, 1, 256, 256, 128)),
    ("decoder 32x32 panel", (24, 1, 1024, 1024, 64)),
    ("decoder 64x64 panel", (24, 1, 4096, 4096, 32)),
]

# stage 4's launches (the BLIP-2 vision tower, bf16, the CLI's batch of 8
# keyframes) and stage 6's (the metric classifiers, f32): every
# flash-attention launch of a caption batch and of a scored clip
CAPTION_SHAPES = [("blip2 vision 16x16+cls", (8, 16, 257, 257, 88))]
METRIC_SHAPES = [
    ("vit-b frame", (1, 12, 197, 197, 64)),
    ("videomae 6 frames", (1, 12, 588, 588, 64)),
    ("clip vit-l 6 frames", (6, 16, 257, 257, 64)),
]

# ((B F), D, C) of every temporal-attention launch of the full-width clip:
# 16 frames, 8 heads, the CFG batch of one clip
N_FRAMES, MOTION_HEADS = 16, 8
TEMPORAL_SHAPES = [
    ("motion 32x32", (32, 1024, 320)),
    ("motion 16x16", (32, 256, 640)),
    ("motion 8x8", (32, 64, 1280)),
    ("motion 4x4", (32, 16, 1280)),
    # the fast clip's gated steps (one clip, 16 frames)
    ("motion 32x32 gated", (16, 1024, 320)),
    ("motion 16x16 gated", (16, 256, 640)),
    ("motion 8x8 gated", (16, 64, 1280)),
    ("motion 4x4 gated", (16, 16, 1280)),
]
TEMPORAL_F32_CHECKS = ["motion 32x32"]


def log(msg):
    print(msg, flush=True)


# the fused-norm configuration's two switches (ops/fused_norm.py,
# ops/fused_conv.py), the JAX package's names
SWITCHES = ("NEURONS_TPU_FUSED_NORM", "NEURONS_TPU_FUSED_GNCONV")


@contextlib.contextmanager
def configuration(fused: bool):
    """Both switches "1" (the fused-norm configuration) or both unset (the
    default), whatever the caller's environment held; restored after."""
    import os
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if fused:
            os.environ[k] = "1"
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def config_name(fused: bool) -> str:
    return "fused" if fused else "unfused"


def gn_counters():
    from neurons_tpu_torch.ops.fused_conv import GN_SILU_CONV_LAUNCHES
    from neurons_tpu_torch.ops.fused_norm import GN_SILU_LAUNCHES
    return {"gn_silu": GN_SILU_LAUNCHES, "gn_silu_conv": GN_SILU_CONV_LAUNCHES}


def gn_sites(module) -> int:
    """GroupNormSiLU modules in `module`: each runs once per forward, as
    kernel #7 or, where its res block fuses it with the conv after it,
    #8."""
    from neurons_tpu_torch.ops.fused_norm import GroupNormSiLU
    return sum(isinstance(m, GroupNormSiLU) for m in module.modules())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    by CUDA events around the calls, so the host's cost per call is hidden
    (every launch of a call and the card's gaps between them counted).
    Doubles the wait until it outlasts the enqueueing."""
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
    raise AssertionError("device_ms: the host never got ahead of the card")


def _bound(ops, nbytes, peak_flops):
    t_ops, t_bytes = ops / peak_flops, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound(b, h, tq, tk, d, esize, peak_flops, hkv=None,
                    bias_elems=0, lse=False):
    """Forward: 2 products; q, k, v (and the bias) read once, the output
    (and the f32 lse) written once."""
    hkv = h if hkv is None else hkv
    nbytes = (esize * (2 * b * h * tq * d + 2 * b * hkv * tk * d + bias_elems)
              + (4 * b * h * tq if lse else 0))
    return _bound(4.0 * b * h * tq * tk * d, nbytes, peak_flops)


def attention_bwd_bound(b, h, tq, tk, d, esize, peak_flops, hkv, bias_elems):
    """Backward: 5 products; q, k, v, g and the f32 lse (and the bias)
    read once, dq, dk, dv (and the f32 dbias) written once."""
    nbytes = (esize * (3 * b * h * tq * d + 4 * b * hkv * tk * d + bias_elems)
              + 4 * b * h * tq + 4 * bias_elems)
    return _bound(10.0 * b * h * tq * tk * d, nbytes, peak_flops)


def flash_phase():
    """Flash kernel vs plain version at every shape of the clip. Returns
    {shape: record}."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    gen = torch.Generator("cuda").manual_seed(SEED)
    records = {}
    checks = [(name, shape, torch.bfloat16) for name, shape in FLASH_SHAPES]
    checks += [(name, shape, torch.float32) for name, shape in FLASH_SHAPES
               if name in F32_CHECKS]
    checks += [(name, shape, torch.float32) for name, shape in PANEL_SHAPES]
    checks += [(name, shape, torch.bfloat16) for name, shape in CAPTION_SHAPES]
    checks += [(name, shape, torch.float32) for name, shape in METRIC_SHAPES]
    for name, (b, h, tq, tk, d), dt in checks:
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        k = torch.randn((b, h, tk, d), generator=gen, device="cuda")
        v = torch.randn((b, h, tk, d), generator=gen, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = attn.attention_reference(q, k, v)
        qx, kx, vx = q.to(dt), k.to(dt), v.to(dt)
        got = attn.flash_attention_fwd(qx, kx, vx)
        torch.cuda.synchronize()
        # the plain version at the kernel's precision: bf16 operands, or,
        # for f32, operands rounded to TF32 as the kernel's f32 route does
        if dt == torch.float32:
            plain = attn.attention_reference_tf32(q, k, v)
        else:
            plain = attn.attention_reference(qx, kx, vx)
        err = (got.float() - want).abs().max().item()
        plain_err = (plain.float() - want).abs().max().item()
        # the plain version is timed as the port would call it (TF32
        # products allowed for f32)
        torch.backends.cuda.matmul.allow_tf32 = dt == torch.float32
        reps = 5 if tq * tk > 10_000_000 else 20
        kernel_ms = cuda_ms(lambda: attn.flash_attention_fwd(qx, kx, vx),
                            reps)
        kernel_dev_ms = device_ms(
            lambda: attn.flash_attention_fwd(qx, kx, vx), reps)
        plain_ms = cuda_ms(lambda: attn.attention_reference(qx, kx, vx), reps)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qx, kx, vx), reps)
        torch.backends.cuda.matmul.allow_tf32 = False
        bound_ms, bound_by = attention_bound(
            b, h, tq, tk, d, qx.element_size(),
            PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS)
        bq, bk, smem = attn.flash_tiles(d, dt)
        # the kernel's error <= 1.5x the plain version's at its precision,
        # as in tests/test_torch_port_cuda.py
        ok = bool(torch.isfinite(got).all()) and err <= 1.5 * plain_err
        tname = str(dt).split(".")[-1]
        log(f"flash {name:20s} {tname:8s} [{b},{h},{tq},{tk},{d}] "
            f"tiles {bq}x{bk} smem {smem} B  max_abs_err {err:.3e} "
            f"(plain {plain_err:.3e})  kernel_ms {kernel_ms:.4f} (device "
            f"{kernel_dev_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})  "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees at {name} {tname}: "
                                 f"{err:.3e} > 1.5 x {plain_err:.3e}")
        records[(b, h, tq, tk, d, tname, "")] = dict(
            site=name, max_abs_err=err, plain_err=plain_err, ms=kernel_ms,
            device_ms=kernel_dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, want, got, plain, qx, kx, vx
    torch.cuda.empty_cache()
    return records


def temporal_bound(bf, d, c, esize, peak_flops):
    ops = 4.0 * bf * d * N_FRAMES * c   # 2 F x F x hd products a (b, d, h)
    nbytes = esize * 4 * bf * d * c     # q, k, v read once, out written once
    t_ops, t_bytes = ops / peak_flops, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def temporal_phase():
    """Temporal kernel vs plain version at every shape of the clip, both
    against the float64 result on the same inputs. Returns {shape:
    record}."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    f, h = N_FRAMES, MOTION_HEADS
    gen = torch.Generator("cuda").manual_seed(SEED)
    records = {}
    checks = [(name, shape, torch.bfloat16) for name, shape in TEMPORAL_SHAPES]
    checks += [(name, shape, torch.float32) for name, shape
               in TEMPORAL_SHAPES if name in TEMPORAL_F32_CHECKS]
    for name, (bf, d, c), dt in checks:
        hd, scale = c // h, (c // h) ** -0.5
        q, k, v = (torch.randn((bf, d, c), generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        want = ta.temporal_attention_reference(q.double(), k.double(),
                                               v.double(), f, h, scale)
        got = ta.temporal_attention(q, k, v, f, h, scale)
        torch.cuda.synchronize()
        plain = ta.temporal_attention_reference(q, k, v, f, h, scale)
        err = (got.double() - want).abs().max().item()
        plain_err = (plain.double() - want).abs().max().item()
        kernel_ms = cuda_ms(lambda: ta.temporal_attention(q, k, v, f, h,
                                                          scale), 20)
        kernel_dev_ms = device_ms(lambda: ta.temporal_attention(
            q, k, v, f, h, scale), 20)
        plain_ms = cuda_ms(lambda: ta.temporal_attention_reference(
            q, k, v, f, h, scale), 20)
        # the library yardstick: one attention call on the [b, D, H, F, hd]
        # views of the same tensors

        def view(x):
            return x.reshape(bf // f, f, d, h, hd).permute(0, 2, 3, 1, 4)

        qv, kv, vv = view(q), view(k), view(v)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qv, kv, vv), 20)
        bound_ms, bound_by = temporal_bound(
            bf, d, c, q.element_size(),
            PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS)
        plan = ta.temporal_plan(f, hd, dt)
        ok = bool(torch.isfinite(got).all()) and err <= 1.5 * plain_err
        tname = str(dt).split(".")[-1]
        log(f"temporal {name:13s} {tname:8s} [{bf},{d},{c}] F={f} H={h} "
            f"route {plan.route}, warps {plan.warps}, smem {plan.smem} B  "
            f"max_abs_err {err:.3e} (plain {plain_err:.3e})  kernel_ms "
            f"{kernel_ms:.4f} (device {kernel_dev_ms:.4f}) plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by})  {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"temporal kernel disagrees at {name} "
                                 f"{tname}: {err:.3e} > 1.5 x "
                                 f"{plain_err:.3e}")
        records[(bf, d, c, f, h, tname)] = dict(
            site=name, max_abs_err=err, plain_err=plain_err, ms=kernel_ms,
            device_ms=kernel_dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            route=plan.route)
        del q, k, v, want, got, plain
    torch.cuda.empty_cache()
    return records


# (site, (B, H, Tq, Tk, D, kv heads), bias shape) of every flash launch of
# the full-width stage-2 step: the prior's 6 layers (a per-head bias over
# multi-query k/v) and the DecoderVideo's spatial attention (B*F = 60 rows)
TRAIN_SHAPES = [
    ("prior", (10, 32, 513, 514, 52, 1), (32, 513, 514)),
    ("decoder 16x16", (60, 1, 256, 256, 128, 1), None),
    ("decoder 32x32", (60, 1, 1024, 1024, 64, 1), None),
    ("decoder 64x64", (60, 1, 4096, 4096, 32, 1), None),
]
TRAIN_F32_CHECKS = ["prior"]
GRADS = ("dq", "dk", "dv", "dbias")


def oracle_f64(q, k, v, bias, g, scale):
    """float64 autograd of `attention_reference` on the same-valued inputs,
    in chunks over the batch (the bias is shared by all rows): {out, lse,
    dq, dk, dv, dbias}."""
    import torch
    from neurons_tpu_torch.ops import attention as attn

    b, h, tq, _ = q.shape
    chunk = max(1, int(2e9 // (8 * h * tq * k.shape[2])))
    parts = {n: [] for n in ("out", "lse", "dq", "dk", "dv")}
    dbias = None
    for s in range(0, b, chunk):
        ins = [x[s:s + chunk].double().requires_grad_() for x in (q, k, v)]
        b64 = None if bias is None else bias.double().requires_grad_()
        out, lse = attn.attention_reference_lse(*ins, b64, scale)
        wrt = ins + ([] if b64 is None else [b64])
        grads = torch.autograd.grad(out, wrt, g[s:s + chunk].double())
        for n, x in zip(("out", "lse", "dq", "dk", "dv"),
                        (out, lse) + grads[:3]):
            parts[n].append(x.detach())
        if b64 is not None:
            dbias = grads[3] if dbias is None else dbias + grads[3]
        del out, lse, grads, ins
    want = {n: torch.cat(x) for n, x in parts.items()}
    want["dbias"] = dbias
    return want


def train_kernel_phase():
    """The training kernels (forward with lse, backward) vs their plain
    versions at every stage-2 shape. Returns {(B, H, Tq, Tk, D, dtype,
    variant): record} for the forward and for the backward."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    fwd_records, bwd_records = {}, {}
    checks = [(n, s, bs, torch.bfloat16) for n, s, bs in TRAIN_SHAPES]
    checks += [(n, s, bs, torch.float32) for n, s, bs in TRAIN_SHAPES
               if n in TRAIN_F32_CHECKS]
    for name, (b, h, tq, tk, d, hkv), bshape, dt in checks:
        gen = torch.Generator("cuda").manual_seed(SEED)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
        bias = rand(*bshape) if bshape else None
        g = rand(b, h, tq, d)
        scale = d ** -0.5
        torch.backends.cuda.matmul.allow_tf32 = False
        want = oracle_f64(q, k, v, bias, g, scale)
        out, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                            return_lse=True)
        got = dict(zip(GRADS, attn.flash_attention_bwd(q, k, v, bias, g, out,
                                                       lse, scale)),
                   out=out, lse=lse)
        torch.cuda.synchronize()
        tf32 = dt == torch.float32
        if tf32:
            pout, plse = attn.attention_reference_tf32(q, k, v, scale, bias,
                                                       return_lse=True)
        else:
            pout, plse = attn.attention_reference_lse(q, k, v, bias, scale)
        plain = dict(zip(GRADS, attn.flash_attention_bwd_reference(
            q, k, v, bias, g, pout, plse, scale, tf32=tf32)),
            out=pout, lse=plse)
        errs = {}
        for n in ("out", "lse") + GRADS:
            if want[n] is None:
                continue
            errs[n] = ((got[n].double() - want[n]).abs().max().item(),
                       (plain[n].double() - want[n]).abs().max().item(),
                       bool(torch.isfinite(got[n]).all()))
        del want, plain, pout, plse
        torch.cuda.empty_cache()

        # times: as the port calls each (TF32 products allowed for f32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        reps = 3 if b * h * tq * tk > 2e8 else 10
        # the library call gets k/v materialised over the heads (its f32
        # path faulted on the stride-0 multi-query view at the prior's
        # shape on the card)
        kx = k.expand(b, h, tk, d).contiguous()
        vx = v.expand(b, h, tk, d).contiguous()
        fwd_ms = cuda_ms(lambda: attn.flash_attention_fwd(
            q, k, v, scale=scale, bias=bias, return_lse=True), reps)
        fwd_plain_ms = cuda_ms(lambda: attn.attention_reference_lse(
            q, k, v, bias, scale), reps)
        fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=bias, scale=scale), reps)
        bwd_ms = cuda_ms(lambda: attn.flash_attention_bwd(
            q, k, v, bias, g, out, lse, scale), reps)
        bwd_plain_ms = cuda_ms(lambda: attn.flash_attention_bwd_reference(
            q, k, v, bias, g, out, lse, scale), reps)

        def library_fwd_bwd():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, kx, vx))
            bb = None if bias is None else bias.detach().requires_grad_()
            F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bb,
                                           scale=scale).backward(g)

        bwd_lib_ms = cuda_ms(library_fwd_bwd, reps)
        # the library's backward alone: its forward once, outside the timer
        lib_in = [x.detach().requires_grad_() for x in (q, kx, vx)]
        lib_bias = None if bias is None else bias.detach().requires_grad_()
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=lib_bias,
                                                 scale=scale)
        lib_wrt = lib_in + ([] if lib_bias is None else [lib_bias])
        bwd_lib_only_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, lib_wrt, g, retain_graph=True), reps)
        del lib_in, lib_bias, lib_out, lib_wrt
        torch.backends.cuda.matmul.allow_tf32 = False
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS
        nbias = 0 if bias is None else bias.numel()
        esize = q.element_size()
        fwd_bound, fwd_by = attention_bound(b, h, tq, tk, d, esize, peak,
                                            hkv, nbias, lse=True)
        bwd_bound, bwd_by = attention_bwd_bound(b, h, tq, tk, d, esize, peak,
                                                hkv, nbias)
        ok = all(fin and err <= 1.5 * perr for err, perr, fin in errs.values())
        tname = str(dt).split(".")[-1]
        err_s = " ".join(f"{n} {e:.3e} (plain {pe:.3e})"
                         for n, (e, pe, _) in errs.items())
        bq, bk, smem = attn.flash_tiles(d, dt, "flash_attn_bwd")
        log(f"train {name:14s} {tname:8s} [{b},{h},{tq},{tk},{d}] kv heads "
            f"{hkv} bias {bshape}  max_abs_err {err_s}  fwd+lse kernel_ms "
            f"{fwd_ms:.4f} plain_ms {fwd_plain_ms:.4f} library_ms "
            f"{fwd_lib_ms:.4f} bound_ms {fwd_bound:.4f} ({fwd_by})  bwd "
            f"tiles {bq}x{bk} smem {smem} B kernel_ms {bwd_ms:.4f} plain_ms "
            f"{bwd_plain_ms:.4f} library_ms {bwd_lib_ms:.4f} (fwd+bwd) "
            f"library_bwd_ms {bwd_lib_only_ms:.4f} bound_ms {bwd_bound:.4f} "
            f"({bwd_by})  {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"training kernels disagree at {name} "
                                 f"{tname}: {errs}")
        key = (b, h, tq, tk, d, tname)
        fwd_records[key + ("bias+lse" if bias is not None else "lse",)] = dict(
            site=f"{name} (train)", max_abs_err=max(errs["out"][0],
                                                    errs["lse"][0]),
            ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms,
            bound_ms=fwd_bound, bound_by=fwd_by)
        bwd_records[key + ("bias" if bias is not None else "",)] = dict(
            site=f"{name} (train)",
            max_abs_err=max(errs[n][0] for n in GRADS if n in errs),
            ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=bwd_lib_ms,
            library_bwd_ms=bwd_lib_only_ms, bound_ms=bwd_bound,
            bound_by=bwd_by)
        del q, k, v, g, bias, out, lse, got, kx, vx
        torch.cuda.empty_cache()
    return fwd_records, bwd_records


def build_models(cfgs, device, dtype, seed):
    """Stage 3's models (decoupler, unCLIP UNet, VAE) with seeded random
    weights."""
    import torch
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.utils.synth_init import synth_params_

    pcfg, gcfg = cfgs
    dec = NeuronsDecoupler(pcfg.brain, pcfg.prior, pcfg.decoupler, gcfg,
                           device=device, dtype=dtype)
    unet = UNetModel(pcfg.unet2d, device=device, dtype=dtype)
    vae = AutoencoderKL(pcfg.vae, device=device, dtype=dtype)
    for i, m in enumerate((dec, unet, vae)):
        synth_params_(m.eval(), seed=seed + i)
    return dec, unet, vae


def build_video_models(pcfg, text_cfg, device, dtype, seed):
    """Stage 5's own models (CLIP text tower, UNet3D, SparseCtrl) with
    seeded random weights; the VAE is stage 3's."""
    import torch
    from neurons_tpu_torch.models.clip import CLIPTextTower
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    from neurons_tpu_torch.utils.synth_init import synth_params_

    f = pcfg.sampler.n_video_frames
    text = CLIPTextTower(text_cfg, device=device, dtype=dtype)
    unet3d = UNet3DModel(pcfg.unet3d, n_frames=f, device=device, dtype=dtype)
    cn = SparseControlNetModel(pcfg.unet3d, n_frames=f, device=device,
                               dtype=dtype)
    for i, m in enumerate((text, unet3d, cn)):
        synth_params_(m.eval(), seed=seed + 10 + i)
    return text, unet3d, cn


def small_check(fused: bool = False):
    """The tiny stage-3 pipeline on the card (kernel at the 256-token UNet
    and 1024-token VAE sites) against the CPU (plain attention), f32, the
    same weights and draws. The card's attention multiplies in TF32
    (relative 2^-11); three CFG-5 Euler steps and the decoder carry that
    into the pixels, hence 2e-2 * max |CPU| on keyframes; the prior
    (no kernel) is held to 1e-3, captions and argmax to equality. `fused`:
    in the fused-norm configuration (the caller sets it), where the UNet's
    norm/conv pairs take #8 (TF32 products) and the VAE's and decoder's
    norms #7, under the same gates."""
    import copy

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.diffusion.prior import PriorNoise
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.pipelines import keyframe as kf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = config.tiny_pipeline_config()
    pcfg = config.replace(pcfg, unet2d=config.replace(pcfg.unet2d,
                                                      adm_in_channels=1024))
    lat, b = 32, 2
    cpu = build_models((pcfg, tiny_gpt2_config()), "cpu", torch.float32, 7)
    gpu = [copy.deepcopy(m).to("cuda") for m in cpu]
    g = torch.Generator().manual_seed(SEED)
    c = pcfg.brain
    tok = (b, c.clip_seq_dim, c.clip_emb_dim)
    noise = kf.KeyframeNoise(
        PriorNoise(torch.randn(tok, generator=g),
                   [torch.randn(tok, generator=g)
                    for _ in range(pcfg.sampler.prior_steps)]),
        kf.UnclipNoise(torch.randn((b, 4, lat, lat), generator=g),
                       torch.randn((b, 4, lat, lat), generator=g),
                       torch.randn((b,), generator=g),
                       torch.randn(tok, generator=g)))
    voxel = torch.randn((b, 1, c.voxel_counts[0]), generator=g)
    classes = torch.randn((pcfg.decoupler.num_classes,
                           pcfg.decoupler.clip_txt_emb_dim), generator=g)
    outs = {}
    before = FLASH_FWD_LAUNCHES.total
    gn0 = {k: c.total for k, c in gn_counters().items()}
    for dev, models in (("cpu", cpu), ("cuda", gpu)):
        outs[dev] = kf.reconstruct_keyframes(
            *models, voxel, class_text_embeds=classes,
            sampler_cfg=pcfg.sampler, latent_hw=lat, enhance=True,
            caption_len=8, noise=noise,
            device=dev)
    launched = FLASH_FWD_LAUNCHES.total - before
    gn = {k: c.total - gn0[k] for k, c in gn_counters().items()}
    ref, got = outs["cpu"], outs["cuda"]

    def rel(name):
        a, r = getattr(got, name).cpu(), getattr(ref, name)
        return ((a - r).abs().max() / r.abs().max()).item()

    kf_err, prior_err = rel("keyframes"), rel("prior_tokens")
    same_caps = torch.equal(got.captions.cpu(), ref.captions)
    same_cls = torch.equal(got.cls_logits.argmax(-1).cpu(),
                           ref.cls_logits.argmax(-1))
    log(f"small check ({config_name(fused)}): kernel launches {launched}, "
        f"{gn}, keyframes rel err {kf_err:.3e} (<= 2e-2), prior tokens "
        f"{prior_err:.3e} (<= 1e-3), captions equal {same_caps}, class "
        f"argmax equal {same_cls}")
    if not (launched > 0 and kf_err <= 2e-2 and prior_err <= 1e-3
            and same_caps and same_cls
            and all((v > 0) == fused for v in gn.values())):
        raise AssertionError("tiny pipeline on the card disagrees with the "
                             "CPU plain version")


def small_video_check(fused: bool = False):
    """Tiny stage 5 (`reconstruct_video`, 3 DDIM steps, 4 frames of 16x16
    latents) on the card against the CPU, f32, the same weights, inputs
    and init noise: the flash kernel runs at the 256-token level-0
    self-attention and the VAE mid-block, the temporal kernel in every
    motion module. The card's flash attention multiplies in TF32 (relative
    2^-11) and CFG 8.5 multiplies the difference of the two halves' eps by
    8.5 at each of three steps before the decoder, hence 2e-2 * max |CPU|
    on latents and video, as for the stage-3 keyframes; the temporal
    kernel alone is exact f32. `fused`: in the fused-norm configuration
    (the UNet3D's and SparseCtrl's norm/conv pairs take #8, the VAE's
    norms #7), under the same gates."""
    import copy

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES
    from neurons_tpu_torch.pipelines.video import reconstruct_video
    from neurons_tpu_torch.utils.synth_init import synth_params_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = config.tiny_pipeline_config()
    f, px, b = pcfg.sampler.n_video_frames, 32, 1
    vae = synth_params_(AutoencoderKL(pcfg.vae, device="cpu").eval(), 8)
    cpu = (vae,) + build_video_models(pcfg, CLIPTextConfig.tiny(), "cpu",
                                      torch.float32, 7)[1:]
    gpu = [copy.deepcopy(m).to("cuda") for m in cpu]
    g = torch.Generator().manual_seed(SEED)
    ctx = pcfg.unet3d.cross_attention_dim
    blurry = torch.rand((b, 2, 3, px, px), generator=g)
    keyframe = torch.rand((b, 3, px, px), generator=g)
    text = torch.randn((b, 5, ctx), generator=g)
    uncond = torch.randn((b, 5, ctx), generator=g)
    noise = torch.randn((b, 4, f, px // 2, px // 2), generator=g)
    outs = {}
    flash0, temporal0 = FLASH_FWD_LAUNCHES.total, TEMPORAL_ATTN_LAUNCHES.total
    gn0 = {k: c.total for k, c in gn_counters().items()}
    for dev, (vae, unet3d, cn) in (("cpu", cpu), ("cuda", gpu)):
        outs[dev] = reconstruct_video(
            unet3d, cn, vae, blurry, keyframe, text, uncond,
            num_steps=pcfg.sampler.video_steps, n_frames=f, noise=noise,
            device=dev)
    flash = FLASH_FWD_LAUNCHES.total - flash0
    temporal = TEMPORAL_ATTN_LAUNCHES.total - temporal0
    gn = {k: c.total - gn0[k] for k, c in gn_counters().items()}
    ref, got = outs["cpu"], outs["cuda"]

    def rel(name):
        a, r = getattr(got, name).cpu(), getattr(ref, name)
        return ((a - r).abs().max() / r.abs().max()).item()

    lat_err, vid_err = rel("latents"), rel("video")
    log(f"small video check ({config_name(fused)}): flash launches {flash}, "
        f"temporal launches {temporal}, {gn}, latents rel err {lat_err:.3e} "
        f"(<= 2e-2), video rel err {vid_err:.3e} (<= 2e-2)")
    if not (flash > 0 and temporal > 0 and lat_err <= 2e-2
            and vid_err <= 2e-2
            and all((v > 0) == fused for v in gn.values())):
        raise AssertionError("tiny stage 5 on the card disagrees with the "
                             "CPU plain version")


@contextlib.contextmanager
def flash_plain_at_tf32():
    """On the CPU, the flash wrappers' plain versions at the kernels'
    precision on f32 input: every product's operands rounded to TF32
    (`attention_reference_tf32`, `flash_attention_bwd_reference(tf32=True)`)."""
    from neurons_tpu_torch.ops import attention as attn

    fwd, bwd = attn.flash_attention_fwd, attn.flash_attention_bwd

    def tf32_fwd(q, k, v, scale=None, bias=None, return_lse=False):
        return attn.attention_reference_tf32(q, k, v, scale, bias,
                                             return_lse=return_lse)

    def tf32_bwd(q, k, v, bias, g, out, lse, scale):
        return attn.flash_attention_bwd_reference(q, k, v, bias, g, out, lse,
                                                  scale, tf32=True)

    attn.flash_attention_fwd, attn.flash_attention_bwd = tf32_fwd, tf32_bwd
    try:
        yield
    finally:
        attn.flash_attention_fwd, attn.flash_attention_bwd = fwd, bwd


@contextlib.contextmanager
def gn_plain_in_f64():
    """On the CPU, the GroupNorm+SiLU plain version computed in float64 and
    rounded once to its input type (forward, and the recompute the
    autograd Function differentiates)."""
    from neurons_tpu_torch.ops import fused_norm as fn

    ref = fn.group_norm_silu_reference

    def f64(x, weight, bias, groups, eps=1e-5):
        return ref(x.double(), weight.double(), bias.double(), groups,
                   eps).to(x.dtype)

    fn.group_norm_silu_reference = f64
    try:
        yield
    finally:
        fn.group_norm_silu_reference = ref


@contextlib.contextmanager
def train_step_in_f64():
    """On the CPU, every module call of the stage-2 step in float64: the f32
    masters, inputs and outputs cast to it, the plain attention and
    GroupNorm computing in it, each gradient rounded once to its f32
    master. Its gradients are the step's without f32 rounding."""
    import torch
    from torch.func import functional_call
    from neurons_tpu_torch.training import train_decoupler as td

    caller = td.module_caller

    def cast(x):
        return (x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x)

    def f64_caller(model, params, bf16):
        weights = {n: p.double() for n, p in params.items()}

        def call(sub, *args, **kw):
            prefix = sub + "."
            out = functional_call(
                model.get_submodule(sub),
                {n[len(prefix):]: w for n, w in weights.items()
                 if n.startswith(prefix)},
                tuple(cast(a) for a in args), kw)
            return tuple(map(cast, out)) if isinstance(out, tuple) else cast(out)

        return call

    td.module_caller = f64_caller
    try:
        yield
    finally:
        td.module_caller = caller


def small_train_check(fused: bool = False):
    """One f32 stage-2 train step of the tiny config with 64 CLIP tokens
    (the prior attends 129 queries over 130 keys, the decoder reaches 256
    and 1024 tokens, so every training kernel runs) on the card against the
    CPU: the same weights, batch, draws and dropout masks. The card's flash
    kernels multiply in TF32, and TF32 rounding alone moves the decoder's
    smallest gradients (about 1e-3 of the largest) by 10-13% on this
    instance, differently for each way of rounding; so the CPU runs the
    step twice, with the plain attention in f32 and at the kernels'
    precision (`flash_plain_at_tf32`), and the distance between those two
    is each gradient's sensitivity to TF32 rounding. Held: the seven
    losses to 2e-3 of the TF32 CPU step's; each trainable gradient's
    distance to it (its max difference over its scale: its largest value,
    at least 1e-4 of the largest gradient of all) to 3x its sensitivity
    plus 1e-3 (f32 summation order). `fused`: in the fused-norm
    configuration (the decoder's norms take #7 forward, the plain
    composite backward; nothing of the step routes to #8), under the same
    gates; #7 sums the GroupNorm statistics in another order than the CPU,
    so a third CPU step, at TF32 with the GroupNorm computed in float64
    and rounded once (`gn_plain_in_f64`), gives each gradient's
    sensitivity to that rounding too, and the larger of the two counts.
    (A gradient that vanishes in exact arithmetic, such as a key bias
    under softmax, is rounding noise that any reordering moves.) The three
    gradients nearest their gate are logged with their size in each step
    and in a CPU step computed in float64 (`train_step_in_f64`), which
    shows which of them vanish."""
    import copy

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.diffusion.prior import PriorDiffusion, PriorDraws
    from neurons_tpu_torch.models.decoder_video import DecoderDropout
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.ops import attention as attn
    from neurons_tpu_torch.training import train_decoupler as td
    from neurons_tpu_torch.training.optimizers import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = config.tiny_pipeline_config()
    brain = config.replace(pcfg.brain, clip_seq_dim=64)
    prior = config.replace(pcfg.prior, num_tokens=64)
    dcfg = pcfg.decoupler
    tcfg = config.replace(pcfg.train, bf16_autocast=False)
    gcfg = tiny_gpt2_config()
    spe = 4
    cpu_bundle, _ = td.init_stage2(brain, prior, dcfg, tcfg, gcfg, spe,
                                   seed=7, device="cpu")
    model = copy.deepcopy(cpu_bundle.model).to("cuda")
    gpu_bundle = td.Stage2Bundle(
        model, PriorDiffusion.create(prior.timesteps, prior.cond_drop_prob,
                                     device="cuda"), cpu_bundle.schedule)
    params = dict(model.named_parameters())
    opt, _ = make_optimizer(tcfg, [p for n, p in params.items()
                                   if not td.is_core(n)], spe)
    gpu_state = td.TrainState(params, opt, 0)

    g = torch.Generator().manual_seed(SEED)
    b, f, n = tcfg.batch_size, dcfg.n_frames, brain.clip_seq_dim
    c, ct = brain.clip_emb_dim, dcfg.clip_txt_emb_dim
    tokens = torch.randint(1, gcfg.vocab_size, (b, 12), generator=g)
    tokens[:, 9:] = 0
    batch = {
        "voxel": torch.randn((b, 1, brain.voxel_counts[0]), generator=g),
        "clip_vision_target": torch.randn((b, n, c), generator=g),
        "clip_video_target": torch.randn((b, f, n, c), generator=g),
        "text_emb": torch.randn((b, ct), generator=g),
        "key_obj_text_embed": torch.randn((b, ct), generator=g),
        "key_obj_masks": (torch.rand((b, f, 32, 32), generator=g) < 0.3
                          ).float(),
        "cls_label": (torch.rand((b, dcfg.num_classes), generator=g) < 0.3
                      ).float(),
        "clip_tokens": tokens,
        "vae_latents": torch.randn((b, f, 4, 8, 8), generator=g),
    }
    draws = td.draw_stage2(cpu_bundle.diffusion, batch, dcfg, g)
    gpu_draws = td.Stage2Draws(
        PriorDraws(*(x.to("cuda") for x in draws.prior)),
        DecoderDropout(*(x.to("cuda") for x in draws.dropout)))
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}

    def run(bundle, state, dr, bt):
        step = td.make_stage2_train_step(bundle, tcfg, dcfg, spe)
        state, metrics = step(state, dr, bt, 0, 0, 0.05)
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in state.params.items()
                 if not td.is_core(n)})

    def cpu_init():  # the same seeded weights as the card's copy
        return td.init_stage2(brain, prior, dcfg, tcfg, gcfg, spe, seed=7,
                              device="cpu")

    plain = run(*cpu_init(), draws, batch)
    with flash_plain_at_tf32():
        oracle = run(*cpu_init(), draws, batch)
    perturbed = [plain]
    if fused:
        with flash_plain_at_tf32(), gn_plain_in_f64():
            perturbed.append(run(*cpu_init(), draws, batch))
    launches0 = (attn.FLASH_FWD_LAUNCHES.total, attn.FLASH_BWD_LAUNCHES.total)
    gn0 = {k: c.total for k, c in gn_counters().items()}
    got = run(gpu_bundle, gpu_state, gpu_draws, gpu_batch)
    fwd = attn.FLASH_FWD_LAUNCHES.total - launches0[0]
    bwd = attn.FLASH_BWD_LAUNCHES.total - launches0[1]
    gn = {k: c.total - gn0[k] for k, c in gn_counters().items()}

    # a gradient's scale: its largest value, at least 1e-4 of the largest
    # of all (one that vanishes in exact arithmetic is rounding noise)
    floor = 1e-4 * max(x.abs().max().item() for x in oracle[1].values())

    def dist(a, b, n):
        return ((a[1][n] - b[1][n]).abs().max().item()
                / max(b[1][n].abs().max().item(), floor))

    loss_err = max(abs(got[0][k] - oracle[0][k]) / abs(oracle[0][k])
                   for k in td.LOSS_TERMS)
    rows = [(dist(got, oracle, n),
             max(dist(p, oracle, n) for p in perturbed), n)
            for n in oracle[1]]
    bad = [r for r in rows if r[0] > 3 * r[1] + 1e-3]
    worst = max(rows)
    ratio = max(r[0] / (3 * r[1] + 1e-3) for r in rows)
    log(f"small train check ({config_name(fused)}): flash forward launches "
        f"{fwd}, backward launches {bwd}, {gn}; losses rel err "
        f"{loss_err:.3e} (<= 2e-3) against "
        f"the CPU at TF32; gradients: largest distance {worst[0]:.3e} "
        f"({worst[2]}, its sensitivity {worst[1]:.3e}), largest "
        f"distance / (3 x sensitivity + 1e-3) {ratio:.3f} (<= 1); losses "
        "card/CPU " + " ".join(f"{k} {got[0][k]:.5f}/{oracle[0][k]:.5f}"
                               for k in td.LOSS_TERMS))
    # the three gradients nearest their gate, their size in each step and
    # in one more CPU step computed in float64
    steps = {"card": got, "CPU f32": plain, "CPU TF32": oracle}
    if fused:
        steps["CPU TF32 + float64 GroupNorm"] = perturbed[-1]

    def f64(x):
        return x.double() if x.is_floating_point() else x

    with train_step_in_f64():
        steps["CPU float64"] = run(
            *cpu_init(),
            td.Stage2Draws(PriorDraws(*map(f64, draws.prior)),
                           DecoderDropout(*map(f64, draws.dropout))),
            {k: f64(v) for k, v in batch.items()})
    for r in sorted(rows, key=lambda r: r[0] / (3 * r[1] + 1e-3))[-3:]:
        log(f"  {r[2]}: distance / gate {r[0] / (3 * r[1] + 1e-3):.3f}, "
            "max |gradient| " + ", ".join(
                f"{k} {v[1][r[2]].abs().max().item():.3e}"
                for k, v in steps.items())
            + f"; the largest gradient of all {floor / 1e-4:.3e}")
    if bad:
        log(f"  gradients beyond it: {bad[:10]}")
    if not (fwd > 0 and bwd > 0 and loss_err <= 2e-3 and not bad
            and (gn["gn_silu"] > 0) == fused and gn["gn_silu_conv"] == 0):
        raise AssertionError("the tiny train step on the card disagrees "
                             "with the CPU plain version")


class StageTimer:
    """Device time per module, from CUDA events recorded by forward hooks
    (no synchronisation inside the run)."""

    def __init__(self, modules):
        import torch
        self.pairs = {name: [] for name in modules}
        self.handles = []
        for name, mod in modules.items():
            def pre(_m, _a, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.pairs[name].append([ev, None])

            def post(_m, _a, _o, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.pairs[name][-1][1] = ev

            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]

    def take(self):
        """{name: seconds} since the last take (after a synchronize)."""
        out = {name: sum(s.elapsed_time(e) for s, e in pairs) / 1e3
               for name, pairs in self.pairs.items()}
        for pairs in self.pairs.values():
            pairs.clear()
        return out

    def close(self):
        for h in self.handles:
            h.remove()


def clip_request(models, pcfg, classes, g, sampler_opts=None,
                 video_opts=None):
    """One full-width clip: stage 3 (`run_stage3`: keyframes in enhance
    mode, the blurry-video decode, the 256-px artifacts) then stage 5
    (`run_stage5`), each ending in a synchronize; `sampler_opts` and
    `video_opts` are the two stages' fast-path options. Returns (stage-3
    artifacts, stage-5 outputs, stage-3 s, stage-5 s on the host clock)."""
    import torch
    from neurons_tpu_torch.pipelines import e2e

    dec, unet, vae, text, unet3d, cn = models
    voxel = 0.5 * torch.randn((1, 1, pcfg.brain.voxel_counts[0]),
                              generator=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = e2e.run_stage3(dec, unet, vae, voxel, classes, pcfg.sampler,
                         latent_hw=96, artifact_hw=256, caption_len=60,
                         generator=g, sampler_opts=sampler_opts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vid = e2e.run_stage5(text, unet3d, cn, vae, art, pcfg.sampler,
                         generator=g, **(video_opts or {}))
    torch.cuda.synchronize()
    return art, vid, t1 - t0, time.perf_counter() - t1


def clip_checks(art, vid):
    """{check: passed} on one clip's outputs."""
    import torch
    out = art.outputs
    return {
        "keyframes [1,3,768,768]": out.keyframes.shape == (1, 3, 768, 768),
        "keyframe artifact [1,3,256,256]": art.keyframe.shape == (1, 3, 256,
                                                                  256),
        "blurry artifact [1,6,3,256,256]": art.blurry_video.shape == (
            1, 6, 3, 256, 256),
        "captions [1,60]": out.captions.shape == (1, 60),
        "prior tokens [1,256,1664]": out.prior_tokens.shape == (1, 256, 1664),
        "latents [1,4,16,32,32]": vid.latents.shape == (1, 4, 16, 32, 32),
        "video [1,16,3,256,256]": vid.video.shape == (1, 16, 3, 256, 256),
        "finite": all(bool(torch.isfinite(x).all()) for x in
                      (out.keyframes, art.blurry_video, out.prior_tokens,
                       out.cls_logits, out.seg_masks, vid.latents,
                       vid.video)),
        "keyframes and video in [0,1]": all(
            bool((x >= 0).all() and (x <= 1).all())
            for x in (out.keyframes, vid.video)),
        # a convex resize of values in [0, 1], up to f32 rounding
        "artifacts in [0,1] to 1e-6": all(
            bool((x >= -1e-6).all() and (x <= 1 + 1e-6).all())
            for x in (art.keyframe, art.blurry_video)),
    }


def build_clip():
    """The full-width clip's models (stage 3's and stage 5's), bf16, seeded
    random weights. Returns (models, pipeline config)."""
    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import GPT2Config

    t0 = time.perf_counter()
    pcfg = config.PipelineConfig()
    models = build_models((pcfg, GPT2Config()), "cuda", torch.bfloat16, SEED)
    models += build_video_models(pcfg, CLIPTextConfig.sd15(), "cuda",
                                 torch.bfloat16, SEED)
    torch.cuda.synchronize()
    n_params = [sum(p.numel() for p in m.parameters()) for m in models]
    log(f"slice: built full-width models ({sum(n_params) / 1e9:.3f} B "
        f"params, bf16, of which stage 5's own {sum(n_params[3:]) / 1e9:.3f}"
        f" B) in {time.perf_counter() - t0:.1f} s")
    return models, pcfg


def clip_gn_launches(models, pcfg, fused: bool):
    """#7 and #8 launches of one clip, counted from the code: in the
    fused-norm configuration every res-block norm/conv pair of the unCLIP
    UNet (and its head) runs #8 at each of `unclip_steps` calls, those of
    UNet3D and SparseCtrl at each of `video_steps` calls; every other
    GroupNormSiLU runs #7: the VAE decoder's 1 + n_frames + 1 calls (the
    keyframe, the blurry frames one at a time, the 16 video frames in one
    chunk), its encoder's 2 (the interpolated blurry video, the keyframe)
    and the seg/blurry decoder's 2 (the seg masks, the blurry latents).
    Unfused, neither kernel runs."""
    if not fused:
        return {"gn_silu": 0, "gn_silu_conv": 0}
    dec, unet, vae, _, unet3d, cn = models
    s = pcfg.sampler
    vae_decodes = 1 + pcfg.decoupler.n_frames + 1
    return {"gn_silu": (gn_sites(vae.decoder) * vae_decodes
                        + gn_sites(vae.encoder) * 2
                        + gn_sites(dec.text_seg_dec) * 2),
            "gn_silu_conv": (gn_sites(unet) * s.unclip_steps
                             + (gn_sites(unet3d) + gn_sites(cn))
                             * s.video_steps)}


def clip_run(models, pcfg, fused: bool, n_requests: int = CLIP_REQUESTS):
    """`n_requests` full-width clips one at a time in one configuration (the
    caller sets it), the same seeds in either; the kernels' launch counts
    zeroed just before and read just after, #7/#8 held to the count from
    the code. Returns ({kernel: launches by shape}, the request context,
    the last request's s, the first request's (artifacts, video))."""
    import torch
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES

    name = config_name(fused)
    dec, unet, vae, text, unet3d, cn = models
    g = torch.Generator("cuda").manual_seed(SEED)
    classes = torch.randn((pcfg.decoupler.num_classes,
                           pcfg.decoupler.clip_txt_emb_dim), generator=g,
                          device="cuda")
    ctx = (models, pcfg, classes, g)
    timer = StageTimer({"brain encoder": dec.core, "prior": dec.prior_net,
                        "seg+blurry decoder": dec.text_seg_dec,
                        "caption": dec.text_dec.lm, "unclip unet": unet,
                        "vae encode": vae.encoder, "vae decode": vae.decoder,
                        "text tower": text, "unet3d": unet3d,
                        "sparsectrl": cn})
    counters = {"flash_attn_fwd": FLASH_FWD_LAUNCHES,
                "temporal_attn_fwd": TEMPORAL_ATTN_LAUNCHES, **gn_counters()}
    expected = clip_gn_launches(models, pcfg, fused)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    per_request = []
    for r in range(n_requests):
        launched0 = {k: c.total for k, c in counters.items()}
        art, vid, s3, s5 = clip_request(*ctx)
        split = timer.take()
        launches = {k: c.total - launched0[k] for k, c in counters.items()}
        split_s = " ".join(f"{k}={v:.3f}" for k, v in split.items())
        log(f"slice {name} request {r}: {s3 + s5:.3f} s per clip (stage 3 "
            f"{s3:.3f} s, stage 5 {s5:.3f} s)  launches {launches}  device "
            f"split (s): {split_s}")
        failed = [k for k, ok in clip_checks(art, vid).items() if not ok]
        if failed:
            raise AssertionError(f"slice outputs fail {failed}")
        got = {k: launches[k] for k in expected}
        if got != expected:
            raise AssertionError(f"{name} clip: #7/#8 launches {got} differ "
                                 f"from the count from the code {expected}")
        per_request.append(s3 + s5)
        if r == 0:
            first = (art, vid)
    by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
    timer.close()
    peak = torch.cuda.max_memory_allocated()
    totals = {k: c.total for k, c in counters.items()}
    per_clip = {k: v / n_requests for k, v in totals.items()}
    log(f"slice {name}: {n_requests} requests, s/clip "
        f"{[round(s, 3) for s in per_request]}, launches {totals} "
        f"({per_clip} per clip; #7/#8 as counted from the code: "
        f"{expected}), max_memory_allocated {peak / 2**30:.2f} GiB")
    for kernel in ("flash_attn_fwd", "temporal_attn_fwd", *(
            k for k in expected if fused)):
        if totals[kernel] == 0:
            raise AssertionError(f"the {name} clip launched no {kernel}")
    return by_shape, ctx, per_request[-1], first


def slice_phase():
    """The full-width clip in both configurations on the same models and
    seeds: unfused, then the fast configurations (unfused), then fused;
    each clip 2 counted requests and 1 profiled; then one UNet2D and one
    UNet3D forward in both. Returns ({fused: {kernel: launches by shape}}, the
    fast phase's {configuration: {kernel: launches by shape}}, the first
    unfused clip's keyframe artifact and video on the host)."""
    import torch

    models, pcfg = build_clip()
    by_config = {}
    for fused in (False, True):
        with configuration(fused):
            by_shape, ctx, steady_s, first = clip_run(models, pcfg, fused)
            profile_request(ctx, steady_s, fused)
            del ctx
            if not fused:
                # before the fused clip, whose packed #8 weights stay
                # cached and would count in the fast clips' peak memory
                fast_by_config = fast_phase(models, pcfg, by_shape, first)
                sample = (first[0].keyframe.float().cpu(),
                          first[1].video.float().cpu())
        by_config[fused] = by_shape
        del first
    fused_forward_check(models, pcfg)
    del models
    torch.cuda.empty_cache()
    return by_config, fast_by_config, sample


# --- the fast paths ----------------------------------------------------------

# the fast configurations of the full-width clip: (stage-3 `unclip_sample`
# options, stage-5 `reconstruct_video` keywords); "max" is the CLI's preset
# (config.FAST_PRESETS), the others bench.py's knobs (BENCH_PAB_KF=2,8
# BENCH_PAB=2,4,8 BENCH_PAB_RANGE=2,23; BENCH_ENC_REUSE=2; BENCH_DEEPCACHE=3)
FAST_CONFIGS = {
    "pab": ({"pab": (2, 8), "pab_range": (2, 23)},
            {"pab": (2, 4, 8), "pab_range": (2, 23)}),
    "encoder_reuse": ({"encoder_reuse": 2}, {"encoder_reuse": 2}),
    "deep_cache": ({"deep_cache": 3}, {}),
}
FAST_PRESET = "max"


def small_fast_check():
    """Every fast branch at tiny size, f32, on the card against the CPU on
    the same weights and draws, under the small checks' gates (2e-2 * max
    |CPU|: the card's attention multiplies in TF32): `unclip_sample`'s
    TGATE, TGATE x PAB, PAB, DeepCache and encoder reuse over 6 steps at
    32x32 latents (the flash kernel at the 256-token sites), and
    `reconstruct_video`'s TGATE, TGATE x PAB, PAB and encoder reuse with
    SparseCtrl over 6 steps of 4 frames at 16x16 latents (flash and the
    temporal kernel); the schedules take every branch's capture and reuse
    arms. Then the RGB-condition SparseCtrl through `reconstruct_video`
    (3 steps, the keyframe at 128 px) and `ddim_inversion` through the
    UNet3D (4 steps)."""
    import copy

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.diffusion.ddim import DDIMScheduler, ddim_inversion
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES
    from neurons_tpu_torch.pipelines import keyframe as kf
    from neurons_tpu_torch.pipelines.video import reconstruct_video
    from neurons_tpu_torch.utils.synth_init import synth_params_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = config.tiny_pipeline_config()
    pcfg = config.replace(pcfg, unet2d=config.replace(pcfg.unet2d,
                                                      adm_in_channels=1024))
    g = torch.Generator().manual_seed(SEED)
    failed = []

    def compare(what, run, names):
        """run(device) -> outputs on that device; `names` the attributes
        compared (None: the output itself)."""
        f0, t0 = FLASH_FWD_LAUNCHES.total, TEMPORAL_ATTN_LAUNCHES.total
        ref, got = run("cpu"), run("cuda")
        launches = (FLASH_FWD_LAUNCHES.total - f0,
                    TEMPORAL_ATTN_LAUNCHES.total - t0)
        errs = {}
        for name in names:
            a = got if name is None else getattr(got, name)
            r = ref if name is None else getattr(ref, name)
            a = a.cpu()
            errs[name or "out"] = ((a - r).abs().max()
                                   / r.abs().max()).item()
        ok = all(e <= 2e-2 for e in errs.values()) and launches[0] > 0
        log(f"small fast check {what}: launches flash {launches[0]}, "
            f"temporal {launches[1]}; rel err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (<= 2e-2)  {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
        return launches

    # stage 3: unclip_sample
    lat, b, steps = 32, 1, 6
    _, unet, vae = build_models((pcfg, tiny_gpt2_config()), "cpu",
                                torch.float32, 7)
    nets = {"cpu": (unet, vae), "cuda": tuple(copy.deepcopy(m).to("cuda")
                                              for m in (unet, vae))}
    c = pcfg.brain
    tokens = torch.randn((b, c.clip_seq_dim, c.clip_emb_dim), generator=g)
    noise = kf.UnclipNoise(torch.randn((b, 4, lat, lat), generator=g),
                           torch.randn((b, 4, lat, lat), generator=g),
                           torch.randn((b,), generator=g),
                           torch.randn(tokens.shape, generator=g))
    for name, opts in (("tgate", dict(tgate_step=3)),
                       ("tgate_pab", dict(tgate_step=2, tgate_pab=2)),
                       ("pab", dict(pab=(2, 4), pab_range=(1, 5))),
                       ("deep_cache", dict(deep_cache=3)),
                       ("encoder_reuse", dict(encoder_reuse=3))):
        compare(f"unclip_sample {name}", lambda dev, opts=opts:
                kf.unclip_sample(*nets[dev], tokens.to(dev), num_steps=steps,
                                 latent_hw=lat, noise=noise, **opts), [None])

    # stage 5: reconstruct_video with SparseCtrl
    f, px = pcfg.sampler.n_video_frames, 32
    vae = synth_params_(AutoencoderKL(pcfg.vae, device="cpu").eval(), 8)
    _, unet3d, cn = build_video_models(pcfg, CLIPTextConfig.tiny(), "cpu",
                                       torch.float32, 7)
    rgb = synth_params_(SparseControlNetModel(
        pcfg.unet3d, n_frames=f, conditioning_channels=3,
        use_simplified_condition_embedding=False, device="cpu").eval(), 9)
    nets = {"cpu": (unet3d, cn, vae, rgb),
            "cuda": tuple(copy.deepcopy(m).to("cuda")
                          for m in (unet3d, cn, vae, rgb))}
    ctx = pcfg.unet3d.cross_attention_dim
    blurry = torch.rand((b, 2, 3, px, px), generator=g)
    keyframe = torch.rand((b, 3, px, px), generator=g)
    keyframe_rgb = torch.rand((b, 3, 8 * px // 2, 8 * px // 2), generator=g)
    text = torch.randn((b, 5, ctx), generator=g)
    uncond = torch.randn((b, 5, ctx), generator=g)
    vnoise = torch.randn((b, 4, f, px // 2, px // 2), generator=g)

    def video(dev, rgb_cond=False, n=steps, **opts):
        u3, cnet, v, rcn = nets[dev]
        return reconstruct_video(
            u3, rcn if rgb_cond else cnet, v, blurry,
            keyframe_rgb if rgb_cond else keyframe, text, uncond,
            num_steps=n, n_frames=f, use_simplified_cond=not rgb_cond,
            noise=vnoise, device=dev, **opts)

    for name, opts in (("tgate", dict(tgate_step=2)),
                       ("tgate_pab", dict(tgate_step=2, tgate_pab=2)),
                       ("pab", dict(pab=(2, 4, 8), pab_range=(2, 5))),
                       ("encoder_reuse", dict(encoder_reuse=2))):
        launched = compare(f"reconstruct_video {name}",
                           lambda dev, opts=opts: video(dev, **opts),
                           ["latents", "video"])
        if launched[1] == 0:
            failed.append(f"reconstruct_video {name}: no temporal launch")
    compare("reconstruct_video RGB condition",
            lambda dev: video(dev, rgb_cond=True, n=3), ["latents", "video"])
    x = torch.randn((b, 4, f, px // 2, px // 2), generator=g)

    def inversion(dev):
        u3 = nets[dev][0]
        with torch.inference_mode():
            return ddim_inversion(
                DDIMScheduler.create(10, device=dev),
                lambda xx, tt: u3(xx, tt.float(), text.to(dev)), x.to(dev), 4)

    compare("ddim_inversion", inversion, [None])
    if failed:
        raise AssertionError(f"tiny fast paths on the card disagree with "
                             f"the CPU: {failed}")


def attn_site_launches(model, latent, rows, n_levels, up_by_level,
                       which=("self", "cross", "temporal"),
                       sites=lambda name: True, context_tokens=0,
                       dtype="bfloat16"):
    """({flash key: launches}, {temporal key: launches}) of one forward of
    `model` (a UNetModel, UNet3DModel or SparseControlNetModel) at `rows`
    batch rows (B, or B*F folded frames), counted from its attention
    sites: each transformer site's self-attention (and cross-attention over
    `context_tokens`) launches the flash kernel once a block where both
    token counts reach 128, each motion module the temporal kernel once an
    attention. `which` and `sites` (a test on the site's name) pick the
    attentions a step runs. A site's resolution is latent / 2^level; the
    UNet2D names up sites by level, the UNet3D by up block
    (`up_by_level` False: level = n_levels - 1 - block)."""
    import collections
    from neurons_tpu_torch.models.unet2d import SpatialTransformer
    from neurons_tpu_torch.models.unet3d import MotionModule, Transformer3D

    flash, temporal = collections.Counter(), collections.Counter()
    for name, mod in model.named_children():
        if not (isinstance(mod, (SpatialTransformer, Transformer3D,
                                 MotionModule)) and sites(name)):
            continue
        if name.startswith("mid"):
            level = n_levels - 1
        else:
            where, i = name.split("_")[:2]
            level = (int(i) if where == "down" or up_by_level
                     else n_levels - 1 - int(i))
        tokens = (latent >> level) ** 2
        if isinstance(mod, (SpatialTransformer, Transformer3D)):
            attn1 = (mod.block_0.attn1 if isinstance(mod, SpatialTransformer)
                     else mod.block_0_attn1)
            key = (rows, attn1.heads, tokens)
            if "self" in which and tokens >= 128:
                flash[key + (tokens, attn1.dim_head, dtype, "")] += mod.depth
            if ("cross" in which and tokens >= 128
                    and context_tokens >= 128):
                flash[key + (context_tokens, attn1.dim_head, dtype,
                             "")] += mod.depth
        elif isinstance(mod, MotionModule) and "temporal" in which:
            attn = mod.block_0_attn_0
            temporal[(rows, tokens, mod.proj_in.in_features, mod.n_frames,
                      attn.heads, dtype)] += mod.num_blocks * mod.n_attn
    return flash, temporal


def sampler_launches(models, pcfg, s3_opts, s5_opts, latents=(96, 32),
                     batch=1, dtype="bfloat16"):
    """{"flash_attn_fwd": {key: n}, "temporal_attn_fwd": {key: n}} of one
    clip's two samplers (the unCLIP UNet over `unclip_steps` at
    latents[0], the UNet3D and SparseCtrl over `video_steps` at latents[1];
    `batch` clips; the models' `dtype`), counted
    from the step schedule the options give, branch for branch as the
    samplers take them:
      stage 3, on the CFG batch 2B unless gated: a full (or capture) step
      runs every self- and cross-attention; TGATE's gated steps the
      self-attentions at batch B, or under TGATE x PAB only every
      tgate_pab-th gated step; PAB (i_s, i_x): full steps all, spatial
      recomputes the self-attentions, reuse steps none; DeepCache's cached
      steps the level-0 sites, encoder reuse's the mid and up sites;
      stage 5, on 2B x F rows unless gated: a full step the UNet3D's
      self- and temporal attentions and SparseCtrl's; TGATE's gated steps
      the UNet3D's at B x F rows and no SparseCtrl (under TGATE x PAB every
      tgate_pab-th gated step, none in between); PAB: SparseCtrl every
      step, the UNet3D all (full, cross reused), self only (cross and
      temporal reused) or none; encoder reuse's cached steps the UNet3D's
      mid and up sites and no SparseCtrl.
    The 77-token text cross-attention of stage 5 is never a flash
    launch."""
    import collections

    _, unet, _, _, unet3d, cn = models
    s = pcfg.sampler
    flash, temporal = collections.Counter(), collections.Counter()

    def add(counts, times=1):
        for total, part in zip((flash, temporal), counts):
            for k, v in part.items():
                total[k] += v * times

    n2 = len(pcfg.unet2d.channel_mult)
    ctx = pcfg.brain.clip_seq_dim
    b2, b1 = 2 * batch, batch  # the CFG batch and a gated one

    def step2(rows, which=("self", "cross"), sites=lambda n: True):
        return attn_site_launches(unet, latents[0], rows, n2, True, which,
                                  sites, ctx, dtype)

    n = s.unclip_steps
    if s3_opts.get("tgate_step", 0) > 0:
        m = min(max(int(s3_opts["tgate_step"]), 1), n)
        p = s3_opts.get("tgate_pab", 0)
        add(step2(b2), m)
        for j in range(n - m):
            if p <= 1 or j % p == 0:
                add(step2(b1, ("self",)))
    elif s3_opts.get("pab") is not None:
        i_s, i_x = s3_opts["pab"]
        lo, hi = s3_opts.get("pab_range") or (0, n)
        for i in range(n):
            if i % i_x == 0 or i < lo or i >= hi:
                add(step2(b2))
            elif i % i_s == 0:
                add(step2(b2, ("self",)))
    elif s3_opts.get("deep_cache", 0) > 1:
        k = s3_opts["deep_cache"]
        for i in range(n):
            add(step2(b2) if i % k == 0 else step2(
                b2, sites=lambda name: name.split("_")[:2] in (
                    ["down", "0"], ["up", "0"])))
    elif s3_opts.get("encoder_reuse", 1) > 1:
        k = s3_opts["encoder_reuse"]
        for i in range(n):
            add(step2(b2) if i % k == 0 else step2(
                b2, sites=lambda name: not name.startswith("down")))
    else:
        add(step2(b2), n)

    n3 = len(pcfg.unet3d.block_out_channels)
    f = s.n_video_frames

    def step3(rows, which=("self", "temporal"), sites=lambda n: True):
        return attn_site_launches(unet3d, latents[1], rows, n3, False, which,
                                  sites, dtype=dtype)

    def control():
        return attn_site_launches(cn, latents[1], 2 * batch * f, n3, False,
                                  dtype=dtype)

    n = s.video_steps
    if s5_opts.get("tgate_step", 0) > 0:
        m = min(max(int(s5_opts["tgate_step"]), 1), n)
        p = s5_opts.get("tgate_pab", 0)
        add(step3(2 * batch * f), m)
        add(control(), m)
        for j in range(n - m):
            if p <= 1 or j % p == 0:
                add(step3(batch * f))
    elif s5_opts.get("pab") is not None:
        i_s, i_t, i_c = s5_opts["pab"]
        lo, hi = s5_opts.get("pab_range") or (0, n)
        for i in range(n):
            add(control())
            if i % i_c == 0 or i < lo or i >= hi or i % i_t == 0:
                add(step3(2 * batch * f))
            elif i % i_s == 0:
                add(step3(2 * batch * f, ("self",)))
    elif s5_opts.get("encoder_reuse", 1) > 1:
        k = s5_opts["encoder_reuse"]
        for i in range(n):
            if i % k == 0:
                add(step3(2 * batch * f))
                add(control())
            else:
                add(step3(2 * batch * f, sites=lambda name: not
                          name.startswith("down")))
    else:
        add(step3(2 * batch * f), n)
        add(control(), n)
    return {"flash_attn_fwd": dict(flash), "temporal_attn_fwd": dict(temporal)}


def check_launches(name, measured, n_clips, predicted, exact_measured,
                   exact_clips, exact_predicted):
    """`measured` {kernel: {key: launches}} of `n_clips` clips against the
    count from the code: at every shape the samplers launch (those
    `sampler_launches` gives for this configuration or the exact one),
    `predicted` x n_clips; at every other shape (the VAE's and the
    DecoderVideo's, which no sampler option changes), the exact clip's
    own launches (`exact_measured` over `exact_clips` clips) per clip x
    n_clips."""
    problems = []
    for kernel in predicted:
        sampler_keys = set(predicted[kernel]) | set(exact_predicted[kernel])
        keys = sampler_keys | set(measured.get(kernel, {})) | set(
            exact_measured.get(kernel, {}))
        for key in sorted(keys, key=str):
            want = (predicted[kernel].get(key, 0) * n_clips
                    if key in sampler_keys
                    else exact_measured[kernel].get(key, 0) // exact_clips
                    * n_clips)
            got = measured.get(kernel, {}).get(key, 0)
            if got != want:
                problems.append(f"{kernel} {key}: {got} launched, {want} "
                                f"from the code")
    per_clip = {k: sum(v.values()) for k, v in predicted.items()}
    log(f"fast {name}: sampler launches per clip from the schedule "
        f"{per_clip}; measured launches equal the count from the code: "
        f"{not problems}")
    if problems:
        raise AssertionError(f"fast {name}: launches differ from the count "
                             f"from the code: {problems[:8]}")


def rms_rel(a, b) -> float:
    """rms(a - b) / rms(b), the JAX README's proxy deviation."""
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def fast_phase(models, pcfg, exact_by_shape, exact_first):
    """The fast configurations of the full-width clip, unfused, on the
    exact clip's models and seeds: the "max" preset for 2 requests (the
    launch counts zeroed just before and read just after, held to the
    schedule's count; s/clip by stage; peak memory), then one profiled
    request (wall, busy, idle share); then one request each of PAB,
    encoder reuse and DeepCache, each held to its count. Every first
    request replays the exact clip's first request's draws, so its
    keyframe and video are compared with the exact ones (rms deviation,
    recorded, not gated); for the preset also stage 5 alone, on the exact
    clip's stage-3 artifacts. Returns {configuration: {kernel: launches by
    shape}}."""
    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES
    from neurons_tpu_torch.pipelines import e2e

    counters = {"flash_attn_fwd": FLASH_FWD_LAUNCHES,
                "temporal_attn_fwd": TEMPORAL_ATTN_LAUNCHES}
    exact_art, exact_vid = exact_first
    exact_predicted = sampler_launches(models, pcfg, {}, {})
    check_launches("exact (the unfused clip)", exact_by_shape, CLIP_REQUESTS,
                   exact_predicted, exact_by_shape, CLIP_REQUESTS,
                   exact_predicted)
    configs = {FAST_PRESET: config.fast_options(FAST_PRESET), **FAST_CONFIGS}
    out = {}
    for name, (s3_opts, s5_opts) in configs.items():
        n_requests = CLIP_REQUESTS if name == FAST_PRESET else 1
        g = torch.Generator("cuda").manual_seed(SEED)
        classes = torch.randn((pcfg.decoupler.num_classes,
                               pcfg.decoupler.clip_txt_emb_dim), generator=g,
                              device="cuda")
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        per_request = []
        for r in range(n_requests):
            art, vid, s3, s5 = clip_request(models, pcfg, classes, g,
                                            s3_opts, s5_opts)
            failed = [k for k, ok in clip_checks(art, vid).items() if not ok]
            if failed:
                raise AssertionError(f"fast {name} outputs fail {failed}")
            per_request.append((s3, s5))
            if r == 0:
                dev_kf = rms_rel(art.outputs.keyframes,
                                 exact_art.outputs.keyframes)
                dev_vid = rms_rel(vid.video, exact_vid.video)
            log(f"fast {name} request {r}: {s3 + s5:.3f} s per clip "
                f"(stage 3 {s3:.3f} s, stage 5 {s5:.3f} s)")
        by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check_launches(name, by_shape, n_requests, sampler_launches(
            models, pcfg, s3_opts, s5_opts), exact_by_shape, CLIP_REQUESTS,
            exact_predicted)
        check_shapes(f"fast {name}", by_shape)
        log(f"fast {name} (stage 3 {s3_opts}, stage 5 {s5_opts}): "
            f"{n_requests} requests, s/clip "
            f"{[round(a + b, 3) for a, b in per_request]} (stage 3 "
            f"{[round(a, 3) for a, _ in per_request]}, stage 5 "
            f"{[round(b, 3) for _, b in per_request]}), launches "
            f"{ {k: c.total for k, c in counters.items()} }, "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; rms deviation "
            f"from the exact clip: keyframe {dev_kf:.4f}, video (chained) "
            f"{dev_vid:.4f}")
        out[name] = by_shape
        if name != FAST_PRESET:
            continue
        # stage 5 alone on the exact clip's stage-3 artifacts
        g5 = torch.Generator("cuda").manual_seed(SEED + 1)
        vid5 = {}
        for label, opts in (("exact", {}), ("fast", s5_opts)):
            g5.manual_seed(SEED + 1)
            vid5[label] = e2e.run_stage5(
                models[3], models[4], models[5], models[2], exact_art,
                pcfg.sampler, generator=g5, **opts).video
        log(f"fast {name}: stage 5 alone on the exact stage-3 artifacts, "
            f"rms deviation {rms_rel(vid5['fast'], vid5['exact']):.4f}")
        del vid5
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, s3, s5 = clip_request(models, pcfg, classes, g, s3_opts,
                                        s5_opts)
        device_profile(prof, s3 + s5,
                       f"fast {name} clip (stage 3 {s3:.3f} s, stage 5 "
                       f"{s5:.3f} s; unprofiled steady clip "
                       f"{sum(per_request[-1]):.3f} s)", PROFILE_KERNELS)
    return out


def check_shapes(what, by_shape):
    """Every (kernel, shape) a run launched was checked in the kernel
    phase (FLASH_SHAPES and TEMPORAL_SHAPES, bf16)."""
    flash = {shape + ("bfloat16", "") for _, shape in FLASH_SHAPES}
    temporal = {shape + (N_FRAMES, MOTION_HEADS, "bfloat16")
                for _, shape in TEMPORAL_SHAPES}
    bad = ([k for k in by_shape["flash_attn_fwd"] if k not in flash]
           + [k for k in by_shape["temporal_attn_fwd"] if k not in temporal])
    if bad:
        raise AssertionError(f"{what} launched shapes the kernel phase did "
                             f"not check: {bad}")


@contextlib.contextmanager
def flash_plain_f32():
    """The flash forward's plain version in full f32 on the card (the
    kernel's f32 route multiplies in TF32)."""
    from neurons_tpu_torch.ops import attention as attn

    fwd = attn.flash_attention_fwd

    def plain(q, k, v, scale=None, bias=None, return_lse=False):
        return attn.attention_reference(q, k, v, bias=bias, scale=scale)

    attn.flash_attention_fwd = plain
    try:
        yield
    finally:
        attn.flash_attention_fwd = fwd


def fused_forward_check(models, pcfg):
    """One full-width UNet2D forward (the unCLIP CFG batch at 96x96
    latents) and one UNet3D forward (16 frames of 32x32, CFG batch) on the
    same inputs, unfused and fused in bf16, both against the same forward
    in f32 (a copy of the weights, plain f32 attention, no TF32): the fused
    error within 1.5x the unfused one, the rule the kernels are held to.
    Their gap to each other is printed beside it: two bf16 paths that
    round in other places (the kernel adds the conv bias before rounding,
    the composite after) drift apart through the network, and the gap
    says nothing of which one is off."""
    import copy

    import torch

    _, unet, _, _, unet3d, _ = models
    g = torch.Generator("cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    u2, u3 = pcfg.unet2d, pcfg.unet3d
    t2 = torch.full((2,), 500.0, device="cuda")
    cases = {
        "unet2d": (unet, (randn(2, u2.in_channels, 96, 96), t2,
                          randn(2, 256, u2.context_dim),
                          randn(2, u2.adm_in_channels))),
        "unet3d": (unet3d, (randn(2, u3.in_channels,
                                  pcfg.sampler.n_video_frames, 32, 32), t2,
                            randn(2, 77, u3.cross_attention_dim))),
    }
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (net, args) in cases.items():
        outs = {}
        for fused in (False, True):
            with configuration(fused), torch.inference_mode():
                outs[fused] = net(*args).float()
        net32 = copy.deepcopy(net).float()
        with configuration(False), flash_plain_f32(), torch.inference_mode():
            ref = net32(*(a.float() for a in args))
        del net32
        torch.cuda.empty_cache()
        scale = ref.abs().max()
        err = {f: ((o - ref).abs().max() / scale).item()
               for f, o in outs.items()}
        gap = ((outs[True] - outs[False]).abs().max()
               / outs[False].abs().max()).item()
        ok = (bool(torch.isfinite(outs[True]).all())
              and err[True] <= 1.5 * err[False])
        log(f"fused forward {name} {list(args[0].shape)}: max error / max "
            f"|f32| fused {err[True]:.3e}, unfused {err[False]:.3e} (fused "
            f"<= 1.5x unfused); fused vs unfused gap {gap:.3e}  "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the fused {name} forward is less accurate "
                                 f"than the unfused one: {err}")


def device_profile(prof, wall: float, what: str, kernels):
    """Log the device's busy time (the sum of kernel and copy times on the
    one stream) in a profiled run of `wall` seconds, the idle share they
    give, each kernel's share of busy time ({label: symbol}) and the top
    kernels."""
    import torch

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log(f"profile: the profiler recorded no device time; busy time of "
            f"the {what} not measured")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    shares = []
    for kernel, symbols in kernels.items():
        sec = sum(dev_us(e) for e in events
                  if any(sym in e.key for sym in symbols)) / 1e6
        shares.append(f"{kernel} kernel {sec:.3f} s ({sec / busy:.3f} of "
                      f"busy)")
    log(f"profile: {what}: wall {wall:.3f} s under the profiler, device "
        f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f}; "
        + "; ".join(shares))
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(e) / 1e3:10.2f} ms {e.count:6d}x  {e.key[:100]}")


# {label: kernel symbols} whose share of busy time a profile reports; #7's
# cluster kernel (one launch) and its two-launch pair (csrc/gn_silu.cu);
# #8's statistics carry the prefix gn_conv_stats_ (csrc/gn_common.cuh)
GN_SILU_SYMBOLS = ("gn_silu_cluster_kernel", "gn_silu_stats_kernel",
                   "gn_silu_apply_kernel")
# (the forward's three kernels: flash_fwd_reg_kernel, flash_fwd_wide_kernel,
# flash_fwd_kernel; #8's halo, split-reduce and TF32 kernels)
FLASH_FWD_SYMBOLS = ("flash_fwd_",)
# the backward's passes: flash_bwd_dkdv_reg_kernel, flash_bwd_dq_reg_kernel
# and, for the prior's per-head bias, flash_bwd_dbias_reg_kernel (bf16,
# d <= 128); flash_bwd_dkdv_kernel and flash_bwd_dq_kernel (the WMMA
# kernels of f32 and d > 128)
FLASH_BWD_SYMBOLS = {"flash backward dk/dv": ("flash_bwd_dkdv_",),
                     "flash backward dq": ("flash_bwd_dq_",),
                     "flash backward dbias": ("flash_bwd_dbias_",)}
PROFILE_KERNELS = {"flash": FLASH_FWD_SYMBOLS,
                   "temporal": ("temporal_tc_kernel",
                                "temporal_fwd_kernel"),
                   "gn_silu #7": GN_SILU_SYMBOLS,
                   "gn_silu_conv #8 (statistics + conv)": (
                       "gn_conv_stats", "gn_silu_conv_"),
                   "#8 statistics": ("gn_conv_stats",)}


def profile_request(ctx, steady_s: float, fused: bool):
    """One more clip, after the counted run, under torch.profiler with
    device activity only: its wall time and the device's busy time come
    from the same run. `steady_s` is the unprofiled steady clip's time,
    printed beside it so the profiler's own cost shows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, s3, s5 = clip_request(*ctx)
    device_profile(prof, s3 + s5,
                   f"{config_name(fused)} clip (stage 3 {s3:.3f} s, stage 5 "
                   f"{s5:.3f} s; unprofiled steady clip {steady_s:.3f} s)",
                   PROFILE_KERNELS)


# launches of one full-width stage-2 step, counted from the code: the
# prior's 6 layers take the biased forward and backward once each; the
# decoder's 7 spatial sites (3 at 16x16, 2 at 32x32, 2 at 64x64) run in 2
# checkpointed calls (seg, recon), each forward twice (the recompute) and
# backward once
STEP_LAUNCHES = {
    "flash_attn_fwd": {
        (10, 32, 513, 514, 52, "bfloat16", "bias+lse"): 6,
        (60, 1, 256, 256, 128, "bfloat16", "lse"): 12,
        (60, 1, 1024, 1024, 64, "bfloat16", "lse"): 8,
        (60, 1, 4096, 4096, 32, "bfloat16", "lse"): 8},
    "flash_attn_bwd": {
        (10, 32, 513, 514, 52, "bfloat16", "bias"): 6,
        (60, 1, 256, 256, 128, "bfloat16", ""): 6,
        (60, 1, 1024, 1024, 64, "bfloat16", ""): 4,
        (60, 1, 4096, 4096, 32, "bfloat16", ""): 4},
}


def stage2_batch(pcfg, gcfg, tcfg, gen):
    """One random batch at the real tables' shapes
    (`table_stage2_batch_builder`: 60 caption tokens, 224x224 key-object
    masks, 28x28 VAE latents), on the card."""
    import torch

    b, f = tcfg.batch_size, pcfg.decoupler.n_frames
    c, d = pcfg.brain, pcfg.decoupler

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def bits(p, *shape):
        return (torch.rand(shape, generator=gen, device="cuda") < p).float()

    tokens = torch.randint(1, gcfg.vocab_size, (b, 60), generator=gen,
                           device="cuda")
    length = torch.randint(8, 61, (b, 1), generator=gen, device="cuda")
    tokens = torch.where(torch.arange(60, device="cuda") < length, tokens, 0)
    return {
        "voxel": randn(b, 1, c.voxel_counts[0]),
        "clip_vision_target": randn(b, c.clip_seq_dim, c.clip_emb_dim),
        "clip_video_target": randn(b, f, c.clip_seq_dim, c.clip_emb_dim),
        "text_emb": randn(b, d.clip_txt_emb_dim),
        "key_obj_text_embed": randn(b, d.clip_txt_emb_dim),
        "key_obj_masks": bits(0.3, b, f, 224, 224),
        "cls_label": bits(0.2, b, d.num_classes),
        "clip_tokens": tokens,
        "vae_latents": randn(b, f, 4, 28, 28),
    }


def table_shaped_builder(pcfg, vocab, seed):
    """`run_stage2`'s batch builder at the real tables' shapes, random
    (numpy, from `seed`)."""
    import numpy as np

    g = np.random.default_rng(seed)
    c, f = pcfg.brain, pcfg.decoupler.n_frames

    def build(batch, epoch):
        b = len(batch["voxel"])
        return {
            "voxel": batch["voxel"][:, :1],
            "clip_vision_target": g.standard_normal(
                (b, c.clip_seq_dim, c.clip_emb_dim), np.float32),
            "clip_video_target": g.standard_normal(
                (b, f, c.clip_seq_dim, c.clip_emb_dim), np.float32),
            "text_emb": batch["text_emb"],
            "key_obj_text_embed": g.standard_normal(
                (b, pcfg.decoupler.clip_txt_emb_dim), np.float32),
            "key_obj_masks": batch["key_obj_masks"][:, :f],
            "cls_label": batch["cls_label"],
            "clip_tokens": (batch["clip_tokens"][:, :60] % vocab
                            ).astype(np.int32),
            "vae_latents": g.standard_normal((b, f, 4, 28, 28), np.float32),
        }

    return build


def train_phase():
    """Stage 2 at full width, unfused: a short `run_stage2` (the counted
    run) with its checkpoints and seg panel, its tags overlaid onto a fresh
    ensemble by `load_decoupler_params` (equal bits), then the fixed-batch
    timed steps and one profiled step; then the same steps fused
    (`fused_train_steps`). Returns ({kernel: launches by shape} of the
    counted run, the same of the fused steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch import config
    from neurons_tpu_torch.data import cc2017
    from neurons_tpu_torch.models.gpt2 import GPT2Config
    from neurons_tpu_torch.ops.attention import (FLASH_BWD_LAUNCHES,
                                                 FLASH_FWD_LAUNCHES)
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.training import loop
    from neurons_tpu_torch.training import train_decoupler as td
    from neurons_tpu_torch.utils import checkpoint as ckpt

    pcfg, gcfg = config.PipelineConfig(), GPT2Config()
    counters = {"flash_attn_fwd": FLASH_FWD_LAUNCHES,
                "flash_attn_bwd": FLASH_BWD_LAUNCHES}

    # the entry point: one epoch of 2 steps over 20 random clips
    tcfg = config.replace(pcfg.train, num_epochs=1)
    split = cc2017.synthetic_split(
        n=2 * tcfg.batch_size, n_voxels=pcfg.brain.voxel_counts[0],
        n_frames=pcfg.decoupler.n_frames, img=224,
        txt_dim=pcfg.decoupler.clip_txt_emb_dim,
        n_classes=pcfg.decoupler.num_classes, seed=SEED)
    rec = Recorder()
    with ckpt_tmpdir("stage-2 tags") as ckdir:
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        state = loop.run_stage2(
            pcfg.brain, pcfg.prior, pcfg.decoupler, tcfg, gcfg, split,
            table_shaped_builder(pcfg, gcfg.vocab_size, SEED), ckpt_dir=ckdir,
            log_every=1, logger=rec, bf16_frozen_core=True,
            last_save_every=1, image_log_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
        totals = {k: c.total for k, c in counters.items()}
        records = rec.rows
        log(f"train run_stage2: 1 epoch of {state.step} steps at full width "
            f"in {run_s:.1f} s (model build, saves and the seg panel "
            f"included); launches {totals}; epoch means " + " ".join(
                f"{k.split('/')[-1]} {v:.4f}" for k, v in records[-1].items()
                if k.startswith("train/")))
        log_saves("run_stage2")
        if any(v == 0 for v in totals.values()):
            raise AssertionError(f"run_stage2 launched no training kernel: "
                                 f"{totals}")
        if not all(torch.isfinite(torch.tensor(v))
                   for k, v in records[-1].items() if k.startswith("train/")):
            raise AssertionError("run_stage2 gave a non-finite epoch mean")
        check_panels(rec.images, 1, 4 * pcfg.decoupler.n_frames)
        # the tags overlaid onto a fresh ensemble give the trained state
        fresh = NeuronsDecoupler(pcfg.brain, pcfg.prior, pcfg.decoupler, gcfg)
        t0 = time.perf_counter()
        ckpt.load_decoupler_params(ckdir, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = all(torch.equal(p.to(state.params[n].dtype), state.params[n])
                   for n, p in fresh.named_parameters())
        log(f"train load_decoupler_params: {len(state.params)} tensors in "
            f"{load_s:.1f} s, equal to the trained state bitwise: {same}")
        if not same:
            raise AssertionError("the stage-2 tags do not give back the "
                                 "trained state")
        del state, fresh
        torch.cuda.empty_cache()

    # fixed batch and draws: 1 warm-up step, 3 timed steps
    tcfg = pcfg.train
    spe = tcfg.num_train_samples // tcfg.batch_size
    bundle, state = td.init_stage2(pcfg.brain, pcfg.prior, pcfg.decoupler,
                                   tcfg, gcfg, spe, seed=SEED)
    bundle.model.core.to(torch.bfloat16)  # run_stage2's bf16_frozen_core
    state = state._replace(params=dict(bundle.model.named_parameters()))
    n_core = sum(p.numel() for n, p in state.params.items() if td.is_core(n))
    n_train = sum(p.numel() for n, p in state.params.items()
                  if not td.is_core(n))
    gen = torch.Generator("cuda").manual_seed(SEED)
    batch = stage2_batch(pcfg, gcfg, tcfg, gen)
    draws = td.draw_stage2(bundle.diffusion, batch, pcfg.decoupler, gen)
    step = td.make_stage2_train_step(bundle, tcfg, pcfg.decoupler, spe)
    core0 = {n: p.clone() for n, p in state.params.items() if td.is_core(n)}
    train0 = {n: p.detach().clone() for n, p in state.params.items()
              if not td.is_core(n)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for i in range(FIXED_STEPS):
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        state, metrics = step(state, draws, batch, 0, i, tcfg.soft_temp_start)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        per_step.append({k: dict(c.by_shape) for k, c in counters.items()})
        if i == 0:
            first = {k: float(metrics[k]) for k in ("loss",) + td.LOSS_TERMS}
    peak = torch.cuda.max_memory_allocated()
    steady_ms = 1e3 * sum(times[1:]) / (FIXED_STEPS - 1)
    core_same = all(torch.equal(p, core0[n]) for n, p in state.params.items()
                    if td.is_core(n))
    moved = [n for n, p in state.params.items() if not td.is_core(n)
             and not torch.equal(p, train0[n])]
    with_grad = [n for n, p in state.params.items() if not td.is_core(n)
                 and bool(p.grad.any())]
    launches_ok = all(s == STEP_LAUNCHES for s in per_step)
    log(f"train steps: {n_train / 1e6:.1f} M trainable f32 parameters, "
        f"{n_core / 1e9:.3f} B frozen core in bf16; ms/step "
        f"{[round(1e3 * t, 1) for t in times]} (steady {steady_ms:.1f}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; loss "
        f"{[round(x, 4) for x in losses]}; launches per step "
        f"{ {k: sum(v.values()) for k, v in per_step[-1].items()} } "
        f"(as predicted: {launches_ok}); core bitwise unchanged {core_same}; "
        f"{len(moved)} of {len(train0)} trainable tensors moved, "
        f"{len(with_grad)} had a nonzero gradient")
    if not launches_ok:
        raise AssertionError(f"launches per step {per_step} differ from the "
                             f"count predicted from the code {STEP_LAUNCHES}")
    if not (losses[-1] < losses[0] and core_same
            and set(with_grad) <= set(moved) and len(moved) > 0):
        raise AssertionError("the full-width train steps fail their checks")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, draws, batch, 0, 4, tcfg.soft_temp_start)
        torch.cuda.synchronize()
    device_profile(prof, time.perf_counter() - t0,
                   f"stage-2 step (unprofiled steady {steady_ms:.1f} ms)",
                   {"flash forward": FLASH_FWD_SYMBOLS,
                    **FLASH_BWD_SYMBOLS})
    del state, bundle, core0, train0, step
    torch.cuda.empty_cache()
    with configuration(True):
        fused_by_shape = fused_train_steps(pcfg, gcfg, tcfg, spe, batch,
                                           draws, first, steady_ms)
    return by_shape, fused_by_shape


def fused_train_steps(pcfg, gcfg, tcfg, spe, batch, draws, unfused_first,
                      unfused_ms):
    """The fixed-batch steps in the fused-norm configuration (the caller
    sets it): the same seeded weights, batch and draws as the unfused
    steps; 1 warm-up and 3 timed steps, each held to the #7 launches
    counted from the code (every GroupNormSiLU of the model, all in the
    checkpointed DecoderVideo head, runs in 2 calls, each forward twice;
    no #8), the first step's losses to 2e-2 of the unfused first step's;
    then one profiled step. Returns {kernel: launches by shape} of the 4
    steps."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.training import train_decoupler as td

    bundle, state = td.init_stage2(pcfg.brain, pcfg.prior, pcfg.decoupler,
                                   tcfg, gcfg, spe, seed=SEED)
    bundle.model.core.to(torch.bfloat16)
    state = state._replace(params=dict(bundle.model.named_parameters()))
    step = td.make_stage2_train_step(bundle, tcfg, pcfg.decoupler, spe)
    counters = gn_counters()
    expected = {"gn_silu": 4 * gn_sites(bundle.model), "gn_silu_conv": 0}
    by_shape = {k: collections.Counter() for k in counters}
    times, per_step, losses = [], [], []
    for i in range(FIXED_STEPS):
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        state, metrics = step(state, draws, batch, 0, i, tcfg.soft_temp_start)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        per_step.append({k: c.total for k, c in counters.items()})
        for k, c in counters.items():
            by_shape[k].update(c.by_shape)
        if i == 0:
            first = {k: float(metrics[k]) for k in unfused_first}
    steady_ms = 1e3 * sum(times[1:]) / (FIXED_STEPS - 1)
    loss_err = {k: abs(first[k] - v) / abs(v) for k, v in unfused_first.items()}
    launches_ok = all(s == expected for s in per_step)
    log(f"train steps (fused): ms/step {[round(1e3 * t, 1) for t in times]} "
        f"(steady {steady_ms:.1f}; unfused steady {unfused_ms:.1f}); loss "
        f"{[round(x, 4) for x in losses]}; launches per step {per_step[-1]} "
        f"(as counted from the code {expected}: {launches_ok}); first-step "
        f"losses fused/unfused " + " ".join(
            f"{k} {first[k]:.5f}/{v:.5f}" for k, v in unfused_first.items())
        + f"; largest rel diff {max(loss_err.values()):.3e} (<= 2e-2)")
    if not launches_ok:
        raise AssertionError(f"fused launches per step {per_step} differ "
                             f"from the count from the code {expected}")
    if max(loss_err.values()) > 2e-2 or not losses[-1] < losses[0]:
        raise AssertionError("the fused train steps fail their checks")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, draws, batch, 0, 4, tcfg.soft_temp_start)
        torch.cuda.synchronize()
    device_profile(prof, time.perf_counter() - t0,
                   f"fused stage-2 step (unprofiled steady {steady_ms:.1f} "
                   f"ms)",
                   {"flash forward": FLASH_FWD_SYMBOLS,
                    **FLASH_BWD_SYMBOLS,
                    "gn_silu #7 (statistics + apply)": GN_SILU_SYMBOLS})
    del state, bundle, step
    torch.cuda.empty_cache()
    return {k: dict(v) for k, v in by_shape.items()}


class Recorder:
    """MetricLogger's interface (log_metrics, log_images), recording."""

    def __init__(self):
        self.rows, self.images = [], []

    def log_metrics(self, metrics, step=None):
        self.rows.append(dict(metrics))

    def log_images(self, images, step=None):
        self.images.append(images)


@contextlib.contextmanager
def ckpt_tmpdir(what: str):
    """A checkpoint directory in the checkout (git-ignored `_ckpt_*`),
    removed afterwards; logs the disk's free bytes first."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="_ckpt_", dir=REPO)
    log(f"checkpoints ({what}) under {Path(d).name}: "
        f"{shutil.disk_usage(d).free} bytes free on its disk")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def log_saves(what: str):
    """Each tag's last save since the previous call: bytes, and seconds of
    the device-to-host copy and of the write (torch.save, fsync, rename)."""
    from neurons_tpu_torch.utils import checkpoint as ckpt
    for tag, st in ckpt.LAST_SAVE_STATS.items():
        log(f"  save {what}: {tag} {st['bytes']} bytes, copy "
            f"{st['copy_s']:.2f} s, write {st['write_s']:.2f} s "
            f"({st['bytes'] / max(st['write_s'], 1e-9) / 1e9:.2f} GB/s)")
    ckpt.LAST_SAVE_STATS.clear()


def check_panels(images, n_epochs, rows):
    """The seg panels of a stage-2 run: one pair an epoch, `rows` masks
    each, predicted in (0, 1) and finite, the ground truth binary."""
    import numpy as np
    ok = len(images) == n_epochs and all(
        im["seg_pred"].shape == im["seg_gt"].shape
        and im["seg_pred"].shape[0] == rows
        and np.isfinite(im["seg_pred"]).all()
        and ((im["seg_pred"] >= 0) & (im["seg_pred"] <= 1)).all()
        and set(np.unique(im["seg_gt"])) <= {0.0, 1.0} for im in images)
    log(f"  seg panels: {len(images)} logged, "
        f"{[tuple(im['seg_pred'].shape) for im in images]}: {ok}")
    if not ok:
        raise AssertionError("the seg panels fail their checks")


def stage1_batch(bcfg, b, gen):
    """Random stage-1 inputs at the real tables' shapes, on the card:
    voxels [B, 1, V], CLIP image targets [B, 256, 1664], caption
    embeddings [B, 1280]."""
    import torch
    return (torch.randn((b, 1, bcfg.voxel_counts[0]), generator=gen,
                        device="cuda"),
            torch.randn((b, bcfg.clip_seq_dim, bcfg.clip_emb_dim),
                        generator=gen, device="cuda"),
            torch.randn((b, bcfg.clip_txt_emb_dim), generator=gen,
                        device="cuda"))


def stage1_phase():
    """Stage 1 at full width (`PipelineConfig().brain`, `TrainConfig()`:
    batch 10, bf16 autocast, the cycle schedule), seeded random weights and
    random inputs at the real tables' shapes: 1 warm-up and 3 timed steps
    of `make_stage1_train_step` on one fixed batch and draws (ms/step, peak
    memory, the loss falling, clipproj bitwise unchanged, every other
    tensor with a nonzero gradient moved), one step under torch.profiler,
    the eval step over 100 test rows, and the background writer's device
    snapshot of the full state (its time and device memory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch import config
    from neurons_tpu_torch.training import train_brain as tb
    from neurons_tpu_torch.utils import checkpoint as ckpt

    pcfg = config.PipelineConfig()
    bcfg, tcfg = pcfg.brain, pcfg.train
    spe = tcfg.num_train_samples // tcfg.batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, schedule = tb.init_stage1(bcfg, tcfg, spe, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_train = sum(p.numel() for n, p in state.params.items()
                  if not tb.FROZEN(n))
    n_frozen = sum(p.numel() for n, p in state.params.items()
                   if tb.FROZEN(n))
    voxel, target, text = stage1_batch(bcfg, tcfg.batch_size,
                                       torch.Generator("cuda").manual_seed(SEED))
    draws = tb.draw_stage1(bcfg, voxel, torch.Generator().manual_seed(SEED))
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in state.params.items()}
    step = tb.make_stage1_train_step(model, schedule, tcfg)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(FIXED_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, draws, voxel, target, text)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    steady_ms = 1e3 * sum(times[1:]) / (FIXED_STEPS - 1)
    frozen_same = all(torch.equal(p.detach().cpu(), before[n])
                      for n, p in state.params.items() if tb.FROZEN(n))
    unmoved = {n for n, p in state.params.items() if not tb.FROZEN(n)
               and torch.equal(p.detach().cpu(), before[n])}
    # with seq_len 1 each block's mix2 LayerNorm normalises one element (its
    # output is its bias): its scale, and the mix1 path feeding it, get
    # gradients that vanish in exact arithmetic
    no_grad = {n for n, p in state.params.items() if not tb.FROZEN(n)
               and not bool(p.grad.any())}
    del before
    log(f"stage1 steps: {n_train / 1e9:.3f} B trainable f32 parameters, "
        f"{n_frozen / 1e6:.2f} M frozen (clipproj); init {init_s:.1f} s; "
        f"ms/step {[round(1e3 * t, 1) for t in times]} (steady "
        f"{steady_ms:.1f}); state (parameters and moments) "
        f"{state_bytes / 2**30:.2f} GiB, max_memory_allocated over the steps "
        f"{peak / 2**30:.2f} GiB; loss {[round(x, 4) for x in losses]}; "
        f"clipproj bitwise unchanged {frozen_same}; "
        f"{len(state.params) - len(unmoved) - 1} of "
        f"{len(state.params) - 1} trainable tensors moved; did not move "
        f"{sorted(unmoved)}, of which with a zero gradient {sorted(no_grad)}")
    if not (losses[-1] < losses[0] and frozen_same and unmoved <= no_grad):
        raise AssertionError("the full-width stage-1 steps fail their checks")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, draws, voxel, target, text)
        torch.cuda.synchronize()
    device_profile(prof, time.perf_counter() - t0,
                   f"stage-1 step (unprofiled steady {steady_ms:.1f} ms)",
                   STAGE1_PROFILE)
    # the epoch eval's step over 100 test rows (a retrieval batch)
    ev_in = stage1_batch(bcfg, 100, torch.Generator("cuda").manual_seed(1))
    eval_fn = tb.make_stage1_eval_step(model)
    eval_fn(state.params, *ev_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = eval_fn(state.params, *ev_in)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    ev = {k: float(v) for k, v in ev.items()}
    ok = all(0 <= v <= 5 and v == v for v in ev.values())
    log(f"stage1 eval step over 100 rows: {eval_ms:.1f} ms; {ev}: {ok}")
    if not ok:
        raise AssertionError("the stage-1 eval step fails its checks")
    del eval_fn, voxel, target, text, ev_in
    torch.cuda.empty_cache()
    # the background writer's device snapshot of the full state (a second
    # copy of the payload beside it; `AsyncCkptWriter.submit` takes it, then
    # writes): its time and memory; the checkpoint phase writes a
    # `brain_model` through the writer
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    snap = ckpt.AsyncCkptWriter._snapshot(
        {"params": state.params, "opt_state": state.optimizer.state_dict()})
    torch.cuda.synchronize()
    snap_s = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - base
    log(f"stage1 background-writer snapshot of brain_model_last's payload: "
        f"{snap_s:.3f} s, {extra / 2**30:.2f} GiB on the card above the "
        f"state ({base / 2**30:.2f} GiB)")
    del snap, state, model, step
    torch.cuda.empty_cache()


# {label: kernel symbols} of the stage-1 step's profile: torch's AdamW
# (foreach) runs in multi_tensor_apply kernels; cuBLAS's GEMMs (nvjet_*,
# cutlass_*)
STAGE1_PROFILE = {"AdamW (multi_tensor_apply)": ("multi_tensor_apply",),
                  "GEMM": ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass")}


def stage1_tables(bcfg, n, seed):
    """A split of `n` random clips and its CLIP table [n, 6, seq, emb]
    (numpy, from `seed`), at the config's widths."""
    import numpy as np
    from neurons_tpu_torch.data import cc2017
    split = cc2017.synthetic_split(n=n, n_voxels=bcfg.voxel_counts[0],
                                   n_frames=6, img=8,
                                   txt_dim=bcfg.clip_txt_emb_dim, seed=seed)
    table = np.random.default_rng(seed).standard_normal(
        (n, 6, bcfg.clip_seq_dim, bcfg.clip_emb_dim), np.float32)
    return split, table


def stage1_checkpoints():
    """`run_stage1` at full width over 2 epochs of 2 steps: preempted after
    the first (`stop_after_epochs=1`; its `brain_model` written through the
    background writer), then resumed to the end. Logs each tag's bytes and
    save seconds and the resume's peak device memory above the live state
    (at most the largest tensor). To keep the run's disk under 45 GiB (a
    replace of a 23.3 GB `brain_model_last` holds two beside `brain_model`:
    54 GB), the full-width phase writes each tag once (31.1 GB): the test
    split is one row, whose eval metric is 3.0 at every epoch, so the
    resumed run writes no second `brain_model`, and the resumed run skips
    its final `brain_model_last` (`ckpt_saving`; the reduced-width runs and
    the tiny chain write theirs). Then, at a reduced width (hidden 256, 16
    CLIP tokens; the voxel and CLIP widths kept), the same preempted run
    against an uninterrupted one over 3 epochs: the last epoch's mean loss
    and every parameter equal."""
    import gc

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.training import loop

    pcfg = config.PipelineConfig()
    bcfg = pcfg.brain
    tcfg = config.replace(pcfg.train, num_epochs=2)
    train, table = stage1_tables(bcfg, 2 * tcfg.batch_size, SEED)
    test, test_table = stage1_tables(bcfg, 1, SEED + 1)
    largest = bcfg.hidden_dim * bcfg.out_dim * 4   # backbone_linear.weight
    with ckpt_tmpdir("stage-1 tags, full width") as d:
        t0 = time.perf_counter()
        state = loop.run_stage1(bcfg, tcfg, train, test, table, test_table,
                                ckpt_dir=d, log_every=1, logger=Recorder(),
                                stop_after_epochs=1, async_saves=True)
        torch.cuda.synchronize()
        log(f"stage1 run_stage1 (preempted after epoch 0): "
            f"{time.perf_counter() - t0:.1f} s, {state.step} steps")
        log_saves("run_stage1, preempted (brain_model in the background)")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = Recorder()
        state = loop.run_stage1(
            bcfg, config.replace(tcfg, ckpt_saving=False), train, test,
            table, test_table, ckpt_dir=d, log_every=1, logger=rec,
            resume=True)
        torch.cuda.synchronize()
        rs = dict(loop.LAST_RESTORE_STATS)
        log(f"stage1 run_stage1 (resumed): {time.perf_counter() - t0:.1f} s, "
            f"{state.step} steps; restore copied {rs['copied_bytes']} bytes "
            f"in place, device peak above the live state "
            f"{rs['device_peak_extra_bytes']} bytes (largest tensor "
            f"{largest}); epoch {rec.rows[-1]}")
        from neurons_tpu_torch.utils import checkpoint as ckpt
        wrote = sorted(ckpt.LAST_SAVE_STATS)
        if not (state.step == 4 and rs["device_peak_extra_bytes"] <= largest
                and rs["peak_extra_bytes"] == 0 and not wrote):
            raise AssertionError(f"the full-width resume fails its checks: "
                                 f"{rs}, wrote {wrote}")
        del state
        gc.collect()
        torch.cuda.empty_cache()

    small = config.replace(bcfg, hidden_dim=256, clip_seq_dim=16)
    train, table = stage1_tables(small, 2 * tcfg.batch_size, SEED)
    test, test_table = stage1_tables(small, tcfg.batch_size, SEED + 1)
    tcfg = config.replace(tcfg, num_epochs=3)
    with ckpt_tmpdir("stage-1 tags, reduced width") as d:
        full, cut = Recorder(), Recorder()
        a = loop.run_stage1(small, tcfg, train, test, table, test_table,
                            ckpt_dir=d + "/a", logger=full)
        loop.run_stage1(small, tcfg, train, test, table, test_table,
                        ckpt_dir=d + "/b", logger=cut, stop_after_epochs=1)
        b = loop.run_stage1(small, tcfg, train, test, table, test_table,
                            ckpt_dir=d + "/b", logger=cut, resume=True)
        same = all(torch.equal(p, b.params[n]) for n, p in a.params.items())
        la, lb = full.rows[-1]["train/mean_loss"], cut.rows[-1]["train/mean_loss"]
        log(f"stage1 resume at reduced width (hidden 256, 16 CLIP tokens, 3 "
            f"epochs of 2 steps, preempted after 1): last-epoch mean loss "
            f"{lb!r} resumed, {la!r} uninterrupted; parameters equal "
            f"bitwise {same}")
        log_saves("reduced width")
        if not (same and la == lb and a.step == b.step == 6):
            raise AssertionError("a resumed stage-1 run differs from an "
                                 "uninterrupted one")
        del a, b
        torch.cuda.empty_cache()


@contextlib.contextmanager
def weights_drawn_on_cpu():
    """The trainers' seeded random weights (`synth_params_`) drawn on the
    CPU and copied to the model's device: a generator on the card draws
    other numbers than one on the CPU, so without it the card's tiny runs
    would start from other weights than the CPU's."""
    import copy

    import torch
    from neurons_tpu_torch.training import train_brain as tb
    from neurons_tpu_torch.training import train_decoupler as td
    from neurons_tpu_torch.utils.synth_init import synth_params_

    def on_cpu(module, seed=0):
        cpu = synth_params_(copy.deepcopy(module).to("cpu"), seed)
        with torch.no_grad():
            for p, q in zip(module.parameters(), cpu.parameters()):
                p.copy_(q)
        return module

    old = tb.synth_params_, td.synth_params_
    tb.synth_params_ = td.synth_params_ = on_cpu
    try:
        yield
    finally:
        tb.synth_params_, td.synth_params_ = old


def chained_tiny_check():
    """The tiny chain on the card against the CPU, f32: `run_stage1` (2
    epochs, checkpointed) -> `load_stage1_core` -> `run_stage2(core_params=
    ...)` (2 epochs, `last_save_every=1`, the seg panels) ->
    `load_decoupler_params` onto stage 3's ensemble -> `run_stage3`. The
    same weights, batches and draws on both (the initial weights and the
    stage-2 draws made on the CPU here); the overlaid ensemble equals each
    run's trained state
    bitwise. Card against CPU: training's epoch means within 1e-2 relative
    (Adam's first steps can turn an element whose gradient is rounding
    noise either way), stage 3's keyframes within 5e-2 of max |CPU| and its
    prior tokens within 1e-2 (the small check's 2e-2 and 1e-3 for equal
    weights, widened for the trained weights' differences)."""
    import copy

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.data import cc2017
    from neurons_tpu_torch.diffusion.prior import PriorDiffusion, PriorNoise
    from neurons_tpu_torch.models.decoder_video import DecoderDropout
    from neurons_tpu_torch.diffusion.prior import PriorDraws
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.pipelines import e2e
    from neurons_tpu_torch.pipelines import keyframe as kf
    from neurons_tpu_torch.training import loop
    from neurons_tpu_torch.training import train_decoupler as td
    from neurons_tpu_torch.utils import checkpoint as ckpt
    from neurons_tpu_torch.utils.prng import epoch_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    pcfg = config.tiny_pipeline_config()
    pcfg = config.replace(pcfg, unet2d=config.replace(pcfg.unet2d,
                                                      adm_in_channels=1024))
    gcfg = tiny_gpt2_config()
    c, dcfg = pcfg.brain, pcfg.decoupler
    tcfg = config.replace(pcfg.train, num_epochs=2, bf16_autocast=False)
    kw = dict(seq=c.clip_seq_dim, emb=c.clip_emb_dim,
              txt_dim=c.clip_txt_emb_dim, n_frames=dcfg.n_frames,
              n_classes=dcfg.num_classes)
    train, table, aux = cc2017.structured_synthetic_split(
        16, c.voxel_counts[0], **kw)
    test, test_table, _ = cc2017.structured_synthetic_split(
        8, c.voxel_counts[0], seed=1, train=False, **kw)
    diffusion = PriorDiffusion.create(pcfg.prior.timesteps,
                                      pcfg.prior.cond_drop_prob, device="cpu")
    lat, b = 32, 2
    g = torch.Generator().manual_seed(SEED)
    tok = (b, c.clip_seq_dim, c.clip_emb_dim)
    noise = kf.KeyframeNoise(
        PriorNoise(torch.randn(tok, generator=g),
                   [torch.randn(tok, generator=g)
                    for _ in range(pcfg.sampler.prior_steps)]),
        kf.UnclipNoise(torch.randn((b, 4, lat, lat), generator=g),
                       torch.randn((b, 4, lat, lat), generator=g),
                       torch.randn((b,), generator=g),
                       torch.randn(tok, generator=g)))
    voxel = torch.randn((b, 1, c.voxel_counts[0]), generator=g)
    classes = torch.randn((dcfg.num_classes, dcfg.clip_txt_emb_dim),
                          generator=g)
    cpu_models = build_models((pcfg, gcfg), "cpu", torch.float32, 7)
    outs = {}
    for dev in ("cpu", "cuda"):
        def draws(epoch, it, batch):
            shape = {"clip_vision_target": batch["clip_vision_target"].cpu()}
            d = td.draw_stage2(diffusion, shape, dcfg,
                               epoch_generator(tcfg.seed, epoch, it))
            return td.Stage2Draws(
                PriorDraws(*(x.to(dev) for x in d.prior)),
                DecoderDropout(*(x.to(dev) for x in d.dropout)))

        with ckpt_tmpdir(f"tiny chain, {dev}") as d, weights_drawn_on_cpu():
            r1, r2 = Recorder(), Recorder()
            loop.run_stage1(c, tcfg, train, test, table, test_table,
                            ckpt_dir=d, logger=r1, device=dev)
            s2 = loop.run_stage2(
                c, pcfg.prior, dcfg, tcfg, gcfg, train,
                loop.structured_stage2_batch_builder(table, aux, train, dcfg,
                                                     gcfg.vocab_size),
                core_params=ckpt.load_stage1_core(d), ckpt_dir=d, logger=r2,
                last_save_every=1, draws=draws, device=dev)
            models = [copy.deepcopy(m).to(dev) for m in cpu_models]
            ckpt.load_decoupler_params(d, models[0])
            same = all(torch.equal(p, s2.params[n])
                       for n, p in models[0].named_parameters())
            check_panels(r2.images, 2, 4 * dcfg.n_frames)
            art = e2e.run_stage3(*models, voxel, classes,
                                 sampler_cfg=pcfg.sampler, latent_hw=lat,
                                 artifact_hw=64, caption_len=8, noise=noise,
                                 device=dev)
            ckpt.LAST_SAVE_STATS.clear()
        if not same:
            raise AssertionError(f"the tiny chain's tags ({dev}) do not give "
                                 f"back the trained state")
        outs[dev] = ([r["train/mean_loss"] for r in r1.rows + r2.rows],
                     art.outputs.keyframes.cpu(),
                     art.outputs.prior_tokens.cpu(), art.keyframe.cpu())
    (l_cpu, k_cpu, p_cpu, a_cpu), (l_gpu, k_gpu, p_gpu, a_gpu) = (
        outs["cpu"], outs["cuda"])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    kf_err = ((k_gpu - k_cpu).abs().max() / k_cpu.abs().max()).item()
    prior_err = ((p_gpu - p_cpu).abs().max() / p_cpu.abs().max()).item()
    ok = (loss_err <= 1e-2 and kf_err <= 5e-2 and prior_err <= 1e-2
          and bool(torch.isfinite(a_gpu).all()) and a_gpu.shape == a_cpu.shape)
    log(f"tiny chain card vs CPU: stage 1 and 2 epoch means "
        f"{[round(x, 5) for x in l_gpu]} vs {[round(x, 5) for x in l_cpu]} "
        f"(largest rel diff {loss_err:.3e} <= 1e-2), tags overlaid bitwise on "
        f"both, stage-3 keyframes rel err {kf_err:.3e} (<= 5e-2), prior "
        f"tokens {prior_err:.3e} (<= 1e-2), artifact {tuple(a_gpu.shape)}: "
        f"{ok}")
    if not ok:
        raise AssertionError("the tiny chain on the card disagrees with the "
                             "CPU")


# f32 operations an element of GroupNorm+SiLU takes on the CUDA cores:
# statistics 5 (sum, centred sum and square), the affine 3, SiLU 4
GN_OPS_PER_ELEMENT = 12


def gn_kernel_phase(shapes7, shapes8):
    """Kernels #7 (GroupNorm+SiLU) and #8 (GroupNorm+SiLU+3x3 conv) at every
    (shape, dtype) key the fused clip and the fused step launched, against
    float64 on the same inputs: each error within 1.5x the plain version's
    at that dtype. Times: kernel, plain version, the library composite
    (`F.silu(F.group_norm(...))`, and `F.conv2d` after it for #8: a
    yardstick of several calls the port never makes) and the bound, each
    input read once and each output written once: #7 max(12 f32 ops an
    element / 67 TFLOP/s, x + y + GroupNorm parameters / 3.35 TB/s); #8
    max(2 * M * Cout * 9 * Cin / 989 TFLOP/s, x + W + y + parameters /
    3.35 TB/s). Returns ({key: record} of #7, of #8)."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import fused_conv as fc
    from neurons_tpu_torch.ops import fused_norm as fn

    def inputs(gen, xshape, dt):
        c = xshape[1]
        x = torch.randn(xshape, generator=gen, device="cuda").to(dt)
        gw = (1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
              ).to(dt)
        gb = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
        return x, gw, gb

    def record(name, key, got, want, plain, ms, dev_ms, plain_ms,
               library_ms, bound):
        err = (got.double() - want).abs().max().item()
        plain_err = (plain.double() - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= 1.5 * plain_err
        log(f"{name} {key}  max_abs_err {err:.3e} (plain {plain_err:.3e})"
            f"  kernel_ms {ms:.4f} (device {dev_ms:.4f}) plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
            f"{bound[0]:.4f} ({bound[1]})  {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees at {key}: {err:.3e} > "
                                 f"1.5 x {plain_err:.3e}")
        return dict(max_abs_err=err, plain_err=plain_err, ms=ms,
                    device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound[0],
                    bound_by=bound[1])

    records7, records8 = {}, {}
    for key in sorted(shapes7):
        *xshape, groups, tname = key
        gen = torch.Generator("cuda").manual_seed(SEED)
        x, gw, gb = inputs(gen, xshape, getattr(torch, tname))
        want = fn.group_norm_silu_reference(x.double(), gw.double(),
                                            gb.double(), groups, 1e-5)
        got = fn.gn_silu_fwd(x, gw, gb, groups, 1e-5)
        torch.cuda.synchronize()
        plain = fn.group_norm_silu_reference(x, gw, gb, groups, 1e-5)
        reps = 5 if x.numel() > 5e7 else 20
        kernel = lambda: fn.gn_silu_fwd(x, gw, gb, groups, 1e-5)  # noqa: E731
        times = [cuda_ms(kernel, reps), device_ms(kernel, reps)] + [
            cuda_ms(f, reps) for f in (
                lambda: fn.group_norm_silu_reference(x, gw, gb, groups,
                                                     1e-5),
                lambda: F.silu(F.group_norm(x, groups, gw, gb, 1e-5)))]
        bound = _bound(GN_OPS_PER_ELEMENT * x.numel(),
                       x.element_size() * (x.numel() + got.numel()
                                           + gw.numel() + gb.numel()),
                       PEAK_F32_FLOPS)
        hw = x[0, 0].numel()
        plan = fn.gn_silu_plan(xshape[0], xshape[1], hw, groups, x.dtype,
                               int(hw % (16 // x.element_size()) == 0),
                               x.device)
        log(f"gn_silu {key} plan {plan}")
        records7[key] = record("gn_silu", key, got, want, plain, *times,
                               bound)
        records7[key]["plan"] = plan._asdict()
        del x, want, got, plain
        torch.cuda.empty_cache()
    for key in sorted(shapes8):
        n, cin, h, w, cout, groups, tname = key
        dt = getattr(torch, tname)
        gen = torch.Generator("cuda").manual_seed(SEED)
        x, gw, gb = inputs(gen, (n, cin, h, w), dt)
        cw = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              / (9 * cin) ** 0.5).to(dt)
        cb = (0.1 * torch.randn((cout,), generator=gen, device="cuda")
              ).to(dt)
        args = (x, gw, gb, cw, cb, groups, 1e-5)
        want = fc.gn_silu_conv_reference(
            *(a.double() for a in args[:5]), groups, 1e-5)
        got = fc.gn_silu_conv_fwd(*args)
        torch.cuda.synchronize()
        plain = fc.gn_silu_conv_reference(*args)
        kernel = lambda: fc.gn_silu_conv_fwd(*args)  # noqa: E731
        times = [cuda_ms(kernel, 10), device_ms(kernel, 10)] + [
            cuda_ms(f, 10) for f in (
                lambda: fc.gn_silu_conv_reference(*args),
                lambda: F.conv2d(F.silu(F.group_norm(x, groups, gw, gb,
                                                     1e-5)),
                                 cw, cb, padding=1))]
        esize = x.element_size()
        bound = _bound(2.0 * n * h * w * cout * 9 * cin,
                       esize * sum(a.numel() for a in (x, gw, gb, cw, cb,
                                                       got)),
                       PEAK_BF16_FLOPS if dt == torch.bfloat16
                       else PEAK_TF32_FLOPS)
        if dt == torch.bfloat16:
            log(f"gn_silu_conv {key} plan {fc.conv_plan(n, cin, h, w, cout)}")
        records8[key] = record("gn_silu_conv", key, got, want, plain, *times,
                               bound)
        del x, cw, want, got, plain, args
        torch.cuda.empty_cache()
    return records7, records8


# --- stages 4 and 6 -----------------------------------------------------------

CAPTION_KEYFRAMES = 16   # stage-3 keyframes captioned: 2 batches of 8
SCORED_CLIPS = 4         # stage-5 GIFs scored by stage 6


def reduced_blip2_config():
    """BLIP-2 at its real vision token count and head dim (224 / 14 -> 257
    tokens, heads of 88: 2 heads, width 176, 2 layers), so the flash
    forward runs, with a 2-layer Q-Former and a 2-layer narrow OPT."""
    from neurons_tpu_torch.models import blip2
    return blip2.Blip2Config(
        vision=blip2.Blip2VisionConfig(hidden_size=176, layers=2, heads=2,
                                       intermediate_size=352),
        qformer=blip2.Blip2QFormerConfig(hidden_size=64, layers=2, heads=4,
                                         intermediate_size=128,
                                         num_query_tokens=8),
        opt=blip2.OPTConfig(hidden_size=64, layers=2, heads=4, ffn_dim=128,
                            vocab_size=1000, max_position_embeddings=64,
                            eos_token_id=999))


def card_and_cpu(build, seed):
    """The same seeded weights (drawn on the CPU) in an f32 module on the
    CPU and a copy on the card."""
    import copy

    from neurons_tpu_torch.utils.synth_init import synth_params_
    cpu = synth_params_(build("cpu"), seed).eval()
    return cpu, copy.deepcopy(cpu).to("cuda")


def small_caption_check():
    """The reduced BLIP-2 (`reduced_blip2_config`) on the card against the
    CPU, f32: the cached greedy decode equal to `generate_nocache` on
    each, the tokens equal across the two, and the teacher-forced logits
    over the prefix and those tokens within 2e-2 * max |CPU| (the vision
    tower's attention multiplies in TF32 on the card)."""
    import torch
    from neurons_tpu_torch.models.blip2 import Blip2Captioner
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_blip2_config()
    cpu, gpu = card_and_cpu(lambda dev: Blip2Captioner(cfg, device=dev), 21)
    x = torch.randn((2, 3, 224, 224), generator=torch.Generator()
                    .manual_seed(SEED))
    toks, logits = {}, {}
    before = FLASH_FWD_LAUNCHES.total
    with torch.inference_mode():
        for dev, m in (("cpu", cpu), ("cuda", gpu)):
            xd = x.to(dev)
            toks[dev] = (m.generate(xd, max_len=12).cpu(),
                         m.generate_nocache(xd, max_len=12).cpu())
            logits[dev] = m(xd, toks["cpu"][0].to(dev)).float().cpu()
    launched = FLASH_FWD_LAUNCHES.total - before
    same = [torch.equal(toks["cpu"][0], t) for t in
            (toks["cpu"][1], toks["cuda"][0], toks["cuda"][1])]
    ref = logits["cpu"]
    err = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
    # the card's 3 prefixes (2 generate paths, 1 forward) x 2 vision layers
    want = 3 * cfg.vision.layers
    log(f"small caption check: flash launches {launched} (expected {want}), "
        f"tokens {toks['cpu'][0].tolist()}, nocache/card/card-nocache "
        f"equal {same}, logits rel err {err:.3e} (<= 2e-2)")
    if not (launched == want and all(same) and err <= 2e-2):
        raise AssertionError("the reduced BLIP-2 on the card disagrees with "
                             "the CPU")


def small_classifier_check():
    """The three metric towers at their real token counts and reduced
    width (2 layers, 2 heads of 64), f32, card against CPU: ViT-B's 197
    tokens, VideoMAE's 588 over 6 frames, CLIP ViT-L/14's 257 for 6
    frames; logits and embeddings within 2e-2 * max |CPU|."""
    import torch
    from neurons_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
    from neurons_tpu_torch.models.vit import ViTClassifier, ViTConfig
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    narrow = dict(width=128, layers=2, heads=2)
    towers = [
        ("vit-b", lambda d: ViTClassifier(
            ViTConfig.vit_base_224()._replace(**narrow), device=d),
         (1, 3, 224, 224), 197),
        ("videomae", lambda d: ViTClassifier(
            ViTConfig.videomae_kinetics(6)._replace(**narrow), device=d),
         (1, 6, 3, 224, 224), 588),
        ("clip vit-l", lambda d: CLIPVisionTower(
            CLIPVisionConfig.vit_l14()._replace(output_dim=64, **narrow),
            device=d), (6, 3, 224, 224), 257)]
    g = torch.Generator().manual_seed(SEED)
    for i, (name, build, shape, tokens) in enumerate(towers):
        cpu, gpu = card_and_cpu(build, 30 + i)
        x = torch.randn(shape, generator=g)
        before = dict(FLASH_FWD_LAUNCHES.by_shape)
        with torch.inference_mode():
            ref = cpu(x)
            got = gpu(x.to("cuda"))
        ref, got = (r if torch.is_tensor(r) else r[0] for r in (ref, got))
        err = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        launched = {k: n - before.get(k, 0) for k, n in
                    FLASH_FWD_LAUNCHES.by_shape.items()
                    if n != before.get(k, 0)}
        log(f"small classifier check {name}: out {tuple(ref.shape)}, "
            f"flash launches {launched}, rel err {err:.3e} (<= 2e-2)")
        if not (list(launched) and all(k[2] == tokens for k in launched)
                and sum(launched.values()) == 2 and err <= 2e-2):
            raise AssertionError(f"the reduced {name} on the card disagrees "
                                 f"with the CPU")


def hf_vit_state_dict(m, prefix="vit"):
    """A ViTClassifier's weights under HF ViTForImageClassification's (or,
    with prefix "videomae", VideoMAEForVideoClassification's) names."""
    sd = {}
    c = m.cfg
    if prefix == "vit":
        sd["vit.embeddings.patch_embeddings.projection.weight"] = \
            m.patch_embed.weight
        sd["vit.embeddings.cls_token"] = m.cls_token
        sd["vit.embeddings.position_embeddings"] = m.pos_embed[None]
        sd["vit.layernorm.weight"] = m.ln_post.weight
        sd["vit.layernorm.bias"] = m.ln_post.bias
    else:  # the tubelet Dense [d, (ts ph pw ch)] back to the Conv3d
        p, ts = c.patch_size, c.tubelet_size
        sd["videomae.embeddings.patch_embeddings.projection.weight"] = \
            m.patch_embed.weight.reshape(c.width, ts, p, p, 3).permute(
                0, 4, 1, 2, 3)
        sd["fc_norm.weight"] = m.ln_post.weight
        sd["fc_norm.bias"] = m.ln_post.bias
    sd[f"{prefix}.embeddings.patch_embeddings.projection.bias"] = \
        m.patch_embed.bias
    sd["classifier.weight"] = m.head.weight
    sd["classifier.bias"] = m.head.bias
    for i in range(c.layers):
        blk, q = getattr(m, f"block_{i}"), f"{prefix}.encoder.layer.{i}"
        for ours, theirs in (("ln_1", "layernorm_before"),
                             ("ln_2", "layernorm_after"),
                             ("attn_out", "attention.output.dense"),
                             ("mlp_fc", "intermediate.dense"),
                             ("mlp_proj", "output.dense")):
            sd[f"{q}.{theirs}.weight"] = getattr(blk, ours).weight
            sd[f"{q}.{theirs}.bias"] = getattr(blk, ours).bias
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
            sd[f"{q}.attention.attention.{theirs}.weight"] = \
                getattr(blk, ours).weight
            if prefix == "vit":
                sd[f"{q}.attention.attention.{theirs}.bias"] = \
                    getattr(blk, ours).bias
        if prefix == "videomae":  # biasless q/k/v, a q and a v bias
            sd[f"{q}.attention.attention.q_bias"] = blk.q.bias
            sd[f"{q}.attention.attention.v_bias"] = blk.v.bias
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def hf_clip_state_dict(m):
    """A CLIPVisionTower's weights under HF CLIPVisionModelWithProjection's
    names."""
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight": m.patch_embed.weight,
          f"{v}.embeddings.class_embedding": m.class_embedding,
          f"{v}.embeddings.position_embedding.weight":
              m.positional_embedding,
          f"{v}.pre_layrnorm.weight": m.ln_pre.weight,
          f"{v}.pre_layrnorm.bias": m.ln_pre.bias,
          f"{v}.post_layernorm.weight": m.ln_post.weight,
          f"{v}.post_layernorm.bias": m.ln_post.bias,
          "visual_projection.weight": m.proj.T}
    for i in range(m.cfg.layers):
        blk, q = getattr(m, f"resblock_{i}"), f"{v}.encoder.layers.{i}"
        for name, w, b in zip(("q_proj", "k_proj", "v_proj"),
                              blk.in_proj.weight.chunk(3),
                              blk.in_proj.bias.chunk(3)):
            sd[f"{q}.self_attn.{name}.weight"] = w
            sd[f"{q}.self_attn.{name}.bias"] = b
        for ours, theirs in (("out_proj", "self_attn.out_proj"),
                             ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                             ("mlp_fc", "mlp.fc1"), ("mlp_proj", "mlp.fc2")):
            sd[f"{q}.{theirs}.weight"] = getattr(blk, ours).weight
            sd[f"{q}.{theirs}.bias"] = getattr(blk, ours).bias
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def write_metric_weights(weights_dir: Path, num_frames: int,
                         device="cuda"):
    """The three metric classifiers at full width (ViT-B/16, VideoMAE-B
    over `num_frames` frames, CLIP ViT-L/14) with `synth_params_` weights
    drawn on `device`, written as HF state dicts under the file names
    `build_metric_classifiers` reads. Returns their parameter count."""
    import torch
    from neurons_tpu_torch.evaluation.runner import WEIGHT_FILES
    from neurons_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
    from neurons_tpu_torch.models.vit import ViTClassifier, ViTConfig
    from neurons_tpu_torch.utils.synth_init import synth_params_

    files = dict(WEIGHT_FILES)
    weights_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for i, (name, build, export) in enumerate((
            ("vit", lambda: ViTClassifier(ViTConfig.vit_base_224(),
                                          device=device),
             hf_vit_state_dict),
            ("videomae", lambda: ViTClassifier(
                ViTConfig.videomae_kinetics(num_frames), device=device),
             lambda m: hf_vit_state_dict(m, "videomae")),
            ("clip", lambda: CLIPVisionTower(CLIPVisionConfig.vit_l14(),
                                             device=device),
             hf_clip_state_dict))):
        m = synth_params_(build(), SEED + 40 + i)
        n += sum(p.numel() for p in m.parameters())
        torch.save(export(m), weights_dir / files[name])
        del m
    return n


def scored_clip_launches(num_frames: int) -> dict:
    """Flash launches a scored clip, counted from `run_metrics`: the frame
    metrics run the ViT-B on every frame for both n-way settings, once on
    the prediction (probabilities) and once on the ground truth (logits);
    the video metrics run VideoMAE the same way on the whole clip; CLIP-pcc
    runs the CLIP tower once on the prediction's frames. One launch a
    layer."""
    from neurons_tpu_torch.models.clip import CLIPVisionConfig
    from neurons_tpu_torch.models.vit import ViTConfig
    n_way_settings, sides = 2, 2
    vit = ViTConfig.vit_base_224()
    mae = ViTConfig.videomae_kinetics(num_frames)
    clip = CLIPVisionConfig.vit_l14()
    return {
        (1, vit.heads, 197, 197, 64, "float32", ""):
            num_frames * n_way_settings * sides * vit.layers,
        (1, mae.heads, 588, 588, 64, "float32", ""):
            n_way_settings * sides * mae.layers,
        (num_frames, clip.heads, 257, 257, 64, "float32", ""): clip.layers}


def profile_stage46(vdir: str, weights: Path, num_frames: int):
    """One caption batch (`Blip2Config()` built as the CLI builds it, bf16,
    8 images, 30 tokens, after one warm-up batch) and one `run_metrics` of
    the scored clips (the three classifiers as `build_metric_classifiers`
    imports them) under torch.profiler, device activity only: wall time
    and device busy time from the same run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.evaluation.runner import (build_metric_classifiers,
                                                     run_metrics)
    from neurons_tpu_torch.models.blip2 import Blip2Captioner, Blip2Config
    from neurons_tpu_torch.utils.synth_init import synth_params_

    model = Blip2Captioner(Blip2Config(), device="meta",
                           dtype=torch.bfloat16).to_empty(device="cuda")
    synth_params_(model, SEED).eval()
    x = torch.randn((8, 3, 224, 224), device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        model.generate(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.generate(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device_profile(prof, wall, "caption batch (8 images, 30 tokens)",
                   {"flash": FLASH_FWD_SYMBOLS})
    del model
    torch.cuda.empty_cache()
    classifiers = build_metric_classifiers(str(weights), num_frames)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_metrics(vdir, classifiers, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_profile(prof, wall, f"stage 6 over {SCORED_CLIPS} scored clips",
                   {"flash": FLASH_FWD_SYMBOLS})


def stage46_phase(sample):
    """Stage 4 then stage 6 at full width through the port's CLI.

    Stage 4: `save_stage3_artifacts` for 16 keyframes at 256 px (the clip
    phase's keyframe and 15 synthetic ones), then `cli.main(["caption",
    "--synthetic", ...])`: `Blip2Config()` in bf16 with `synth_params_`
    weights drawn on the card, batch 8, 30 tokens; s a batch in the steady
    state (the CLI's stage line), peak memory, flash launches held to 39
    (the vision tower's layers) a batch, the caption artifact checked.
    Stage 6: 4 GIFs written by `save_video_grid`, each the clip phase's
    video (frames 4:, every other one: 6 frames) beside a synthetic ground
    truth, then `cli.main(["eval", ...])` twice: pixel metrics only (no
    weights), then with the three full-width classifiers written as HF
    state dicts (`write_metric_weights`), so that `build_metric_classifiers`
    imports and runs them on the card; s a scored clip, peak memory, flash
    launches held to `scored_clip_launches`. Then a caption batch and the
    scored clips once more under the profiler (`profile_stage46`). Returns
    {path: launches by shape} and the runs each path spans."""
    import os

    import numpy as np
    import torch
    from neurons_tpu_torch import cli, native_io
    from neurons_tpu_torch.models.blip2 import Blip2Config
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.pipelines import io

    keyframe, video = sample
    native_dir = REPO / "native"
    native_before = sorted(os.listdir(native_dir))
    rng = np.random.default_rng(SEED)
    by_path = {}
    with ckpt_tmpdir("stages 4 and 6: artifacts, GIFs, weights") as d:
        root = Path(d)
        exp = ["--exp_dir", str(root), "--exp", "smoke", "--subj", "1",
               "--seed", str(SEED)]
        st3 = io.stage3_dir(str(root), "smoke", 1, False)
        n = CAPTION_KEYFRAMES
        recons = np.concatenate([keyframe.numpy(), rng.uniform(
            size=(n - 1, 3, 256, 256)).astype(np.float32)])
        io.save_stage3_artifacts(
            st3, 1, all_recons=recons,
            all_gts=rng.uniform(size=(n, 3, 224, 224)).astype(np.float32),
            captions=[f"keyframe {i}" for i in range(n)],
            blurry_videos=rng.uniform(size=(n, 6, 3, 224, 224)).astype(
                np.float32))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        FLASH_FWD_LAUNCHES.reset()
        t0 = time.perf_counter()
        cli.main(["caption", "--synthetic", *exp])
        wall = time.perf_counter() - t0
        batches = -(-n // 8)
        layers = Blip2Config().vision.layers
        peak = torch.cuda.max_memory_allocated()
        stats = cli._STAGE_STATS["4"]
        by_path["caption batch"] = dict(FLASH_FWD_LAUNCHES.by_shape)
        caps = io.load_captions(st3, "blip")
        ids = [[int(i) for i in c.removeprefix("ids:").split(",")]
               for c in caps]
        log(f"stage 4 (caption, Blip2Config() bf16, batch 8, 30 tokens): "
            f"{n} keyframes in {wall:.3f} s (setup {stats['setup_s']} s, "
            f"first batch {stats['first_batch_s']} s), "
            f"{8 * stats['steady_s_per_clip']:.3f} s a caption batch in the "
            f"steady state, max_memory_allocated {peak / 2**30:.2f} GiB, "
            f"flash launches {FLASH_FWD_LAUNCHES.total} (expected "
            f"{layers} a batch x {batches}), first caption {caps[0][:60]}...")
        vocab = Blip2Config().opt.vocab_size
        if not (FLASH_FWD_LAUNCHES.total == layers * batches
                and set(by_path["caption batch"]) == {
                    (8, 16, 257, 257, 88, "bfloat16", "")}
                and len(caps) == n
                and all(len(r) == 30 and r[0] == 2 and
                        all(0 <= t < vocab for t in r) for r in ids)):
            raise AssertionError("stage 4 on the card: wrong launches or "
                                 "captions")
        if not (native_io.available()
                and native_io.library_path().parent
                == REPO / "neurons_tpu_torch" / "_build"):
            raise AssertionError("the native GIF codec did not build into "
                                 "neurons_tpu_torch/_build")

        frames = video[:, 4:][:, ::2].numpy()          # [1, 6, 3, 256, 256]
        vdir = io.video_dir(str(root), "smoke", 1, "motion")
        t0 = time.perf_counter()
        for i in range(SCORED_CLIPS):
            gt = rng.uniform(size=frames.shape).astype(np.float32)
            io.save_video_grid(np.concatenate([gt, frames], -1),
                               os.path.join(vdir, io.gif_artifact_name(
                                   i, caps[i])))
        log(f"stage 5 GIFs: {SCORED_CLIPS} written by the native codec in "
            f"{time.perf_counter() - t0:.3f} s")
        out = os.path.join(io.exp_dir(str(root), "smoke", 1),
                           "metrics_motion.json")
        nf = frames.shape[1]
        reports = {}
        for what, weights in (("pixel metrics", root / "no_weights"),
                              ("three classifiers", root / "weights")):
            if what == "three classifiers":
                t0 = time.perf_counter()
                n_params = write_metric_weights(weights, nf)
                log(f"stage 6 classifiers: {n_params / 1e9:.3f} B params "
                    f"(f32) written as HF state dicts in "
                    f"{time.perf_counter() - t0:.1f} s")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            FLASH_FWD_LAUNCHES.reset()
            t0 = time.perf_counter()
            cli.main(["eval", "--weights_dir", str(weights), *exp])
            wall = time.perf_counter() - t0
            stats = cli._STAGE_STATS["6"]
            with open(out) as f:
                reports[what] = json.load(f)
            launches = dict(FLASH_FWD_LAUNCHES.by_shape)
            log(f"stage 6 (eval, {what}): {SCORED_CLIPS} clips in "
                f"{wall:.3f} s (setup {stats['setup_s']} s), "
                f"{stats['s_per_clip']:.3f} s a scored clip, "
                f"max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
                f"launches {launches}, report {reports[what]}")
            if what == "pixel metrics":
                if launches:
                    raise AssertionError("pixel metrics launched the flash "
                                         "kernel")
                continue
            want = {k: v * SCORED_CLIPS
                    for k, v in scored_clip_launches(nf).items()}
            if launches != want:
                raise AssertionError(f"stage 6 launches {launches} differ "
                                     f"from the count from the code {want}")
            by_path["scored clip"] = launches
            profile_stage46(vdir, weights, nf)
        rep = reports["three classifiers"]
        keys = {"clip_pcc", "clip_pcc_std", "video_2way", "video_50way",
                "frame_2way", "frame_50way", "ssim", "psnr"}
        if not (set(rep) == keys and set(reports["pixel metrics"])
                == {"ssim", "psnr"}
                and all(np.isfinite(v) for v in rep.values())
                and all(0 <= rep[k] <= 1 for k in keys
                        if "way" in k)
                and -1 <= rep["ssim"] <= 1 and -1 <= rep["clip_pcc"] <= 1
                and rep["ssim"] == reports["pixel metrics"]["ssim"]
                and rep["psnr"] == reports["pixel metrics"]["psnr"]):
            raise AssertionError(f"stage 6 report out of range: {reports}")
    if sorted(os.listdir(native_dir)) != native_before:
        raise AssertionError("something was written into native/")
    return by_path, {"caption batch": batches, "scored clip": SCORED_CLIPS}


def kernels_record(flash_records, temporal_records, train_records, by_shape,
                   train_by_shape, gn_records, fused_by_shapes, f32_checks,
                   ptxas, runs, fast_by_shape, stage46_by_path):
    """The kernels JSON: one entry per (kernel, shape) of the main paths
    (the unfused clip's, then stage 2's, then the fast clip's, the "max"
    preset, then stage 4's caption batch and stage 6's scored clip; for #7
    and #8 the fused clip's, then the fused step's); per
    kernel and path the sums of launches x time (kernel, bound, library);
    the f32 flash checks; each kernel's registers and spills. `runs`: the
    clips or steps each path's counts span ("clip", "step", "fast clip",
    "fused clip", "fused step")."""
    fwd_records = {**flash_records, **train_records[0]}
    entries, groups = [], []
    for path, key, launches in (
            [("clip", k, n) for k, n in sorted(by_shape["flash_attn_fwd"]
                                                .items())]
            + [("step", k, n) for k, n in sorted(
                train_by_shape["flash_attn_fwd"].items())]
            + [("fast clip", k, n) for k, n in sorted(
                fast_by_shape["flash_attn_fwd"].items())]):
        b, h, tq, tk, d, dt, variant = key
        rec = fwd_records.get(key)
        # bf16 everywhere but the seg panels (f32, on the step's path)
        if rec is None or (dt != "bfloat16" and "panel" not in rec["site"]):
            raise AssertionError(f"the main path launched the flash kernel "
                                 f"at {key}, a shape the kernel phase did "
                                 f"not check")
        whole_kv = tk * 2 <= 4608  # the TPU package's whole-KV regime
        entries.append({
            "name": (f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} "
                     + ("bf16" if dt == "bfloat16" else "f32 seg panel")
                     + (f" {variant}" if variant else "")
                     + (" fast clip]" if path == "fast clip" else "]")),
            "route": "cuda",
            "source": "neurons_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": ("neurons_tpu/ops/attention.py:185"
                         if "bias" in variant else
                         "neurons_tpu/ops/attention.py:137" if whole_kv
                         else "neurons_tpu/ops/attention.py:226"),
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **({"device_ms": rec["device_ms"]} if "device_ms" in rec
               else {}),
        })
        groups.append(("flash_attn_fwd", path, runs[path]))
    for path, shapes in stage46_by_path.items():
        for key, launches in sorted(shapes.items()):
            b, h, tq, tk, d, dt, variant = key
            rec = fwd_records.get(key)
            if rec is None:
                raise AssertionError(f"the {path} launched the flash kernel "
                                     f"at {key}, a shape the kernel phase "
                                     f"did not check")
            entries.append({
                "name": (f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} "
                         + ("bf16" if dt == "bfloat16" else "f32")
                         + f" {path}]"),
                "route": "cuda",
                "source": "neurons_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": "neurons_tpu/ops/attention.py:137",  # whole KV
                "launches": launches,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "device_ms": rec["device_ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
            })
            groups.append(("flash_attn_fwd", path, runs[path]))
    for key, launches in sorted(train_by_shape["flash_attn_bwd"].items()):
        b, h, tq, tk, d, dt, variant = key
        rec = train_records[1].get(key)
        if rec is None or dt != "bfloat16":
            raise AssertionError(f"stage 2 launched the flash backward at "
                                 f"{key}, a shape the kernel phase did not "
                                 f"check")
        entries.append({
            "name": (f"flash_attn_bwd[{b}x{h}x{tq}x{tk}x{d} bf16"
                     + (f" {variant}]" if variant else "]")),
            "route": "cuda",
            "source": "neurons_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": ("neurons_tpu/ops/attention.py:458" if variant
                         else "neurons_tpu/ops/attention.py:276"),
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "library_bwd_ms": rec["library_bwd_ms"],
        })
        groups.append(("flash_attn_bwd", "step", runs["step"]))
    for path, key, launches in (
            [("clip", k, n) for k, n in sorted(
                by_shape["temporal_attn_fwd"].items())]
            + [("fast clip", k, n) for k, n in sorted(
                fast_by_shape["temporal_attn_fwd"].items())]):
        bf, d, c, f, h, dt = key
        rec = temporal_records.get(key)
        if rec is None or dt != "bfloat16":
            raise AssertionError(f"the main path launched the temporal "
                                 f"kernel at {key}, a shape the kernel "
                                 f"phase did not check")
        entries.append({
            "name": (f"temporal_attn_fwd[{bf}x{d}x{c} F{f} H{h} bf16"
                     + (" fast clip]" if path == "fast clip" else "]")),
            "route": "cuda",
            "source": "neurons_tpu_torch/csrc/temporal_attn_fwd.cu",
            "replaces": "neurons_tpu/ops/temporal_attention.py:91",
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "route": rec["route"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
        groups.append(("temporal_attn_fwd", path, runs[path]))
    sources = {"gn_silu": ("neurons_tpu_torch/csrc/gn_silu.cu",
                           "neurons_tpu/ops/fused_norm.py:102"),
               "gn_silu_conv": ("neurons_tpu_torch/csrc/gn_silu_conv.cu",
                                "neurons_tpu/ops/fused_conv.py:91")}
    for path, shapes in fused_by_shapes:
        for kernel, records in zip(("gn_silu", "gn_silu_conv"), gn_records):
            for key, launches in sorted(shapes[kernel].items()):
                rec = records.get(key)
                if rec is None or key[-1] != "bfloat16":
                    raise AssertionError(f"the fused {path} launched {kernel} "
                                         f"at {key}, a shape the kernel "
                                         f"phase did not check")
                if kernel == "gn_silu":
                    shape = "x".join(map(str, key[:-2]))
                else:
                    shape = "x".join(map(str, key[:4])) + f"->{key[4]}"
                entries.append({
                    "name": f"{kernel}[{shape} G{key[-2]} bf16 {path}]",
                    "route": "cuda",
                    "source": sources[kernel][0],
                    "replaces": sources[kernel][1],
                    "launches": launches,
                    "max_abs_err": rec["max_abs_err"],
                    "ms": rec["ms"], "device_ms": rec["device_ms"],
                    "plain_ms": rec["plain_ms"],
                    "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"],
                })
                groups.append((kernel, path, runs[f"fused {path}"]))
    return {"kernels": entries, "totals": kernel_totals(entries, groups),
            "totals_by_tpu_kernel": kernel_totals(entries, groups, True),
            "f32_checks": f32_checks, "ptxas": ptxas}


def kernel_totals(entries, groups, by_tpu_kernel=False):
    """Per kernel (or, with `by_tpu_kernel`, per Pallas kernel it replaces)
    and path, for one clip or one step: launches, and the sums of launches
    x time of the kernel (by events, and by device time where the kernel
    phase measured it), of its bound, of its plain version and of the
    library call (for the flash backward also of the
    library's backward alone), in seconds; the rule-2 order reads off
    kernel_s - bound_s.
    `groups` gives each entry's (kernel, path, runs its launches span)."""
    out = {}
    for entry, (kernel, path, runs) in zip(entries, groups):
        name = entry["replaces"] if by_tpu_kernel else kernel
        t = out.setdefault((name, path), dict(
            kernel=name, path=path, launches=0, kernel_s=0.0, bound_s=0.0,
            plain_s=0.0, library_s=0.0))
        n = entry["launches"] / runs
        t["launches"] += n
        t["kernel_s"] += n * entry["ms"] / 1e3
        t["bound_s"] += n * entry["bound_ms"] / 1e3
        t["plain_s"] += n * entry["plain_ms"] / 1e3
        if entry["library_ms"] is not None:
            t["library_s"] += n * entry["library_ms"] / 1e3
        if "device_ms" in entry:  # device time per call
            t["device_s"] = (t.get("device_s", 0.0)
                             + n * entry["device_ms"] / 1e3)
        if "library_bwd_ms" in entry:  # the backward: the library's alone
            t["library_bwd_s"] = (t.get("library_bwd_s", 0.0)
                                  + n * entry["library_bwd_ms"] / 1e3)
    return sorted(out.values(), key=lambda t: t["bound_s"] - t["kernel_s"])


def f32_check_records(flash_records):
    """The f32 (TF32) flash checks: not on a main path, recorded with their
    bound and library time."""
    return [dict(name=f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} float32]",
                 site=rec["site"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                 bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                 library_ms=rec["library_ms"], max_abs_err=rec["max_abs_err"])
            for (b, h, tq, tk, d, dt, _), rec in sorted(flash_records.items())
            if dt == "float32" and rec["site"] in F32_CHECKS]


def ptxas_summary(name):
    """Per kernel of csrc/<name>.cu, from nvcc's -Xptxas -v log: the
    registers a thread and the bytes of local-memory spill stores and
    loads."""
    import re
    from neurons_tpu_torch.ops import cuda_build
    out, fn = [], None
    for line in cuda_build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = dict(source=name, function=m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
            out.append(fn)
            fn = None
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from neurons_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    sources = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    libs = cuda_build.build(sources)
    log(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    ptxas = [f for name in sources for f in ptxas_summary(name)]
    for f in ptxas:
        log(f"  ptxas {f['source']}: {f['function']} {f['registers']} "
            f"registers, spill stores {f.get('spill_stores', 0)} B, loads "
            f"{f.get('spill_loads', 0)} B")
    del libs

    flash_records = flash_phase()
    temporal_records = temporal_phase()
    train_records = train_kernel_phase()
    for fused in (False, True):
        with configuration(fused):
            small_check(fused)
            small_video_check(fused)
            small_train_check(fused)
    with configuration(False):
        small_fast_check()
        small_caption_check()
        small_classifier_check()
    clip_by_shape, fast_by_config, sample = slice_phase()
    with configuration(False):
        stage46_by_path, stage46_runs = stage46_phase(sample)
    del sample
    with configuration(False):
        train_by_shape, fused_train_by_shape = train_phase()
        stage1_phase()
        stage1_checkpoints()
        chained_tiny_check()
    fused_by_shapes = (("clip", clip_by_shape[True]),
                       ("step", fused_train_by_shape))
    gn_records = gn_kernel_phase(
        *({k for _, shapes in fused_by_shapes for k in shapes[kernel]}
          for kernel in ("gn_silu", "gn_silu_conv")))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    # the clips and steps the counted runs span: 2 requests a
    # configuration, run_stage2's steps, the 4 fixed fused steps
    # (from the backward's launches: the seg panel adds forwards only)
    stage2_steps = (sum(train_by_shape["flash_attn_bwd"].values())
                    / sum(STEP_LAUNCHES["flash_attn_bwd"].values()))
    runs = {"clip": CLIP_REQUESTS, "step": stage2_steps,
            "fast clip": CLIP_REQUESTS, "fused clip": CLIP_REQUESTS,
            "fused step": FIXED_STEPS, **stage46_runs}
    record = kernels_record(flash_records, temporal_records, train_records,
                            clip_by_shape[False], train_by_shape, gn_records,
                            fused_by_shapes, f32_check_records(flash_records),
                            ptxas, runs, fast_by_config[FAST_PRESET],
                            stage46_by_path)
    log("kernel totals (a clip or a step; s of launches x time): " + " | ".join(
        f"{t['kernel']} {t['path']} x{t['launches']:g}: kernel "
        f"{t['kernel_s']:.4f}" + (f" (device {t['device_s']:.4f})"
                                  if "device_s" in t else "")
        + f" bound {t['bound_s']:.4f} plain {t['plain_s']:.4f} library "
        f"{t['library_s']:.4f}" + (f" (backward alone {t['library_bwd_s']:.4f})"
                                   if "library_bwd_s" in t else "")
        for t in record["totals"]))
    log("totals by the Pallas kernel replaced (a clip or a step; s): "
        + " | ".join(f"{t['kernel']} {t['path']} x{t['launches']:g}: kernel "
                     f"{t['kernel_s']:.4f}" + (
                         f" (device {t['device_s']:.4f})" if "device_s" in t
                         else "")
                     + f" bound {t['bound_s']:.4f} plain {t['plain_s']:.4f} "
                     f"library {t['library_s']:.4f}"
                     for t in record["totals_by_tpu_kernel"]))
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
