#!/usr/bin/env python3
"""Drive the PyTorch port of stages 3 and 5 (inference, exact and fast
paths, and the HTTP server over them), stages 4 and 6 (captions and the
metric suite, through the port's CLI), the CLI's `precompute` and
`validate`, the sgm engine surface and SVD image-to-video, the sgm
autoencoder trainer and T5, and stages 1 and 2 (training, checkpoints and
resume) on one CUDA card, in the default configuration and in the
fused-norm one, and hold its kernels against their plain PyTorch versions.

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
     VideoMAE's 588, CLIP ViT-L's 257 for 6 frames), each with the kernel
     it routes to (f32 up to d = 128: the TF32 register kernel, whose
     instances' registers and spills, 0 bytes required, are logged after
     the build), against an f32
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
     alone on the exact stage-3 artifacts). Then the server
     (`serve_phase`): `serving.InferenceServer` on port 0 at batch 2 over
     the same bf16 models (`serving.clip_pipeline`), four concurrent
     single-clip requests, a 2-clip one and a `?format=gif` one, /healthz,
     /stats and a request of the wrong shape (400); each served clip equal
     to the direct pipeline call on its padded batch and seed, the mean
     occupancy above 1, the GIF the native codec's, the launches equal to
     `serve_launches` at batch 2 a batch; s a batch, the clients' p50/p95,
     clips/s. Then the sgm engine (`engine_phase`): a `DiffusionEngine` over
     the clip's unCLIP UNet and VAE, `do_sample` at 768 px under each of
     the six samplers (4 steps) and one `do_img2img` at strength 0.5, every
     sample finite in [0, 1] with its 48-bit watermark read back, the
     launches held to `engine_launches`. Then one full-width UNet2D and one
     UNet3D forward,
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
  4c. the CLI (`cli_phase`): a CC2017 root of 2 test clips at full voxel
     count and the reference's weight files at full width
     (`write_cc2017_root`, `write_reference_weights`: seeded modules
     through the exporters of `interop/torch_export.py`, about 29 GB in
     a git-ignored directory, removed after), then `cli.main(["pipeline",
     "35e6", "--n_test", "2", ...])` from them (stage 3 from the unclip6
     checkpoint and the released ensemble, stage 5 from the SD-1.5 base,
     motion module, LoRA and SparseCtrl with the captions through the
     SD-1.5 text encoder, stage e, stage 6 with the classifiers): each
     bundle's load seconds, bytes and host RSS, s/clip of stages 3 and 5
     beside the library path's, peak memory by stage, every flash and
     temporal launch held to `cli_launches`; stage 6 again with
     `--platform cpu` on the same GIFs (SSIM and PSNR within 1e-5, the
     other keys' differences logged with the classifiers' argsorts); and
     `pipeline 12345e6 --tiny --synthetic` on the card against the CPU
     (keyframes and videos within 2e-2, captions and stage-e class
     predictions equal). Between the two, before the weights are removed,
     `validate` on the same files (`validate_on`): the real-weight branch
     of both stages in f32 at the proxy shapes (64^2 latents over 38 steps,
     32^2 latents of 16 frames over 25 steps), the report gated (real
     weights, scores finite, corr in [-1, 1], fast != exact) and its
     launches held to `validate_launches`; and
     `DiffusionEngine.from_checkpoint` on the unclip6 file
     (`engine_from_checkpoint`: the EMA weights swapped in, a 2-step
     sample, its launches as counted);
  4d. `precompute` at full width (`precompute_phase`): a root of 2 test and
     3 train clips and seeded `open_clip_bigG.pt` (fp16, open_clip's
     layout) and `sd_vae.pt`, then the command (the bigG vision tower in
     f32 at d = 104, the VAE encoder, the bigG text tower): the tables'
     shapes and dtypes, one frame's tokens and latents within 2e-2 * max
     of the same towers on the CPU, the launches held to
     `precompute_launches`; s a 1000 frames by table, setup s, peak
     memory, bytes written; the files removed after;
  4e. SVD at full width (`svd_phase`): a reduced SVD card vs CPU
     (`svd_small_check`, 2e-2), then `VideoUNetConfig()` and
     `VideoDecoderConfig()` in bf16 from a seeded fp16 sgm-layout
     `svd.safetensors` read back through `load_svd`, one 14-frame 576x1024
     clip through `svd_img2vid` (25 EulerEDM steps, the linear CFG ramp,
     decoded in chunks of 7): setup, sampling and decode s, op counts and
     TFLOP/s, peak memory, the flash launches held to `svd_launches`
     (400 + 1 + 2), every frame finite; one UNet call and one decode chunk
     under torch.profiler (busy time, idle share, top kernels); each
     launched shape by the 1.5x rule (the [28, 5, 9216, 64] launch on a row
     slice) with its sums of launches x time;
  4f. the sgm autoencoder trainer and T5 (`autoencoder_phase`): a reduced
     trainer card vs CPU (`ae_small_check`: one generator and one
     discriminator step, gradients within 2e-2 of max, losses 2e-3); then
     `AutoencoderTrainConfig(disc_start=0)` at full width (`VAEConfig()`,
     LPIPS VGG16 from a seeded `vgg.pth` through `import_lpips`, the
     3-layer PatchGAN through its importer), f32 with TF32 convolutions,
     batch 4 of 256 px: 6 alternated generator and discriminator steps
     with the KL regularizer and 3 with VQ (8192 codes), each step's time,
     losses and d_weight, the peak memory, every step checked (finite,
     parameters moved, the generator pass leaving the running statistics),
     the flash launches (#1/#2 with lse and #4 at [4, 1, 1024, 1024, 512]
     f32) held to `autoencoder_launches`; one profiled step pair; one
     `ema.update` over the VAE; one generator step under
     NEURONS_TPU_FUSED_NORM=1 against the unfused one (`ae_fused_check`);
     then T5 (`t5_phase`: a reduced T5 card vs CPU, `t5_v1_1_xxl` at 2 x
     77 ids, `byt5_base` with its importer round trip). Every shape the
     CLI, the server, the engine, `validate`, `precompute` and the
     autoencoder step launched that no earlier check covered is then held
     by the same 1.5x rule (`cli_kernel_checks`);
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
  6. kernel phase for #7 and #8 at every (shape, dtype) the fused clip,
     the fused step and the fused autoencoder step (f32) launched, against
     float64 on the same inputs by the
     1.5x rule; times: kernel (by events, and its device time, every
     launch of a call, with calls queued behind a kernel that keeps the
     card busy while the host enqueues them (`device_ms`): the plain events
     measure the host's cost per call where it exceeds the device's work),
     plain version, the library composite (`F.silu(F.group_norm(...))`, then
     `F.conv2d` for #8) and the bound; #7's launch plan per shape.
Then one line of per-kernel totals for one clip or one step (launches x
time summed: kernel by events and, for #6-#8, by device time, bound,
library call), which gives the redesign order from one run, one line of
the f32 route's (the flash forward on f32) over a scored clip, a seg
panel, the CLI's stage e a clip, a precompute batch of 16 frames and one
validate run, and one line
of the same sums by the Pallas kernel each launch replaces. The last
two lines are the kernels' JSON record (each (kernel, shape) of the main
paths, the "max" fast clip's among them, those totals, the f32 route's,
the f32 flash checks with their bound and library
time, each kernel's registers and spills from nvcc's -Xptxas -v log) and
the device JSON. Any failure raises and exits non-zero; without CUDA the
script exits 2 before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import os
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
PLAIN_LOGITS_BYTES = 8 * 2**30  # the plain attention's f32 logits a call
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


def flash_phase(checks=None):
    """Flash kernel vs plain version at every shape of the clip (or at
    `checks`, [(site, (B, H, Tq, Tk, D), dtype)]). Returns {shape:
    record}."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    gen = torch.Generator("cuda").manual_seed(SEED)
    records = {}
    if checks is None:
        checks = [(name, shape, torch.bfloat16)
                  for name, shape in FLASH_SHAPES]
        checks += [(name, shape, torch.float32) for name, shape
                   in FLASH_SHAPES if name in F32_CHECKS]
        checks += [(name, shape, torch.float32)
                   for name, shape in PANEL_SHAPES]
        checks += [(name, shape, torch.bfloat16)
                   for name, shape in CAPTION_SHAPES]
        checks += [(name, shape, torch.float32)
                   for name, shape in METRIC_SHAPES]
    for name, (b, h, tq, tk, d), dt in checks:
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        k = torch.randn((b, h, tk, d), generator=gen, device="cuda")
        v = torch.randn((b, h, tk, d), generator=gen, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        qx, kx, vx = q.to(dt), k.to(dt), v.to(dt)
        got = attn.flash_attention_fwd(qx, kx, vx)
        torch.cuda.synchronize()
        # where the plain version's f32 logits of the whole launch pass
        # PLAIN_LOGITS_BYTES, the errors are taken on its first batch row
        # and the plain version runs a row at a time
        rows = 1 if b * h * tq * tk * 4 > PLAIN_LOGITS_BYTES else b
        q, k, v = q[:rows], k[:rows], v[:rows]
        want = attn.attention_reference(q, k, v)
        # the plain version at the kernel's precision: bf16 operands, or,
        # for f32, operands rounded to TF32 as the kernel's f32 route does
        if dt == torch.float32:
            plain = attn.attention_reference_tf32(q, k, v)
        else:
            plain = attn.attention_reference(qx[:rows], kx[:rows], vx[:rows])
        err = (got[:rows].float() - want).abs().max().item()
        plain_err = (plain.float() - want).abs().max().item()
        # the plain version is timed as the port would call it (TF32
        # products allowed for f32)
        torch.backends.cuda.matmul.allow_tf32 = dt == torch.float32
        reps = 5 if tq * tk > 10_000_000 else 20
        kernel_ms = cuda_ms(lambda: attn.flash_attention_fwd(qx, kx, vx),
                            reps)
        kernel_dev_ms = device_ms(
            lambda: attn.flash_attention_fwd(qx, kx, vx), reps)

        def plain_call():
            for i in range(0, b, rows):
                attn.attention_reference(qx[i:i + rows], kx[i:i + rows],
                                         vx[i:i + rows])

        plain_ms = cuda_ms(plain_call, reps)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qx, kx, vx), reps)
        torch.backends.cuda.matmul.allow_tf32 = False
        bound_ms, bound_by = attention_bound(
            b, h, tq, tk, d, qx.element_size(),
            PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS)
        bq, bk, smem = attn.flash_tiles(d, dt)
        route = attn.flash_route(d, dt)
        # the kernel's error <= 1.5x the plain version's at its precision,
        # as in tests/test_torch_port_cuda.py
        ok = bool(torch.isfinite(got).all()) and err <= 1.5 * plain_err
        tname = str(dt).split(".")[-1]
        log(f"flash {name:20s} {tname:8s} [{b},{h},{tq},{tk},{d}] {route} "
            f"tiles {bq}x{bk} smem {smem} B  max_abs_err {err:.3e} "
            f"(plain {plain_err:.3e}"
            + (f"; on row 0 of {b}, the plain version timed a row at a time"
               if rows < b else "")
            + f")  kernel_ms {kernel_ms:.4f} (device "
            f"{kernel_dev_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})  "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees at {name} {tname}: "
                                 f"{err:.3e} > 1.5 x {plain_err:.3e}")
        records[(b, h, tq, tk, d, tname, "")] = dict(
            site=name, max_abs_err=err, plain_err=plain_err, err_rows=rows,
            ms=kernel_ms,
            device_ms=kernel_dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            route=route)
        del q, k, v, want, got, plain, qx, kx, vx
    torch.cuda.empty_cache()
    return records


def temporal_bound(bf, d, c, esize, peak_flops):
    ops = 4.0 * bf * d * N_FRAMES * c   # 2 F x F x hd products a (b, d, h)
    nbytes = esize * 4 * bf * d * c     # q, k, v read once, out written once
    t_ops, t_bytes = ops / peak_flops, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def temporal_phase(checks=None):
    """Temporal kernel vs plain version at every shape of the clip (or at
    `checks`, [(site, ((B F), D, C, F, H), dtype)]), both against the
    float64 result on the same inputs. Returns {shape: record}."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(SEED)
    records = {}
    if checks is None:
        checks = [(name, shape + (N_FRAMES, MOTION_HEADS), torch.bfloat16)
                  for name, shape in TEMPORAL_SHAPES]
        checks += [(name, shape + (N_FRAMES, MOTION_HEADS), torch.float32)
                   for name, shape in TEMPORAL_SHAPES
                   if name in TEMPORAL_F32_CHECKS]
    for name, (bf, d, c, f, h), dt in checks:
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


def train_kernel_phase(checks=None):
    """The training kernels (forward with lse, backward) vs their plain
    versions at every stage-2 shape (or at `checks`, [(site, (B, H, Tq, Tk,
    D, kv heads), bias shape or None, dtype)]). Returns {(B, H, Tq, Tk, D,
    dtype, variant): record} for the forward and for the backward."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    fwd_records, bwd_records = {}, {}
    if checks is None:
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


LIBRARY_STAGE_S: dict = {}  # the unfused clip's last request: s a stage


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
        if not fused:
            LIBRARY_STAGE_S.update({"3": s3, "5": s5})
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
    seeds: unfused, then the fast configurations, the server and the sgm
    engine (unfused), then fused; each clip 2 counted requests and 1
    profiled; then one UNet2D and one UNet3D forward in both. Returns
    ({fused: {kernel: launches by shape}}, the fast phase's
    {configuration: {kernel: launches by shape}}, the first unfused clip's
    keyframe artifact and video on the host, and the serve and engine
    phases' (launches, runs))."""
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
                serve = serve_phase(models, pcfg)
                engine = engine_phase(models, pcfg)
                sample = (first[0].keyframe.float().cpu(),
                          first[1].video.float().cpu())
        by_config[fused] = by_shape
        del first
    fused_forward_check(models, pcfg)
    del models
    torch.cuda.empty_cache()
    return by_config, fast_by_config, sample, (serve, engine)


SERVE_BATCH = 2  # the server's batch: two clips a pipeline call


def serve_launches(models, pcfg, batch: int):
    """Flash and temporal launches of one served batch of `batch` clips
    (`serving.clip_pipeline`: `run_stage3` then `run_stage5`, bf16),
    counted from the code: the two samplers at that batch
    (`sampler_launches`); stage 3's VAE decoder once a keyframe (96^2
    latents) and once a blurry frame (64^2), the DecoderVideo twice over
    batch x 6 rows (enhance mode: the seg masks and the blurry latents);
    stage 5's VAE encoder once on the batch's interpolated
    frames (batch x 16) and once on its keyframes, its decoder on chunks
    of the largest divisor of batch x 16 up to 16 frames (32^2 latents)."""
    import collections

    dec = models[0]
    flash, temporal = collections.Counter(), collections.Counter()
    for stages in ("3", "5"):
        got = sampler_launches(models, pcfg, {}, {}, batch=batch,
                               stages=stages)
        flash.update(got["flash_attn_fwd"])
        temporal.update(got["temporal_attn_fwd"])
    rows = batch * pcfg.decoupler.n_frames
    f = pcfg.sampler.n_video_frames

    def vae(b, side):
        return (b, 1, side * side, side * side, 512, "bfloat16", "")

    flash[vae(1, 96)] += batch
    flash[vae(1, 64)] += rows
    for _ in range(2):  # enhance mode: the seg masks, then blurry latents
        flash.update(decoder_video_launches(dec.text_seg_dec.video_decoder,
                                            rows, 16, "bfloat16"))
    flash[vae(batch * f, 32)] += 1
    flash[vae(batch, 32)] += 1
    chunk = next(c for c in range(min(16, batch * f), 0, -1)
                 if batch * f % c == 0)
    flash[vae(chunk, 32)] += batch * f // chunk
    return {"flash_attn_fwd": dict(flash), "temporal_attn_fwd":
            dict(temporal)}


def _http(port: int, method: str, path: str, body: bytes = None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = (resp.status, resp.getheader("Content-Type"), resp.read())
    conn.close()
    return out


def serve_phase(models, pcfg):
    """The port's HTTP server over the clip phase's bf16 models
    (`serving.clip_pipeline`, batch 2, port 0), unfused: four concurrent
    single-clip requests, then one 2-clip request and one `?format=gif`
    request, then /healthz, /stats and one request of the wrong shape.
    The kernels' launch counts are zeroed just before the first request
    and read just after the last answer. Gates: every answer but the bad
    one is 200, with [k,16,3,256,256] in [0,1]; the bad one is 400; each
    served clip equals the direct pipeline call on its padded batch and
    seed (bitwise, else its largest difference is printed and held to
    2e-2 * max); the mean batch occupancy is above 1; the GIF is the
    native codec's encoding of its batch's clip; /healthz names the card;
    the launches equal `serve_launches` at batch 2 times the batches.
    Prints the seconds a batch, the clients' p50/p95, the occupancy and
    clips/s beside the clip phase's seconds a clip at batch 1. Returns
    ({path: {kernel: launches by shape}}, {path: batches})."""
    import io
    import threading

    import numpy as np
    import torch
    from neurons_tpu_torch import native_io, serving

    d = pcfg.decoupler
    classes = torch.randn((d.num_classes, d.clip_txt_emb_dim),
                          generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    pipeline = serving.clip_pipeline(models, pcfg, (96, 256, 60), classes,
                                     "cuda")
    batches = []

    def recorded(voxels, seed):
        t0 = time.perf_counter()
        out = pipeline(voxels, seed)
        batches.append(dict(voxels=voxels.copy(), seed=seed, out=out,
                            s=time.perf_counter() - t0))
        return out

    n_vox = pcfg.brain.voxel_counts[0]
    srv = serving.InferenceServer(recorded, n_vox, serving.ServerConfig(
        port=0, batch_size=SERVE_BATCH, max_wait_ms=500.0),
        device="cuda").start()
    rng = np.random.default_rng(SEED + 2)
    requests = {f"single {i}": 0.5 * rng.standard_normal((n_vox,))
                for i in range(4)}
    requests["pair"] = 0.5 * rng.standard_normal((2, n_vox))
    requests["gif"] = 0.5 * rng.standard_normal((n_vox,))
    requests = {k: v.astype(np.float32) for k, v in requests.items()}
    answers = {}

    def client(tag, path="/reconstruct"):
        buf = io.BytesIO()
        np.save(buf, requests[tag])
        t0 = time.perf_counter()
        answers[tag] = _http(srv.port, "POST", path, buf.getvalue()) + (
            time.perf_counter() - t0,)

    counters = cli_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t_start = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(f"single {i}",))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        client("pair")
        client("gif", "/reconstruct?format=gif")
        wall = time.perf_counter() - t_start
        launches = {k: dict(c.by_shape) for k, c in counters.items()}
        health = json.loads(_http(srv.port, "GET", "/healthz")[2])
        stats = json.loads(_http(srv.port, "GET", "/stats")[2])
        buf = io.BytesIO()
        np.save(buf, np.zeros((n_vox + 1,), np.float32))
        bad = _http(srv.port, "POST", "/reconstruct", buf.getvalue())
    finally:
        srv.close()
    if any(th.is_alive() for th in threads):
        raise AssertionError("serve: a client did not finish")

    checks = {"bad shape answered 400": bad[0] == 400}
    videos = {}
    for tag, (status, ctype, body, _) in answers.items():
        checks[f"{tag} answered 200"] = status == 200
        if status != 200:
            log(f"serve {tag}: {status} {body[:300]!r}")
        elif tag != "gif":
            videos[tag] = np.load(io.BytesIO(body))
    for tag, v in videos.items():
        k = 2 if tag == "pair" else 1
        checks[f"{tag} [{k},16,3,256,256] in [0,1]"] = (
            v.shape == (k, 16, 3, 256, 256) and bool(np.isfinite(v).all())
            and v.min() >= 0.0 and v.max() <= 1.0)

    # each served clip against the direct call on its padded batch and seed
    def where(row):
        for b in batches:
            for i, r in enumerate(b["voxels"]):
                if np.array_equal(r, row):
                    return b, i
        raise AssertionError("serve: a request's voxels are in no batch")

    diffs = []
    for b in batches:
        direct = pipeline(b["voxels"], b["seed"])
        err = float(np.abs(b["out"] - direct).max())
        b["direct"] = direct
        diffs.append(err)
        if err:
            log(f"serve batch seed {b['seed']}: served vs direct max |diff| "
                f"{err:.3e} of max {np.abs(direct).max():.3e} (not bitwise: "
                f"the batch ran again on the same inputs, held to 2e-2)")
            checks[f"batch {b['seed']} within 2e-2 of the direct call"] = (
                err <= 2e-2 * float(np.abs(direct).max()))
    for tag, v in videos.items():
        rows = requests[tag].reshape(-1, n_vox)
        for j, row in enumerate(rows):
            b, i = where(row)
            checks[f"{tag} clip {j} is its batch's row {i}"] = \
                np.array_equal(v[j], b["out"][i])
    if answers["gif"][0] == 200:
        b, i = where(requests["gif"])
        checks["the GIF is the native codec's"] = (
            native_io.available() and answers["gif"][1] == "image/gif"
            and answers["gif"][2] == serving._encode_gif(b["out"][i:i + 1]))
    occupancy = stats["mean_batch_occupancy"]
    checks["mean occupancy above 1"] = occupancy is not None and occupancy > 1
    checks["healthz names the card"] = (
        health["platform"] == "cuda"
        and health["device"] == torch.cuda.get_device_name(0))
    want = serve_launches(models, pcfg, SERVE_BATCH)
    n_batches = len(batches)
    problems = []
    for kernel in want:
        got = launches[kernel]
        for key in sorted(set(got) | set(want[kernel]), key=str):
            if got.get(key, 0) != want[kernel].get(key, 0) * n_batches:
                problems.append(f"{kernel} {key}: {got.get(key, 0)} "
                                f"launched, {want[kernel].get(key, 0)} x "
                                f"{n_batches} from the code")
    problems += [k for k in ("flash_attn_bwd", "gn_silu", "gn_silu_conv")
                 if launches[k]]
    checks["launches equal serve_launches x batches"] = not problems

    lat = sorted(a[3] for a in answers.values())
    batch_s = [round(b["s"], 3) for b in batches]
    clips = sum(len(r.reshape(-1, n_vox)) for r in requests.values())
    lib = LIBRARY_STAGE_S.get("3", float("nan")) + LIBRARY_STAGE_S.get(
        "5", float("nan"))
    log(f"serve: {n_batches} batches of {SERVE_BATCH} (seeds "
        f"{[b['seed'] for b in batches]}), s a batch {batch_s} (mean "
        f"{np.mean(batch_s):.3f}, {np.mean(batch_s) / SERVE_BATCH:.3f} s a "
        f"clip), clients' latency p50 {np.percentile(lat, 50):.3f} s p95 "
        f"{np.percentile(lat, 95):.3f} s (server p50 "
        f"{stats['latency_ms_p50']} ms, p95 {stats['latency_ms_p95']} ms), "
        f"mean occupancy {occupancy}, {clips} clips in {wall:.1f} s = "
        f"{clips / wall:.3f} clips/s; the clip phase's clip at batch 1: "
        f"{lib:.3f} s; served vs direct max |diff| by batch {diffs}; "
        f"launches {({k: sum(v.values()) for k, v in launches.items()})} "
        f"({({k: sum(v.values()) for k, v in want.items()})} a batch from "
        f"the code); health {health}")
    log(f"serve checks: {checks}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve fails {failed} {problems[:8]}")
    return {"serve": launches}, {"serve": n_batches}


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
                     batch=1, dtype="bfloat16", stages="35"):
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
    launch. `stages` picks the samplers counted ("3", "5" or both)."""
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

    n = s.unclip_steps if "3" in stages else 0
    if not n:
        pass
    elif s3_opts.get("tgate_step", 0) > 0:
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

    n = s.video_steps if "5" in stages else 0
    if not n:
        pass
    elif s5_opts.get("tgate_step", 0) > 0:
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
# (the forward's four kernels: flash_fwd_reg_kernel, flash_fwd_wide_kernel,
# flash_fwd_tf32_kernel, flash_fwd_kernel; #8's halo, split-reduce and TF32
# kernels)
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
    from neurons_tpu_torch.diffusion.prior import PriorNoise
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.pipelines import e2e
    from neurons_tpu_torch.pipelines import keyframe as kf
    from neurons_tpu_torch.training import loop
    from neurons_tpu_torch.utils import checkpoint as ckpt

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
        with ckpt_tmpdir(f"tiny chain, {dev}") as d:
            r1, r2 = Recorder(), Recorder()
            loop.run_stage1(c, tcfg, train, test, table, test_table,
                            ckpt_dir=d, logger=r1, host_draws=True,
                            device=dev)
            s2 = loop.run_stage2(
                c, pcfg.prior, dcfg, tcfg, gcfg, train,
                loop.structured_stage2_batch_builder(table, aux, train, dcfg,
                                                     gcfg.vocab_size),
                core_params=ckpt.load_stage1_core(d), ckpt_dir=d, logger=r2,
                last_save_every=1, host_draws=True, device=dev)
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


# --- the CLI: stages 3, 5, e and 6 at full width, the tiny chain ------------

CLI_CLIPS = 2       # test clips of the full-width `pipeline 35e6`
CLI_FRAMES = 6      # frames of a stage-5 GIF (16 -> 4:, every other one)
# a small CLIP BPE merges table (the first line is the format's header)
BPE_MERGES = ["#version: 0.2", "t o", "to k", "tok e", "toke n", "token s",
              "a n</w>", "i n</w>", "t h", "th e</w>", "s c", "sc e",
              "sce n", "scen e</w>"]


def write_cc2017_root(root: Path, n: int, rng, txt_dim: int = 1280,
                      n_train: int = 0, img: int = 224):
    """The CC2017 test split of subject 1 at its real widths (13447 voxels,
    three repeats, 6 frames of `img` = 224 px) in the layout `load_split`
    reads, with its captions, qwen annotation, test key-object masks and
    info, the class-name table `class_text_embeds.npy`, and a BPE merges
    file; with `n_train`, a train split of that many clips too (two
    repeats, its key-object masks and info). Returns the merges file's
    path."""
    import numpy as np
    import torch
    from neurons_tpu_torch.config import SUBJECT_VOXELS
    from neurons_tpu_torch.data.categories import CLS_DICT

    (root / "qwen_annotation").mkdir(parents=True)
    (root / "masks").mkdir()

    def save(x, name):
        torch.save(torch.from_numpy(np.ascontiguousarray(x)), root / name)

    for tag, m, repeats, masks in (("test", n, 3, "qwen_test"),
                                   ("train", n_train, 2, "train")):
        if not m:
            continue
        save(rng.standard_normal((m, repeats, SUBJECT_VOXELS[1]),
                                 dtype=np.float32), f"subj01_{tag}_fmri.pt")
        save(rng.uniform(size=(m, 6, 3, img, img)).astype(np.float32),
             f"GT_{tag}_3fps.pt")
        save(rng.standard_normal((m, txt_dim), dtype=np.float32),
             f"GT_{tag}_caption_emb.pt")
        torch.save([f"a {CLS_DICT[i % 51]} in the scene" for i in range(m)],
                   root / f"GT_{tag}_caption.pt")
        with open(root / "qwen_annotation" /
                  f"qwen_{tag}_caption_tag_category_id.json", "w") as f:
            json.dump([{"category_id": [i, (i + 3) % 51]} for i in range(m)],
                      f)
        save((rng.uniform(size=(m, 6, img, img)) < 0.3).astype(np.float32),
             f"masks/key_objects_masks_{masks}.pt")
        with open(root / "masks" / f"key_objects_info_{masks}.json",
                  "w") as f:
            json.dump({str(i): {"category": CLS_DICT[(i + 1) % 51]}
                       for i in range(m)}, f)
    np.save(root / "class_text_embeds.npy",
            rng.standard_normal((51, txt_dim), dtype=np.float32))
    merges = root / "bpe_simple_vocab.txt"
    merges.write_text("\n".join(BPE_MERGES) + "\n")
    return merges


def full_width_configs() -> dict:
    """The configurations the CLI runs at full width: stage 3's, stage 5's
    (16 frames) and the ensemble's."""
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import GPT2Config

    pcfg = config.PipelineConfig()
    return dict(unet2d=pcfg.unet2d, vae=pcfg.vae, unet3d=pcfg.unet3d,
                n_frames=16, brain=pcfg.brain, prior=pcfg.prior,
                decoupler=pcfg.decoupler, gpt2=GPT2Config(),
                text=CLIPTextConfig.sd15())


def write_reference_weights(weights: Path, cfgs=None, device="cuda",
                            classifiers: bool = True) -> dict:
    """The reference's weight files at full width, from modules with
    seeded random weights (`synth_params_`, every head non-zero) drawn on
    the card, through the exporters of `interop/torch_export.py` (the
    importers inverted): the unclip6 Lightning checkpoint (live UNet
    weights in bf16, their EMA shadows and the VAE in f32), the SD-1.5
    base as fp16 safetensors (LDM UNet, VAE, text encoder), the motion
    module and SparseCtrl in fp16, a rank-32 LoRA over every spatial
    attention projection, the NEURONS ensemble in f32 and the three
    classifiers of stage 6 (`classifiers`). `cfgs` are the widths
    (`full_width_configs()` by default). Returns {file: (bytes,
    seconds)}."""
    import re

    import torch
    from neurons_tpu_torch.interop import convert_ldm
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.models.clip import CLIPTextTower
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.utils.synth_init import synth_params_

    weights.mkdir(parents=True, exist_ok=True)
    c = cfgs or full_width_configs()
    out = {}

    def tree_of(build, seed):
        m = synth_params_(build(device=device), seed)
        tree = tex.jax_tree(m)
        del m
        if device == "cuda":
            torch.cuda.empty_cache()
        return tree

    def prefixed(prefix, sd):
        return {prefix + k: v for k, v in sd.items()}

    def saved(name, write):
        t0 = time.perf_counter()
        write(str(weights / name))
        out[name] = (os.path.getsize(weights / name),
                     time.perf_counter() - t0)
        log(f"cli: wrote {name}: {out[name][0] / 1e9:.3f} GB in "
            f"{out[name][1]:.1f} s")

    ucfg, vcfg, u3 = c["unet2d"], c["vae"], c["unet3d"]
    ldm = prefixed("model.diffusion_model.", tex.ldm_unet_state_dict(
        tree_of(lambda **kw: UNetModel(ucfg, **kw), SEED + 50), ucfg))
    sd = {k: -v for k, v in tex.to_torch(ldm, torch.bfloat16).items()}
    sd.update(tex.to_torch(tex.ema_state_dict(ldm)))
    del ldm
    sd.update(tex.to_torch(prefixed("first_stage_model.",
                                    tex.ldm_vae_state_dict(tree_of(
                                        lambda **kw: AutoencoderKL(vcfg, **kw),
                                        SEED + 51), vcfg))))
    saved("unclip6_epoch0_step110000.ckpt", lambda p: torch.save(
        {"state_dict": sd, "epoch": 0, "global_step": 110000}, p))
    del sd

    tree = tree_of(lambda **kw: UNet3DModel(u3, n_frames=c["n_frames"],
                                            **kw), SEED + 52)
    base = prefixed("model.diffusion_model.",
                    tex.ldm_unet3d_state_dict(tree, u3))
    mm = tex.motion_module_state_dict(tree, u3)
    del tree
    diffusers = convert_ldm.convert_ldm_unet_to_diffusers(
        {k[len("model.diffusion_model."):]: v for k, v in base.items()})
    keys = sorted(k for k in diffusers if re.search(
        r"attentions\.\d+\.transformer_blocks\.0\.attn[12]\."
        r"(to_q|to_k|to_v|to_out\.0)\.weight$", k))
    lora = tex.lora_state_dict(keys, {k: diffusers[k].shape for k in keys},
                               rank=32, seed=SEED + 53)
    del diffusers
    base.update(prefixed("first_stage_model.", tex.ldm_vae_state_dict(
        tree_of(lambda **kw: AutoencoderKL(vcfg, **kw), SEED + 54), vcfg)))
    ccfg = c["text"]
    text = tree_of(lambda **kw: CLIPTextTower(ccfg, **kw), SEED + 55)
    text.pop("text_projection")  # SD's text encoder has none
    base.update(prefixed("cond_stage_model.transformer.",
                         tex.hf_clip_text_state_dict(text, ccfg.layers)))
    saved("realisticVisionV60B1_v51VAE.safetensors",
          lambda p: tex.write_safetensors(
              p, tex.to_torch(base, torch.float16), {"format": "pt"}))
    del base
    saved("v3_sd15_mm.ckpt", lambda p: torch.save(
        tex.to_torch(mm, torch.float16), p))
    del mm
    saved("v3_sd15_adapter.ckpt", lambda p: torch.save(
        tex.to_torch(lora), p))
    cn = tex.sparse_controlnet_state_dict(tree_of(
        lambda **kw: SparseControlNetModel(u3, n_frames=c["n_frames"], **kw),
        SEED + 56), u3)
    saved("v3_sd15_sparsectrl_rgb.ckpt", lambda p: torch.save(
        tex.to_torch(cn, torch.float16), p))
    del cn
    b, pr, gcfg = c["brain"], c["prior"], c["gpt2"]
    ens = tex.neurons_ensemble_state_dict(
        tree_of(lambda **kw: NeuronsDecoupler(b, pr, c["decoupler"], gcfg,
                                              **kw), SEED + 57),
        n_blocks=b.n_blocks, prior_depth=pr.depth, gpt2_layers=gcfg.n_layer)
    saved("brain_model_prior_last.pth", lambda p: torch.save(
        {"model_state_dict": tex.to_torch(ens), "epoch": 149}, p))
    del ens
    if classifiers:
        t0 = time.perf_counter()
        n = write_metric_weights(weights, CLI_FRAMES, device)
        log(f"cli: wrote the stage-6 classifiers ({n / 1e9:.3f} B params) "
            f"in {time.perf_counter() - t0:.1f} s")
    return out


def decoder_video_launches(dec_video, rows: int, base: int, dtype: str):
    """Flash launches of one DecoderVideo forward at `rows` rows, counted
    from its structure: every spatial attention (single head, d = the
    block's channels) at its block's side (`base` in the mid block and
    the first up block, doubled by each upsample); the temporal attention
    runs over `rows` frames, a flash launch only from 128."""
    import collections
    from neurons_tpu_torch.models.decoder_video import _SpatialTemporalAttn

    out = collections.Counter()
    blocks = [(dec_video.mid_block, base)] + [
        (getattr(dec_video, f"up_block_{i}"), base << i)
        for i in range(dec_video.n_up)]
    for block, side in blocks:
        for m in block.children():
            if isinstance(m, _SpatialTemporalAttn):
                c = m.attn.to_q.in_features
                t = side * side
                if t >= 128:
                    out[(rows, 1, t, t, c, dtype, "")] += 1
                if rows >= 128:
                    out[(t, 1, rows, rows, c, dtype, "")] += 1
    return out


def cli_launches(n_clips: int):
    """Flash and temporal launches of `pipeline 35e6 --n_test n_clips` at
    full width with the classifiers present, counted from the code:
      stage 3 (one batch of n_clips, bf16): the unCLIP sampler at that
      batch (`sampler_launches`), the VAE decoder's mid attention once a
      keyframe (96 x 96 latents) and once a blurry frame (64 x 64), the
      DecoderVideo once over n_clips x 6 rows;
      stage 5 (batch 1 a clip, bf16): the UNet3D and SparseCtrl sampler,
      the VAE encoder on the 16 interpolated frames and on the keyframe,
      the decoder on the 16 frames (32 x 32 latents);
      stage e (f32): the DecoderVideo once over n_clips x 6 rows;
      stage 6 (f32): `scored_clip_launches` a clip."""
    import collections

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.gpt2 import GPT2Config
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel

    pcfg = config.PipelineConfig()
    with torch.device("meta"):
        dec = NeuronsDecoupler(pcfg.brain, pcfg.prior, pcfg.decoupler,
                               GPT2Config(), device="meta")
        unet = UNetModel(pcfg.unet2d, device="meta")
        unet3d = UNet3DModel(pcfg.unet3d, n_frames=16, device="meta")
        cn = SparseControlNetModel(pcfg.unet3d, n_frames=16, device="meta")
    models = (dec, unet, None, None, unet3d, cn)
    flash, temporal = collections.Counter(), collections.Counter()
    s3 = sampler_launches(models, pcfg, {}, {}, batch=n_clips, stages="3")
    s5 = sampler_launches(models, pcfg, {}, {}, batch=1, stages="5")
    flash.update(s3["flash_attn_fwd"])
    for k, v in s5["flash_attn_fwd"].items():
        flash[k] += v * n_clips
    for k, v in s5["temporal_attn_fwd"].items():
        temporal[k] += v * n_clips
    rows = n_clips * pcfg.decoupler.n_frames
    vae = lambda b, side: (b, 1, side * side, side * side, 512,  # noqa
                           "bfloat16", "")
    flash[vae(1, 96)] += n_clips
    flash[vae(1, 64)] += rows
    flash.update(decoder_video_launches(dec.text_seg_dec.video_decoder, rows,
                                        16, "bfloat16"))
    flash[vae(16, 32)] += 2 * n_clips
    flash[vae(1, 32)] += n_clips
    flash.update(decoder_video_launches(dec.text_seg_dec.video_decoder, rows,
                                        16, "float32"))
    for k, v in scored_clip_launches(CLI_FRAMES).items():
        flash[k] += v * n_clips
    return {"flash_attn_fwd": dict(flash), "temporal_attn_fwd":
            dict(temporal)}


class _RecordGrids:
    """`pipelines/io.save_video_grid` wrapped to keep a copy of each grid
    (ground truth beside the video, f32, before the GIF's quantisation)."""

    def __enter__(self):
        from neurons_tpu_torch.pipelines import io
        self.io, self.original, self.grids = io, io.save_video_grid, {}

        def record(videos, path, *a, **kw):
            self.grids[os.path.basename(path)] = videos.copy()
            return self.original(videos, path, *a, **kw)

        io.save_video_grid = record
        return self

    def __exit__(self, *exc):
        self.io.save_video_grid = self.original


def cli_counters():
    from neurons_tpu_torch.ops.attention import (FLASH_BWD_LAUNCHES,
                                                 FLASH_FWD_LAUNCHES)
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES
    return {"flash_attn_fwd": FLASH_FWD_LAUNCHES,
            "flash_attn_bwd": FLASH_BWD_LAUNCHES,
            "temporal_attn_fwd": TEMPORAL_ATTN_LAUNCHES, **gn_counters()}


def run_cli(argv, what: str):
    """`cli.main(argv)` with every launch counter zeroed just before and
    read just after; returns ({kernel: {key: launches}}, the pipeline's
    per-stage rows (none for another command), wall seconds)."""
    import tempfile

    import torch
    from neurons_tpu_torch import cli

    counters = cli_counters()
    fd, report = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    os.environ["NEURONS_TPU_PIPELINE_REPORT"] = report
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        del os.environ["NEURONS_TPU_PIPELINE_REPORT"]
    wall = time.perf_counter() - t0
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    with open(report) as f:  # only `pipeline` writes its rows
        text = f.read()
    rows = json.loads(text) if text else []
    os.remove(report)
    log(f"cli {what}: {wall:.1f} s, launches "
        f"{ {k: sum(v.values()) for k, v in launches.items()} }")
    for r in rows:
        log(f"cli {what} stage {r['stage']}: {json.dumps(r)}")
    return launches, rows, wall


def check_cli_outputs(exp: str, n: int, hw: int, frames: int,
                      blurry_frames: int, what: str, n_gifs=None):
    """Stage 3's artifacts (names, shapes, ranges), the GIFs stage 6 reads,
    and the metric report of one `pipeline` run; returns the report."""
    import numpy as np
    from neurons_tpu_torch.pipelines import io

    st3 = io.stage3_dir(exp, "exp1", 1, False)
    art = io.load_stage3_artifacts(st3, 1)
    rec, blur = art["all_recons"], art["blurry_videos"]
    caps = io.load_captions(st3, "self")
    vdir = io.video_dir(exp, "exp1", 1, "motion")
    gifs = sorted(f for f in os.listdir(vdir) if f.endswith(".gif"))
    frames_ok = all(io.load_gif(os.path.join(vdir, g)).shape[0] == frames
                    for g in gifs)
    with open(os.path.join(io.exp_dir(exp, "exp1", 1),
                           "metrics_motion.json")) as f:
        report = json.load(f)
    checks = {
        f"recons [{n},3,{hw},{hw}]": rec.shape == (n, 3, hw, hw),
        f"blurry [{n},{blurry_frames},3,...]": blur.shape[:3] == (
            n, blurry_frames, 3),
        "artifacts finite": bool(np.isfinite(rec).all()
                                 and np.isfinite(blur).all()),
        "artifacts in [0,1] to 1e-6": bool(
            rec.min() >= -1e-6 and rec.max() <= 1 + 1e-6
            and blur.min() >= -1e-6 and blur.max() <= 1 + 1e-6),
        "captions": len(caps) == n and all(
            c.startswith("tokens:") for c in caps),
        f"{n_gifs or n} GIFs of {frames} frames": (
            len(gifs) == (n_gifs or n) and frames_ok),
        "GIF names": all(g.split("-", 1)[0].isdigit() for g in gifs),
        "report finite": all(np.isfinite(v) for v in report.values()),
    }
    log(f"cli {what} outputs: {checks}; report {report}; GIFs {gifs}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli {what}: outputs fail {failed}")
    return report, art


def compare_reports(card: dict, cpu: dict, what: str) -> dict:
    """Stage 6's report on the card against the CPU's on the same GIFs:
    SSIM and PSNR within 1e-5 (relative); every other key logged with its
    difference (an n-way accuracy or CLIP-pcc that differs is not a
    failure here: ROADMAP queue 3 records it). Returns the differences."""
    if sorted(card) != sorted(cpu):
        raise AssertionError(f"{what}: report keys differ: {sorted(card)} vs "
                             f"{sorted(cpu)}")
    diffs = {k: card[k] - cpu[k] for k in card}
    bad = [k for k in ("ssim", "psnr")
           if abs(diffs[k]) > 1e-5 * max(1.0, abs(cpu[k]))]
    log(f"{what}: card {card}; CPU {cpu}; card - CPU {diffs}; SSIM/PSNR "
        f"within 1e-5: {not bad}")
    if bad:
        raise AssertionError(f"{what}: {bad} differ beyond 1e-5")
    return diffs


def explain_nway_differences(vdir: str, weights: str):
    """Where an n-way accuracy or CLIP-pcc differs between the card and
    the CPU: the classifiers' outputs on the same frames on both (ViT-B
    logits of every ground-truth and predicted frame, VideoMAE logits of
    every clip, CLIP embeddings), their largest difference, and on how
    many rows the top-1 class and the full argsort differ (a tie or near
    tie that the card's TF32 attention reorders)."""
    import numpy as np
    from neurons_tpu_torch.evaluation.runner import (build_metric_classifiers,
                                                     load_gif_dir)

    gts, preds = load_gif_dir(vdir)
    outs = {}
    for dev in ("cuda", "cpu"):
        cls = build_metric_classifiers(weights, CLI_FRAMES, device=dev)
        frames = [f for clip in (*gts, *preds) for f in clip]
        outs[dev] = {
            "frame logits": np.stack([cls.img_logits_fn(f) for f in frames]),
            "video logits": np.stack([cls.video_logits_fn(c)
                                      for c in (*gts, *preds)]),
            "clip embeddings": np.concatenate([cls.clip_embed_fn(c)
                                               for c in preds])}
    for name in outs["cpu"]:
        a, b = outs["cuda"][name], outs["cpu"][name]
        msg = f"n-way difference, {name}: max |card - CPU| " \
              f"{np.abs(a - b).max():.3e} of max {np.abs(b).max():.3e}"
        if "logits" in name:
            msg += (f", top-1 differs on {int((a.argmax(-1) != b.argmax(-1)).sum())}"
                    f" of {len(a)} rows, argsort on "
                    f"{int((np.argsort(a, -1) != np.argsort(b, -1)).any(-1).sum())}")
        log(msg)


def cli_phase():
    """The port's CLI on the card.

    1. Full width: a CC2017 root of 2 test clips (`write_cc2017_root`) and
       the reference's weight files (`write_reference_weights`), then
       `pipeline 35e6 --n_test 2` from them: stage 3 from the unclip6
       checkpoint and the reference ensemble (bf16, batch 2), stage 5 from
       the SD-1.5 base, motion module, LoRA and SparseCtrl with the
       captions through the SD-1.5 text encoder (the non-synthetic
       branch), stage e (f32) and stage 6 with the three classifiers.
       Each bundle's load seconds, bytes and host peak RSS; s/clip of
       stages 3 and 5 beside the library path's (the clip phase); each
       stage's peak device memory; every flash and temporal launch held
       to `cli_launches` (no GN launch: unfused); the artifacts, GIFs and
       report checked.
    2. Stage 6 again on the same GIFs with `--platform cpu`: SSIM and PSNR
       within 1e-5 of the card's; the other keys' differences logged.
    3. `validate` on the same weight files (the real-weight branches of
       both stages, f32 at full width, `validate_on`), and
       `DiffusionEngine.from_checkpoint` on the unclip6 file
       (`engine_from_checkpoint`).
    4. `pipeline 12345e6 --tiny --synthetic --num_epochs 1` on the card and
       with `--platform cpu` (weights and stage-2 draws made on the CPU for
       both): stage-3 keyframes and stage-5 videos within 2e-2 of max
       |CPU|, equal caption tokens, equal stage-e class predictions, the
       same report keys.
    Files live in a git-ignored directory of the checkout, removed after.
    Returns ({path: {kernel: launches by shape}}, {path: runs})."""
    import shutil

    import numpy as np
    import torch
    from neurons_tpu_torch.data import clip_tokenizer
    from neurons_tpu_torch.pipelines import io

    rng = np.random.default_rng(SEED)
    by_path = {}
    with ckpt_tmpdir("cli: dataset, reference weights, EXP") as d:
        d = Path(d)
        root, weights, exp = d / "cc2017", d / "weights", d / "EXP"
        merges = write_cc2017_root(root, CLI_CLIPS, rng)
        t0 = time.perf_counter()
        files = write_reference_weights(weights)
        total = sum(b for b, _ in files.values())
        log(f"cli: reference weight files {total / 1e9:.3f} GB in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{shutil.disk_usage(d).free} bytes free")
        old_bpe = os.environ.get("CLIP_BPE_PATH")
        os.environ["CLIP_BPE_PATH"] = str(merges)
        clip_tokenizer._tokenizer = None
        common = ["--root_dir", str(root), "--weights_dir", str(weights),
                  "--exp_dir", str(exp), "--seed", str(SEED)]
        try:
            with configuration(False):
                torch.cuda.empty_cache()
                launches, rows, wall = run_cli(
                    ["pipeline", "35e6", "--n_test", str(CLI_CLIPS),
                     *common], "pipeline 35e6 (full width)")
        finally:
            clip_tokenizer._tokenizer = None
            if old_bpe is None:
                del os.environ["CLIP_BPE_PATH"]
            else:
                os.environ["CLIP_BPE_PATH"] = old_bpe
        from neurons_tpu_torch import cli
        for name, st in cli._LOAD_STATS.items():
            log(f"cli load {name}: {st['seconds']:.3f} s, "
                f"{st['bytes'] / 1e9:.3f} GB, host RSS "
                f"{st['rss_before_bytes'] / 2**30:.2f} GiB before, peak "
                f"{st['peak_rss_bytes'] / 2**30:.2f} GiB")
        by_stage = {r["stage"]: r for r in rows}
        for s in ("3", "5"):
            log(f"cli stage {s}: steady {by_stage[s]['steady_s_per_clip']} "
                f"s/clip through the CLI (setup "
                f"{by_stage[s].get('setup_s')} s) vs "
                f"{LIBRARY_STAGE_S.get(s, float('nan')):.3f} s/clip on the "
                f"library path (the clip phase's stage {s})")
        log("cli peak device memory by stage (GiB): " + ", ".join(
            f"{r['stage']} {r.get('peak_device_gib')}" for r in rows)
            + f"; wall {wall:.1f} s")
        check_counted("cli pipeline 35e6", launches, cli_launches(CLI_CLIPS))
        by_path["cli pipeline 35e6"] = launches
        report_card, _ = check_cli_outputs(str(exp), CLI_CLIPS, 256,
                                           CLI_FRAMES, 6, "full width")
        e = by_stage["e"]
        log(f"cli stage e: dice {e['dice']:.4f} accuracy "
            f"{e['cls_accuracy']:.4f} precision {e['cls_precision']:.4f} "
            f"recall {e['cls_recall']:.4f} in {e['s']} s")

        # 2. stage 6 on the CPU over the same GIFs
        t0 = time.perf_counter()
        cli.main(["eval", "--platform", "cpu", *common])
        log(f"cli eval on the CPU: {time.perf_counter() - t0:.1f} s")
        with open(os.path.join(io.exp_dir(str(exp), "exp1", 1),
                               "metrics_motion.json")) as f:
            report_cpu = json.load(f)
        diffs = compare_reports(report_card, report_cpu,
                                "stage 6 full width card vs CPU")
        if any(diffs[k] for k in diffs if k not in ("ssim", "psnr")):
            explain_nway_differences(
                io.video_dir(str(exp), "exp1", 1, "motion"), str(weights))

        # 3. validate on the same reference-layout weights, f32, and the
        # sgm engine from the unclip6 file
        by_path["cli validate"] = validate_on(weights)
        with configuration(False):
            by_path["engine from_checkpoint"] = engine_from_checkpoint(
                weights)
        shutil.rmtree(weights)
        log(f"cli: weights removed; {shutil.disk_usage(d).free} bytes free")

        # 4. the tiny chain 12345e6, card against CPU
        outs = {}
        for dev in ("cuda", "cpu"):
            tiny = ["pipeline", "12345e6", "--tiny", "--synthetic",
                    "--num_epochs", "1", "--platform", dev, "--exp_dir",
                    str(d / f"tiny_{dev}"), "--weights_dir",
                    str(d / "no_weights"), "--root_dir", str(d / "no_root"),
                    "--seed", str(SEED)]
            with configuration(False), _RecordGrids() as grids:
                launches, rows, _ = run_cli(tiny, f"tiny 12345e6 {dev}")
            if dev == "cuda":
                by_path["cli tiny 12345e6"] = launches
                for k in ("flash_attn_fwd", "flash_attn_bwd",
                          "temporal_attn_fwd"):
                    if not launches[k]:
                        raise AssertionError(f"the tiny chain launched no "
                                             f"{k} on the card")
            # stage 5 takes the first 2 of stage 3's 4 clips under --tiny
            rep, art = check_cli_outputs(str(d / f"tiny_{dev}"), 4, 16, 4,
                                         2, f"tiny {dev}", n_gifs=2)
            outs[dev] = (art, dict(grids.grids), rep,
                         next(r for r in rows if r["stage"] == "e"))
        (a_gpu, g_gpu, r_gpu, e_gpu), (a_cpu, g_cpu, r_cpu, e_cpu) = (
            outs["cuda"], outs["cpu"])

        def rel(x, y):
            return float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))

        kf_err = rel(a_gpu["all_recons"], a_cpu["all_recons"])
        vid = [rel(g_gpu[k], g_cpu[k]) for k in sorted(g_cpu)]
        ok = (kf_err <= 2e-2 and sorted(g_gpu) == sorted(g_cpu)
              and max(vid) <= 2e-2
              and a_gpu["captions"] == a_cpu["captions"]
              and e_gpu["cls_pred"] == e_cpu["cls_pred"]
              and sorted(r_gpu) == sorted(r_cpu))
        log(f"cli tiny 12345e6 card vs CPU: keyframes rel err {kf_err:.3e}, "
            f"videos {[f'{v:.3e}' for v in vid]} (<= 2e-2), captions equal "
            f"{a_gpu['captions'] == a_cpu['captions']}, stage-e class "
            f"predictions equal {e_gpu['cls_pred'] == e_cpu['cls_pred']}, "
            f"dice {e_gpu['dice']:.6f} vs {e_cpu['dice']:.6f}, report keys "
            f"{sorted(r_gpu)}: {ok}")
        if not ok:
            raise AssertionError("the tiny CLI chain on the card disagrees "
                                 "with the CPU")
    return by_path, {"cli pipeline 35e6": CLI_CLIPS, "cli tiny 12345e6": 1,
                     "cli validate": 1, "engine from_checkpoint": 1}


def validate_launches():
    """Flash and temporal launches of one full-width `validate`, counted
    from the code: the exact unCLIP sampler at 64^2 latents (38 steps) and
    the exact UNet3D + SparseCtrl sampler at 32^2 latents (16 frames, 25
    steps) once each, then each distinct fast option set of the presets
    once (`pipelines/validate.py` runs an option set once), all f32 at
    batch 1; the stand-in autoencoder launches nothing."""
    import collections

    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    from neurons_tpu_torch.pipelines.validate import preset_options

    pcfg = config.PipelineConfig()
    s = pcfg.sampler
    with torch.device("meta"):
        models = (None, UNetModel(pcfg.unet2d, device="meta"), None, None,
                  UNet3DModel(pcfg.unet3d, n_frames=16, device="meta"),
                  SparseControlNetModel(pcfg.unet3d, n_frames=16,
                                        device="meta"))
    opts = [preset_options(spec, s.unclip_steps, s.video_steps)
            for spec in config.FAST_PRESETS.values()]
    runs = ([({}, {}, "3"), ({}, {}, "5")]
            + [(o3, {}, "3") for o3 in {tuple(sorted(o.items())): o
                                       for o, _ in opts}.values()]
            + [({}, o5, "5") for o5 in {tuple(sorted(o.items())): o
                                       for _, o in opts}.values()])
    total = {"flash_attn_fwd": collections.Counter(),
             "temporal_attn_fwd": collections.Counter()}
    for o3, o5, stage in runs:
        got = sampler_launches(models, pcfg, o3, o5, latents=(64, 32),
                               dtype="float32", stages=stage)
        for k in total:
            total[k].update(got[k])
    return {k: dict(v) for k, v in total.items()}


def validate_on(weights: Path):
    """`cli validate` on the reference-layout weight files in `weights`
    (the unclip6 checkpoint; the AnimateDiff bundle with its LoRA and
    SparseCtrl): the real-weight branch of both stages at full width, f32.
    Gates: both stages report "real" weights, every preset and stage has a
    finite rms_rel and corr, corr in [-1, 1], fast != exact; the launches
    equal `validate_launches`. Prints the seconds of each sampler run and
    of each preset. Returns its {kernel: launches by shape}."""
    import math

    import torch
    from neurons_tpu_torch import cli

    with configuration(False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches, _, wall = run_cli(
            ["validate", "--weights_dir", str(weights), "--seed", str(SEED)],
            "validate (full width, f32)")
    stats = cli._STAGE_STATS["validate"]
    with open(weights / "fastpath_validation.json") as f:
        rep = json.load(f)
    run_s = stats["run_s"]
    for name in sorted(rep["presets"]):
        o3, o5 = (",".join(f"{k}={v}" for k, v in sorted(o.items()))
                  for o in _preset_opts(name))
        log(f"validate preset {name}: stage 3 {run_s['stage3'][o3]:.2f} s "
            f"({o3}), stage 5 {run_s['stage5'][o5]:.2f} s ({o5}; a run "
            f"shared by every preset with these options), scores "
            f"{rep['presets'][name]}")
    log(f"validate: exact stage 3 {run_s['stage3']['exact']:.2f} s, exact "
        f"stage 5 {run_s['stage5']['exact']:.2f} s, setup {stats['setup_s']}"
        f" s, scoring {stats['s']} s, wall {wall:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; report "
        f"{json.dumps(rep)}")
    bad = []
    if (rep["weights_stage3"], rep["weights_stage5"]) != ("real", "real"):
        bad.append("weights not real")
    for name, scores in rep["presets"].items():
        for stage in ("stage3", "stage5"):
            rms, corr = scores[stage]["rms_rel"], scores[stage]["corr"]
            if not (math.isfinite(rms) and math.isfinite(corr)
                    and -1.0 <= corr <= 1.0 and (rms > 0.0 or corr < 1.0)):
                bad.append(f"{name} {stage} {scores[stage]}")
    log(f"validate gates (real weights, scores finite, corr in [-1, 1], "
        f"fast != exact): {not bad}")
    if bad:
        raise AssertionError(f"validate fails: {bad[:8]}")
    check_counted("validate", launches, validate_launches())
    return launches


def _preset_opts(name: str):
    from neurons_tpu_torch import config
    from neurons_tpu_torch.pipelines.validate import preset_options
    s = config.SamplerConfig()
    return preset_options(config.FAST_PRESETS[name], s.unclip_steps,
                          s.video_steps)


PRECOMPUTE_TRAIN_CLIPS = 3  # train clips of the precompute phase: 18 frames
PRECOMPUTE_BATCH = 16       # the CLI's frames a tower call at full width


def write_precompute_weights(weights: Path, vc, tc, vcfg,
                             device="cuda") -> dict:
    """`open_clip_bigG.pt` (the bigG vision and text towers in open_clip's
    layout, fp16, through `torch_export.open_clip_state_dict`) and
    `sd_vae.pt` (the VAE, f32, LDM keys under `first_stage_model.`), from
    modules with seeded random weights (`synth_params_`) drawn on
    `device`. Returns {file: (bytes, seconds)}."""
    import torch
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.models.clip import CLIPTextTower, CLIPVisionTower
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.utils.synth_init import synth_params_

    weights.mkdir(parents=True, exist_ok=True)
    out = {}

    def tree_of(module, seed):
        tree = tex.jax_tree(synth_params_(module, seed))
        del module
        if device == "cuda":
            torch.cuda.empty_cache()
        return tree

    def saved(name, obj):
        t0 = time.perf_counter()
        torch.save(obj, weights / name)
        out[name] = (os.path.getsize(weights / name),
                     time.perf_counter() - t0)
        log(f"precompute: wrote {name}: {out[name][0] / 1e9:.3f} GB in "
            f"{out[name][1]:.1f} s")

    sd = tex.open_clip_state_dict(
        tree_of(CLIPVisionTower(vc, device=device), SEED + 60), vc.layers,
        tree_of(CLIPTextTower(tc, device=device), SEED + 61), tc.layers)
    saved("open_clip_bigG.pt", tex.to_torch(sd, torch.float16))
    del sd
    vae = tex.ldm_vae_state_dict(
        tree_of(AutoencoderKL(vcfg, device=device), SEED + 62), vcfg)
    saved("sd_vae.pt", tex.to_torch({"first_stage_model." + k: v
                                     for k, v in vae.items()}))
    return out


def precompute_launches(frames_by_split, vc, batch: int, vae_side: int = 28):
    """Flash launches of one full-width `precompute`, counted from the
    code: per split, the vision tower on one probe frame and then on every
    batch of `batch` frames (the tail padded), each layer's attention once
    (f32, d = width / heads, patch tokens + the class token); the VAE
    encoder's mid attention once a call (one head, d = 512, at the latent
    side); the text tower's causal attention never (the plain path)."""
    import collections

    tokens = (vc.image_size // vc.patch_size) ** 2 + 1
    d = vc.width // vc.heads
    t = vae_side * vae_side
    flash = collections.Counter()
    for frames in frames_by_split:
        for b, n in ((1, 1), (batch, -(-frames // batch))):
            flash[(b, vc.heads, tokens, tokens, d, "float32", "")] += (
                n * vc.layers)
            flash[(b, 1, t, t, 512, "float32", "")] += n
    return {"flash_attn_fwd": dict(flash), "temporal_attn_fwd": {}}


def precompute_phase():
    """`cli precompute` at full width on the card. A CC2017 root of 2 test
    and 3 train clips (`write_cc2017_root`) and seeded `open_clip_bigG.pt`
    and `sd_vae.pt` (`write_precompute_weights`), then the command: the
    bigG vision tower (f32, 48 layers, 257 tokens at d = 104) and the VAE
    encoder on every frame, in batches of 16, and the bigG text tower on
    the 51 class names. Gates: the tables' shapes and dtypes
    ([N,6,256,1664] fp16, [N,6,4,28,28] fp16, [51,1280] f32) and finite
    values; one frame's vision tokens and latents within 2e-2 * max of the
    same towers on the CPU; the launches equal `precompute_launches`.
    Prints each table's seconds a 1000 frames, the setup seconds, the peak
    device memory and the bytes written. Files live in a git-ignored
    directory of the checkout, removed after. Returns ({path: {kernel:
    launches by shape}}, {path: 16-frame vision batches})."""
    import functools

    import numpy as np
    import torch
    from neurons_tpu_torch import cli
    from neurons_tpu_torch.config import VAEConfig
    from neurons_tpu_torch.data import clip_tokenizer
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.interop import torch_import as TI
    from neurons_tpu_torch.interop.from_jax import load_jax_params
    from neurons_tpu_torch.models.clip import (CLIPTextConfig,
                                               CLIPVisionConfig,
                                               CLIPVisionTower,
                                               preprocess_images)
    from neurons_tpu_torch.models.vae import AutoencoderKL

    vc, tc, vcfg = CLIPVisionConfig.bigG(), CLIPTextConfig.bigG(), VAEConfig()
    n = {"train": PRECOMPUTE_TRAIN_CLIPS, "test": CLI_CLIPS}
    with ckpt_tmpdir("precompute: dataset, open_clip_bigG.pt, sd_vae.pt, "
                     "tables") as d:
        d = Path(d)
        root, weights = d / "cc2017", d / "weights"
        merges = write_cc2017_root(root, n["test"],
                                   np.random.default_rng(SEED + 1),
                                   n_train=n["train"])
        files = write_precompute_weights(weights, vc, tc, vcfg)
        old_bpe = os.environ.get("CLIP_BPE_PATH")
        os.environ["CLIP_BPE_PATH"] = str(merges)
        clip_tokenizer._tokenizer = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with configuration(False):
                launches, _, wall = run_cli(
                    ["precompute", "--root_dir", str(root), "--weights_dir",
                     str(weights), "--seed", str(SEED)],
                    "precompute (full width, f32)")
        finally:
            clip_tokenizer._tokenizer = None
            if old_bpe is None:
                del os.environ["CLIP_BPE_PATH"]
            else:
                os.environ["CLIP_BPE_PATH"] = old_bpe
        peak = torch.cuda.max_memory_allocated()
        stats = cli._STAGE_STATS["precompute"]
        load = cli._LOAD_STATS["open_clip bigG"]
        for name, t in stats["tables"].items():
            per_k = (f"{1e3 * t['s'] / t['frames']:.3f} s a 1000 frames"
                     if t["frames"] else f"{t['s']:.3f} s for 51 names")
            log(f"precompute {name}: {t['frames']} frames in {t['s']:.3f} s "
                f"({per_k}), {t['bytes']} bytes")
        written = sum(t["bytes"] for t in stats["tables"].values())
        log(f"precompute: setup {stats['setup_s']} s (open_clip bigG loaded "
            f"in {load['seconds']} s from {load['bytes'] / 1e9:.3f} GB), "
            f"tables {stats['s']} s, wall {wall:.1f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB, {written} bytes of tables written; "
            f"weight files {files}")

        checks = {}
        tab = {}
        for tag, m in n.items():
            ct = np.load(root / f"clip_targets_{tag}.npy", mmap_mode="r")
            vl = np.load(root / f"vae_latents_{tag}.npy", mmap_mode="r")
            tab[tag] = (ct, vl)
            checks[f"clip_targets_{tag} [{m},6,256,1664] fp16"] = (
                ct.shape == (m, 6, 256, 1664) and ct.dtype == np.float16
                and bool(np.isfinite(ct).all()))
            checks[f"vae_latents_{tag} [{m},6,4,28,28] fp16"] = (
                vl.shape == (m, 6, 4, 28, 28) and vl.dtype == np.float16
                and bool(np.isfinite(vl).all()))
        cls = np.load(root / "class_text_embeds.npy")
        checks["class_text_embeds [51,1280] f32"] = (
            cls.shape == (51, 1280) and cls.dtype == np.float32
            and bool(np.isfinite(cls).all()))

        # one frame through the same towers on the CPU
        t0 = time.perf_counter()
        frame = torch.load(root / "GT_train_3fps.pt")[0, :1].float()
        vision = LW.materialize(functools.partial(CLIPVisionTower, vc),
                                "cpu", torch.float32)
        TI.load_torch_checkpoint(vision, TI.import_open_clip_vision,
                                 LW._torch_load(str(weights /
                                                    "open_clip_bigG.pt")),
                                 vc.layers)
        vae = LW.materialize(functools.partial(AutoencoderKL, vcfg), "cpu",
                             torch.float32)
        load_jax_params(vae, LW.load_sd_vae(str(weights / "sd_vae.pt"),
                                            vcfg)[0])
        with torch.inference_mode():
            want = {"vision tokens": vision(preprocess_images(
                        frame, vc.image_size))[1][0].numpy(),
                    "latents": (vae.encode(frame * 2 - 1).mode()[0]
                                * 0.18215).numpy()}
        del vision, vae
        got = {"vision tokens": np.asarray(tab["train"][0][0, 0], np.float32),
               "latents": np.asarray(tab["train"][1][0, 0], np.float32)}
        for name in want:
            err = float(np.abs(got[name] - want[name]).max())
            scale = float(np.abs(want[name]).max())
            checks[f"{name} of one frame within 2e-2 * max of the CPU's"] = (
                err <= 2e-2 * scale)
            log(f"precompute {name} of train frame 0, card table vs CPU "
                f"tower (f32): max |diff| {err:.3e} of max {scale:.3e} "
                f"(gate {2e-2 * scale:.3e})")
        log(f"precompute: the CPU check took {time.perf_counter() - t0:.1f} "
            f"s")

        log(f"precompute checks: {checks}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"precompute fails {failed}")
        check_counted("precompute", launches, precompute_launches(
            [m * 6 for m in n.values()], vc, PRECOMPUTE_BATCH))
    batches = sum(-(-m * 6 // PRECOMPUTE_BATCH) for m in n.values())
    return {"cli precompute": launches}, {"cli precompute": batches}


# ---------------------------------------------------- the sgm engine, SVD ----

ENGINE_STEPS = 4        # do_sample's steps a sampler, 768 px
ENGINE_IMG2IMG = (8, 0.5)  # do_img2img's steps and strength: 3 UNet steps
SVD_FRAMES = 14         # svd_img2vid's defaults: 14 frames of 576 x 1024,
SVD_STEPS = 25          # 25 EulerEDM steps
SVD_HW = (576, 1024)
SVD_DECODE_CHUNK = 7    # the temporal decoder's frames a call: 2 chunks


def op_tflop(fn, flash_launches) -> float:
    """TFLOP of one call of `fn` on the card: torch's FlopCounterMode over
    its ATen ops (convolutions and products) plus 4 b h tq tk d for each
    flash launch in `flash_launches` (the kernel is no ATen op). Run
    outside the counted windows: the call launches its kernels."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    attn = sum(n * 4 * b * h * tq * tk * d for (b, h, tq, tk, d, *_), n
               in flash_launches.items())
    return (fc.get_total_flops() + attn) / 1e12


def sampler_unet_calls(sampler, sigmas) -> int:
    """UNet calls of one sampler run over the host ladder `sigmas`, from the
    samplers' control flow: one a step; Heun's correction adds one where
    sigma_next > 0; DPM++(2S) ancestral's midpoint adds one where
    sigma_down > 1e-10 (at eta 1, sigma_down = sigma_next^2 / sigma)."""
    from neurons_tpu_torch.pipelines.api import Sampler
    s = [float(v) for v in sigmas]
    n = len(s) - 1
    if sampler == Sampler.HEUN_EDM:
        return n + sum(s[i + 1] > 0 for i in range(n))
    if sampler == Sampler.DPMPP2S_ANCESTRAL:
        return n + sum(s[i + 1] ** 2 / s[i] > 1e-10 for i in range(n))
    return n


def engine_launches(unet, pcfg, calls: int, vae_calls: int):
    """Flash launches of the engine phase, counted from the code: each of
    `calls` unCLIP UNet calls on the CFG batch of 2 at 96 x 96 latents
    (`attn_site_launches`: the self- and cross-attentions over the 256
    CLIP tokens of the transformer sites), and the VAE's mid attention once
    a decode or an encode (`vae_calls`, 9216 tokens at d 512)."""
    import collections
    flash, _ = attn_site_launches(unet, 96, 2, len(pcfg.unet2d.channel_mult),
                                  True, ("self", "cross"),
                                  context_tokens=pcfg.brain.clip_seq_dim)
    out = collections.Counter({k: v * calls for k, v in flash.items()})
    out[(1, 1, 96 * 96, 96 * 96, 512, "bfloat16", "")] += vae_calls
    return dict(out)


def check_counted(what, launches, want):
    """Raise unless every kernel's launches by shape ({kernel: {key: n}})
    equal `want`'s, a kernel `want` leaves out launching none (the default,
    unfused configuration runs no #7/#8)."""
    problems = []
    for kernel, got in launches.items():
        exp = want.get(kernel, {})
        problems += [f"{kernel} {k}: {got.get(k, 0)} launched, "
                     f"{exp.get(k, 0)} from the code"
                     for k in sorted(set(got) | set(exp), key=str)
                     if got.get(k, 0) != exp.get(k, 0)]
    log(f"{what}: launches { {k: sum(v.values()) for k, v in launches.items()} }"
        f", equal to the count from the code: {not problems}")
    if problems:
        raise AssertionError(f"{what} launches differ: {problems[:8]}")


def engine_phase(models, pcfg):
    """`models/engine.py:DiffusionEngine` over the clip's full-width unCLIP
    UNet and VAE (bf16, the clip phase's modules): `pipelines/api.py:
    do_sample` at 768 px under each of the six samplers for ENGINE_STEPS
    steps (CFG 5 over random unconditional tokens), then one `do_img2img`
    of the first sample at strength 0.5 (EulerEDM, 8 steps: 3 run). Every
    sample [1, 3, 768, 768] finite in [0, 1], its watermark round trip the
    48 bits; the launches, zeroed just before and read just after, equal
    `engine_launches`. Returns ({"engine": {kernel: launches by shape}},
    {"engine": 1})."""
    import numpy as np
    import torch
    from neurons_tpu_torch.models.engine import DiffusionEngine
    from neurons_tpu_torch.pipelines import api

    _, unet, vae = models[:3]
    eng = DiffusionEngine(pcfg.unet2d, pcfg.vae, pcfg.sampler, unet=unet,
                          vae=vae)
    g = torch.Generator("cuda").manual_seed(SEED + 70)
    shape = (1, pcfg.brain.clip_seq_dim, pcfg.unet2d.context_dim)
    vector = eng.conditioner(1)
    cond = {"crossattn": torch.randn(shape, generator=g, device="cuda"),
            "vector": vector}
    uc = {"crossattn": torch.randn(shape, generator=g, device="cuda"),
          "vector": vector}
    x = torch.zeros((2, pcfg.unet2d.in_channels, 96, 96), device="cuda")
    call_tflop = op_tflop(lambda: eng.network(
        x, torch.full((2,), 500.0, device="cuda"),
        torch.cat([cond["crossattn"], uc["crossattn"]]),
        torch.cat([vector, vector])), engine_launches(unet, pcfg, 1, 0))
    counters = cli_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    calls = vae_calls = 0
    first, checks, times = None, {}, {}
    runs = [(s.name, api.SamplingParams(
        width=768, height=768, steps=ENGINE_STEPS, sampler=s,
        scale=pcfg.sampler.unclip_cfg_scale)) for s in api.Sampler]
    steps, strength = ENGINE_IMG2IMG
    runs.append(("img2img EULER_EDM", api.SamplingParams(
        width=768, height=768, steps=steps, img2img_strength=strength,
        sampler=api.Sampler.EULER_EDM,
        scale=pcfg.sampler.unclip_cfg_scale)))
    for name, p in runs:
        t0 = time.perf_counter()
        if name.startswith("img2img"):  # of the first sample, in [-1, 1]
            out = api.do_img2img(first * 2 - 1, eng, p, cond, uc,
                                 generator=g)
            vae_calls += 1  # the encode
        else:
            out = api.do_sample(eng, p, cond, uc, generator=g)
            first = out if first is None else first
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        n = sampler_unet_calls(p.sampler, api.build_sigmas(p))
        calls += n
        vae_calls += 1
        img = out.float().cpu().numpy()
        marked = api.embed_watermark(img)
        checks[name] = dict(
            shape=tuple(out.shape) == (1, 3, 768, 768),
            finite=bool(np.isfinite(img).all()),
            in_01=bool((img >= 0).all() and (img <= 1).all()),
            watermark=api.decode_watermark(marked[0]) == api.WATERMARK_BITS)
        log(f"engine {name}: {n} UNet calls, {times[name]:.3f} s, "
            f"checks {checks[name]}")
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    log(f"engine: {calls} UNet calls ({call_tflop:.3f} TFLOP a CFG call) "
        f"and {vae_calls} VAE calls in "
        f"{sum(times.values()):.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    failed = [(n, k) for n, c in checks.items() for k, ok in c.items()
              if not ok]
    if failed:
        raise AssertionError(f"engine outputs fail {failed}")
    check_counted("engine", launches, {"flash_attn_fwd": engine_launches(
        unet, pcfg, calls, vae_calls)})
    return {"engine": launches}, {"engine": 1}


def engine_from_checkpoint(weights: Path):
    """`DiffusionEngine.from_checkpoint` on the CLI phase's unclip6 file
    (bf16 on the card; the file's live UNet weights are the negated EMA
    shadows, so the EMA swap shows), then `do_sample` at 768 px (EulerEDM,
    2 steps): load seconds, the UNet's conv_in equal to the file's EMA
    tensor in bf16, the sample finite in [0, 1], the launches equal the
    count from the code. Returns {kernel: launches by shape}."""
    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.models.engine import DiffusionEngine
    from neurons_tpu_torch.pipelines import api

    pcfg = config.PipelineConfig()
    path = str(weights / "unclip6_epoch0_step110000.ckpt")
    t0 = time.perf_counter()
    eng = DiffusionEngine.from_checkpoint(path, pcfg.unet2d, pcfg.vae,
                                          device="cuda",
                                          dtype=torch.bfloat16)
    load_s = time.perf_counter() - t0
    sd = LW._torch_load(path)
    ema = sd["model_ema.diffusion_modelinput_blocks00weight"].to(
        "cuda", torch.bfloat16)
    live = sd["model.diffusion_model.input_blocks.0.0.weight"].to("cuda")
    swapped = (torch.equal(eng.unet.conv_in.weight, ema)
               and torch.equal(eng.unet.conv_in.weight, -live))
    del sd
    g = torch.Generator("cuda").manual_seed(SEED + 71)
    shape = (1, pcfg.brain.clip_seq_dim, pcfg.unet2d.context_dim)
    vector = eng.conditioner(1)
    p = api.SamplingParams(width=768, height=768, steps=2,
                           sampler=api.Sampler.EULER_EDM,
                           scale=pcfg.sampler.unclip_cfg_scale)
    counters = cli_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = api.do_sample(
        eng, p, {"crossattn": torch.randn(shape, generator=g, device="cuda"),
                 "vector": vector},
        {"crossattn": torch.randn(shape, generator=g, device="cuda"),
         "vector": vector}, generator=g)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    ok = (swapped and bool(torch.isfinite(out).all())
          and bool((out >= 0).all() and (out <= 1).all()))
    log(f"engine from_checkpoint: loaded in {load_s:.1f} s "
        f"({eng.import_report['ema_swapped']} EMA tensors swapped, "
        f"{len(eng.import_report['unet_unused'])} unused keys), conv_in "
        f"the EMA tensor: {swapped}; 2-step sample {sample_s:.3f} s; "
        f"finite in [0, 1]: {ok}")
    if not ok:
        raise AssertionError("DiffusionEngine.from_checkpoint fails")
    check_counted("engine from_checkpoint", launches,
                  {"flash_attn_fwd": engine_launches(eng.unet, pcfg, 2, 1)})
    del eng
    torch.cuda.empty_cache()
    return launches


def svd_unet_launches(unet, latent_hw, rows: int, dtype="bfloat16"):
    """Flash launches of one VideoUNet forward at `rows` folded frames over
    latents latent_hw (h, w), counted from its sites: each
    SpatialVideoTransformer's spatial self-attention launches once a block
    where its tokens reach 128; the cross-attention over the one CLIP-H
    token and the temporal attention over the frames launch none (the JAX
    package routes them to XLA)."""
    import collections
    from neurons_tpu_torch.models.video_unet import SpatialVideoTransformer

    n_levels = len(unet.cfg.channel_mult)
    flash = collections.Counter()
    for name, mod in unet.named_children():
        if not isinstance(mod, SpatialVideoTransformer):
            continue
        level = (n_levels - 1 if name.startswith("mid")
                 else int(name.split("_")[1]))
        tokens = (latent_hw[0] >> level) * (latent_hw[1] >> level)
        a = mod.block_0.attn1
        if tokens >= 128:
            flash[(rows, a.heads, tokens, tokens, a.dim_head, dtype,
                   "")] += mod.depth
    return flash


def svd_launches(unet, frames: int, steps: int, latent_hw, chunks,
                 d_vae: int, dtype="bfloat16"):
    """Flash launches of one `svd_img2vid` clip, counted from the code: the
    VideoUNet on the CFG batch of 2 x frames rows at each EulerEDM step,
    the VAE encoder's mid attention once on the conditioning frame, the
    temporal decoder's (a spatial VAEAttnBlock under time_mode
    'conv-only') once a chunk of frames."""
    out = svd_unet_launches(unet, latent_hw, 2 * frames, dtype)
    for k in out:
        out[k] *= steps
    tokens = latent_hw[0] * latent_hw[1]
    for rows in (1, *chunks):
        out[(rows, 1, tokens, tokens, d_vae, dtype, "")] += 1
    return dict(out)


def svd_small_check():
    """A reduced SVD (a 2-level VideoUNet of width 32 and heads of 16, a
    2-level temporal decoder, 4 frames of 16 x 16 latents: flash at 256
    tokens in the UNet and the decoder), f32, `svd_img2vid` over 4 steps
    decoded in chunks of 2 on the card against the CPU, the same weights
    (drawn on the CPU) and draws: latents and video within 2e-2 * max."""
    import torch
    from neurons_tpu_torch.config import (VAEConfig, VideoDecoderConfig,
                                          VideoUNetConfig)
    from neurons_tpu_torch.models.temporal_ae import VideoDecoder
    from neurons_tpu_torch.models.video_unet import VideoUNet
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.pipelines.svd import SVDNoise, svd_img2vid
    from neurons_tpu_torch.utils.synth_init import synth_params_

    ucfg = VideoUNetConfig(model_channels=32, channel_mult=(1, 2),
                           num_res_blocks=1, attention_resolutions=(1, 2),
                           transformer_depth=(1, 1), num_head_channels=16,
                           context_dim=64)
    dcfg = VideoDecoderConfig(vae=VAEConfig(block_out_channels=(32, 64),
                                            layers_per_block=1))
    f = 4
    gen = torch.Generator().manual_seed(SEED + 62)
    noise = SVDNoise(torch.randn((1, 4, 16, 16), generator=gen),
                     torch.randn((f, 4, 16, 16), generator=gen))
    cond = torch.randn((1, 4, 16, 16), generator=gen)
    clip = torch.randn((1, 64), generator=gen)
    outs = {}
    FLASH_FWD_LAUNCHES.reset()
    for dev in ("cuda", "cpu"):
        unet = synth_params_(VideoUNet(ucfg, device=dev).eval(), SEED + 63,
                             host=True)
        dec = synth_params_(VideoDecoder(dcfg, device=dev).eval(), SEED + 64,
                            host=True)
        outs[dev] = svd_img2vid(unet, dec, cond.to(dev),
                                clip.to(dev), num_frames=f, num_steps=4,
                                decode_chunk=2, noise=noise)
    errs = {}
    for k in ("latents", "video"):
        got = getattr(outs["cuda"], k).cpu()
        want = getattr(outs["cpu"], k)
        errs[k] = float((got - want).abs().max() / want.abs().max())
    launched = FLASH_FWD_LAUNCHES.total
    ok = all(e <= 2e-2 for e in errs.values()) and launched > 0
    log(f"svd small check (reduced depth, f32) card vs CPU: rel err "
        f"{errs} (<= 2e-2), {launched} flash launches on the card: {ok}")
    if not ok:
        raise AssertionError("the reduced SVD on the card disagrees with "
                             "the CPU")


def svd_phase(flash_records):
    """SVD image-to-video at full width on the card: `VideoUNetConfig()`
    (1.52 B parameters) and `VideoDecoderConfig()` (time_mode 'conv-only',
    video kernel (3, 3, 3), the default the port copies; the JAX package's
    own SVD tests run (3, 1, 1)) and the SD VAE encoder, bf16.

    1. `svd_small_check`.
    2. Weights: seeded modules (`synth_params_` on the card, every head
       non-zero) written as one fp16 sgm-layout `svd.safetensors`
       (`torch_export.svd_state_dict`) in a git-ignored directory, read
       back through `load_weights.load_svd` into bf16 modules (no key
       unused), the file removed after.
    3. One clip: a seeded CLIP-H embedding [1, 1024] and a 576 x 1024
       conditioning frame, encoded by the VAE encoder (the posterior's
       mean times 0.18215); `pipelines/svd.py:svd_img2vid` with its
       defaults (14 frames, 25 EulerEDM steps, the linear CFG ramp 1.0 ->
       2.5, fps 6, motion bucket 127, cond aug 0.02, sigma_max 700),
       decoded in chunks of SVD_DECODE_CHUNK frames. The launches, zeroed
       before the encode and read after the decode, equal `svd_launches`
       (400 + 1 + 2); every frame finite; setup, sampling and decode
       seconds, each call's op count and rate, and the peak device memory.
       Then one UNet call and one decode chunk under torch.profiler.
    4. Every launched shape no earlier check held, by `flash_phase`'s rule
       (the [28, 5, 9216, 64] launch on a row slice: its plain version
       would need 47 GB of f32 logits), added to `flash_records`; then
       each shape's launches, error and sums of launches x time.
    Returns ({"svd": {kernel: launches by shape}}, {"svd": 1})."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.config import VideoDecoderConfig, VideoUNetConfig
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.interop.from_jax import load_jax_params
    from neurons_tpu_torch.models.temporal_ae import VideoDecoder
    from neurons_tpu_torch.models.vae import Encoder
    from neurons_tpu_torch.models.video_unet import VideoUNet
    from neurons_tpu_torch.pipelines.svd import svd_img2vid
    from neurons_tpu_torch.utils.synth_init import synth_params_

    svd_small_check()
    ucfg, dcfg = VideoUNetConfig(), VideoDecoderConfig()
    vcfg = dcfg.vae

    def encoder(device="cuda", dtype=torch.float32):
        with torch.device(device):
            return Encoder(vcfg).to(dtype)

    builds = {"unet": functools.partial(VideoUNet, ucfg),
              "decoder": functools.partial(VideoDecoder, dcfg),
              "encoder": encoder}
    with ckpt_tmpdir("svd: svd.safetensors") as d:
        path = str(Path(d) / "svd.safetensors")
        t0 = time.perf_counter()
        trees, n_params = {}, {}
        for i, (name, build) in enumerate(builds.items()):
            m = synth_params_(build(device="cuda"), SEED + 60 + i)
            n_params[name] = sum(p.numel() for p in m.parameters())
            trees[name] = tex.jax_tree(m)
            del m
            torch.cuda.empty_cache()
        sd = tex.svd_state_dict(trees["unet"], ucfg, trees["decoder"], dcfg,
                                trees["encoder"])
        del trees
        n_bytes = tex.write_safetensors(path, tex.to_torch(sd, torch.float16))
        del sd
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        up, dp, ep, report = LW.load_svd(path, ucfg, dcfg)
        models = {}
        for name, tree in (("unet", up), ("decoder", dp), ("encoder", ep)):
            models[name] = LW.materialize(builds[name], "cuda",
                                          torch.bfloat16)
            load_jax_params(models[name], tree)
        del up, dp, ep
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    unused = {k: v for k, v in report.items() if k.endswith("_unused") and v}
    log(f"svd: seeded weights ({ {k: round(v / 1e9, 4) for k, v in n_params.items()} } "
        f"B params) written as a {n_bytes / 1e9:.3f} GB fp16 sgm-layout "
        f"svd.safetensors in {write_s:.1f} s, read back through load_svd "
        f"into bf16 modules in {load_s:.1f} s; unused keys {unused}")
    if unused:
        raise AssertionError(f"load_svd left keys unused: {unused}")

    unet, dec, enc = models["unet"], models["decoder"], models["encoder"]
    h, w = SVD_HW
    latent_hw = (h // 8, w // 8)
    g = torch.Generator("cuda").manual_seed(SEED + 61)
    clip_emb = torch.randn((1, ucfg.context_dim), generator=g, device="cuda")
    frame = torch.rand((1, 3, h, w), generator=g, device="cuda") * 2 - 1
    marks = {}

    def decode(z, n):
        if "decode" not in marks:
            torch.cuda.synchronize()
            marks["decode"] = time.perf_counter()
        return dec((z / vcfg.scaling_factor).to(torch.bfloat16), n)

    chunks = [min(SVD_DECODE_CHUNK, SVD_FRAMES - i)
              for i in range(0, SVD_FRAMES, SVD_DECODE_CHUNK)]
    rows, tokens = 2 * SVD_FRAMES, latent_hw[0] * latent_hw[1]
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    calls = {  # one CFG UNet call and one decode chunk, on zeros
        "unet": lambda: unet(
            torch.zeros((rows, ucfg.in_channels, *latent_hw), **bf16),
            torch.zeros((rows,), device="cuda"),
            torch.zeros((rows, 1, ucfg.context_dim), **bf16),
            torch.zeros((rows, ucfg.adm_in_channels), **bf16),
            num_frames=SVD_FRAMES),
        "decoder": lambda: dec(torch.zeros(
            (chunks[0], vcfg.latent_channels, *latent_hw), **bf16),
            chunks[0])}
    unet_tflop = op_tflop(calls["unet"],
                          svd_unet_launches(unet, latent_hw, rows))
    dec_tflop = op_tflop(calls["decoder"], {
        (chunks[0], 1, tokens, tokens, vcfg.block_out_channels[-1]): 1})
    counters = cli_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with torch.inference_mode():
        moments = enc(frame.to(torch.bfloat16)).float()
        cond_latent = moments[:, :vcfg.latent_channels] * vcfg.scaling_factor
        res = svd_img2vid(unet, decode, cond_latent, clip_emb,
                          num_frames=SVD_FRAMES, num_steps=SVD_STEPS,
                          decode_chunk=SVD_DECODE_CHUNK, generator=g)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    sampling_s, decode_s = marks["decode"] - t0, t_end - marks["decode"]
    checks = {
        f"video [1,{SVD_FRAMES},3,{h},{w}]": tuple(res.video.shape) == (
            1, SVD_FRAMES, 3, h, w),
        "every frame finite": bool(torch.isfinite(res.video).all()),
        "latents finite": bool(torch.isfinite(res.latents).all()),
        "frames differ": bool((res.video[0, 1:] - res.video[0, :-1])
                              .abs().amax() > 0),
    }
    log(f"svd: {SVD_FRAMES} frames of {h}x{w}: sampling {sampling_s:.3f} "
        f"s ({SVD_STEPS} steps of {unet_tflop:.2f} TFLOP, with the encode: "
        f"{SVD_STEPS * unet_tflop / sampling_s:.0f} TFLOP/s), decode "
        f"{decode_s:.3f} s ({len(chunks)} chunks of {dec_tflop:.2f} TFLOP "
        f"for {chunks[0]} frames: "
        f"{dec_tflop * SVD_FRAMES / chunks[0] / decode_s:.0f} TFLOP/s), "
        f"peak device memory {peak / 2**30:.2f} GiB, video range "
        f"[{res.video.min().item():.3f}, {res.video.max().item():.3f}]; "
        f"checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"svd outputs fail {checks}")
    want = svd_launches(unet, SVD_FRAMES, SVD_STEPS, latent_hw, chunks,
                        vcfg.block_out_channels[-1])
    log(f"svd: {sum(want.values())} flash launches counted from the code "
        f"({SVD_STEPS} x {sum(svd_unet_launches(unet, latent_hw, 2).values())} "
        f"UNet + 1 encoder + {len(chunks)} decoder chunks)")
    check_counted("svd", launches, {"flash_attn_fwd": want})
    for name, call in calls.items():  # outside the counted run
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                torch.inference_mode():
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
        device_profile(prof, time.perf_counter() - t0,
                       f"svd: one {name} call (unprofiled: sampling "
                       f"{sampling_s / SVD_STEPS:.3f} s a step, decode "
                       f"{decode_s / len(chunks):.3f} s a chunk)",
                       {"flash": FLASH_FWD_SYMBOLS})
    del unet, dec, enc, models, res, moments, cond_latent, frame, calls
    torch.cuda.empty_cache()

    todo = [(f"svd {k[0]}x{k[1]}x{k[2]}", k[:5], torch.bfloat16)
            for k in sorted(launches["flash_attn_fwd"])
            if k not in flash_records]
    flash_records.update(flash_phase(todo))
    for key, n in sorted(launches["flash_attn_fwd"].items()):
        rec = flash_records[key]
        log(f"svd flash {list(key[:5])} x{n}: max_abs_err "
            f"{rec['max_abs_err']:.3e} (plain {rec['plain_err']:.3e}"
            + (f", row 0 of {key[0]}" if rec.get("err_rows", key[0])
               < key[0] else "")
            + f"), sum kernel {n * rec['ms'] / 1e3:.4f} s (device "
            f"{n * rec['device_ms'] / 1e3:.4f}), bound "
            f"{n * rec['bound_ms'] / 1e3:.4f}, plain "
            f"{n * rec['plain_ms'] / 1e3:.4f}, library "
            f"{n * rec['library_ms'] / 1e3:.4f}")
    return {"svd": launches}, {"svd": 1}


# --- the sgm autoencoder trainer, T5 and EMA ------------------------------------

AE_BATCH, AE_HW = 4, 256        # the trainer's batch: 4 seeded images of 256 px
AE_STEPS = {"kl": 6, "vq": 3}   # alternated generator / discriminator steps
T5_TOKENS = 77                  # T5's batch: 2 prompts of 77 ids


class GradRecorder:
    """Stands in for a trainer's Adam: keeps each parameter's gradient at
    `step` and moves nothing, so two runs compare gradients from one
    state."""

    def __init__(self, params):
        self.param_groups = [{"params": list(params)}]
        self.grads = []

    def step(self):
        self.grads = [p.grad.detach().float().cpu().clone()
                      for p in self.param_groups[0]["params"]]


def autoencoder_launches(cfg, batch: int, hw: int):
    """Flash launches of one generator and one discriminator step, counted
    from the code: the VAE's two mid attentions (encoder, decoder), one
    head at d = the last width over (hw / 2^(levels - 1))^2 tokens; a
    generator step runs each as the forward with lse and the backward
    (the two last-layer gradients stop at conv_out), a discriminator step
    as the plain forward (its reconstruction runs under no_grad)."""
    v = cfg.vae
    t = (hw // 2 ** (len(v.block_out_channels) - 1)) ** 2
    if t < 128:  # below 128 tokens the plain path
        return {}, {}
    key = (batch, 1, t, t, v.block_out_channels[-1], "float32")
    return ({"flash_attn_fwd": {key + ("lse",): 2},
             "flash_attn_bwd": {key + ("",): 2}},
            {"flash_attn_fwd": {key + ("",): 2}})


def ae_small_check():
    """A reduced trainer (VAE widths 32, 64 at 64 px: flash at 1024 tokens,
    d 64; LPIPS VGG16; a 3-layer PatchGAN of width 16), f32 (no TF32 but
    the flash kernels' own), one generator
    and one discriminator step on the card against the CPU, the same
    weights (drawn on the CPU), images and posterior noise, with gradient
    recorders in place of Adam: losses and logs within 2e-3 relative, every
    gradient within 2e-2 of its optimizer's largest, the running
    statistics within 2e-2 of max."""
    import torch
    from neurons_tpu_torch.config import VAEConfig
    from neurons_tpu_torch.interop.torch_export import jax_tree
    from neurons_tpu_torch.ops.attention import (FLASH_BWD_LAUNCHES,
                                                 FLASH_FWD_LAUNCHES)
    from neurons_tpu_torch.training import train_autoencoder as tta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tta.AutoencoderTrainConfig(
        vae=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        disc_start=0, disc_ndf=16, learn_logvar=True)
    gen = torch.Generator().manual_seed(SEED + 80)
    x = torch.rand((2, 3, 64, 64), generator=gen) * 2 - 1
    noise = torch.randn((2, 4, 32, 32), generator=gen)
    torch.manual_seed(SEED + 81)
    engines = {"cpu": tta.AutoencodingEngine(cfg)}
    states = {"cpu": engines["cpu"].init("cpu")}
    engines["cuda"] = tta.AutoencodingEngine(
        cfg, lpips_params=jax_tree(engines["cpu"].lpips))
    states["cuda"] = engines["cuda"].init("cuda")
    for name in ("vae", "disc"):
        getattr(states["cuda"], name).load_state_dict(
            getattr(states["cpu"], name).state_dict())
    FLASH_FWD_LAUNCHES.reset()
    FLASH_BWD_LAUNCHES.reset()
    runs = {}
    for dev in ("cuda", "cpu"):
        st, eng = states[dev], engines[dev]
        st.opt_g = GradRecorder(st.gen_params())
        st.opt_d = GradRecorder(st.disc.parameters())
        _, _, glog = eng.make_generator_step()(st, x.to(dev), noise.to(dev))
        _, _, dlog = eng.make_discriminator_step()(st, x.to(dev),
                                                   noise.to(dev))
        runs[dev] = dict(logs={k: float(v) for k, v in {**glog,
                                                         **dlog}.items()},
                         g=st.opt_g.grads, d=st.opt_d.grads,
                         stats=[b.cpu() for b in st.disc.buffers()])
    cpu, card = runs["cpu"], runs["cuda"]
    log_err = max(abs(card["logs"][k] - v) / max(abs(v), 1e-6)
                  for k, v in cpu["logs"].items())
    grad_err, worst = {}, {}
    for which in ("g", "d"):
        scale = max(float(g.abs().max()) for g in cpu[which])
        errs = [float((a - b).abs().max()) / scale
                for a, b in zip(card[which], cpu[which])]
        grad_err[which] = max(errs)
        worst[which] = (errs.index(grad_err[which]),
                        tuple(cpu[which][errs.index(grad_err[which])].shape))
    stats_err = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(card["stats"], cpu["stats"]))
    launched = (FLASH_FWD_LAUNCHES.total, FLASH_BWD_LAUNCHES.total)
    ok = (log_err <= 2e-3 and max(grad_err.values()) <= 2e-2
          and stats_err <= 2e-2 and launched == (4, 2)
          and cpu["logs"]["scalars/d_weight"] > 0)
    log(f"autoencoder small check (reduced width, f32) card vs CPU: losses "
        f"and logs rel err {log_err:.3e} (<= 2e-3; d_weight "
        f"{card['logs']['scalars/d_weight']:.5g} / "
        f"{cpu['logs']['scalars/d_weight']:.5g}), gradients "
        f"{ {k: f'{v:.3e}' for k, v in grad_err.items()} } of max (<= "
        f"2e-2; worst at tensor {worst}), running statistics "
        f"{stats_err:.3e}, flash launches on the "
        f"card (fwd, bwd) {launched} (4, 2): {ok}")
    if not ok:
        raise AssertionError("the reduced autoencoder trainer on the card "
                             "disagrees with the CPU")


def lpips_from_file(d: str):
    """Seeded LPIPS weights written in the `vgg_lpips` layout by the
    exporter and read back through `import_lpips` (no key unused)."""
    import torch
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.training.perceptual import LPIPS, import_lpips

    torch.manual_seed(SEED + 82)
    with torch.device("cuda"):
        tree = tex.jax_tree(LPIPS())
    path = Path(d) / "vgg.pth"
    torch.save(tex.to_torch(tex.lpips_state_dict(tree)), path)
    params, unused = import_lpips(torch.load(path, map_location="cpu"))
    log(f"autoencoder: seeded LPIPS written as {path.name} "
        f"({path.stat().st_size / 1e6:.1f} MB, the vgg_lpips layout), read "
        f"back through import_lpips, unused keys {unused}")
    if unused:
        raise AssertionError(f"import_lpips left keys unused: {unused}")
    return params


def flat(tensors):
    import torch
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def ae_train_run(name, cfg, lpips_params, steps, x):
    """`steps` alternated generator and discriminator steps of the trainer
    at full width from seeded weights (the discriminator read back through
    `import_nlayer_discriminator`), the posterior's noise from a card
    generator: each step's time by CUDA events, its losses, d_weight and
    checks (finite; the VAE moved by a generator step, the discriminator by
    a discriminator step; the running statistics as they were after a
    generator step); the launches, zeroed just before and read just after,
    against `autoencoder_launches`; peak device memory. Returns (engine,
    state, launches by shape, summary)."""
    import math

    import torch
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.interop.from_jax import (load_jax_buffers,
                                                    load_jax_params)
    from neurons_tpu_torch.training import train_autoencoder as tta
    from neurons_tpu_torch.training.perceptual import \
        import_nlayer_discriminator

    torch.manual_seed(SEED + 83)
    eng = tta.AutoencodingEngine(cfg, lpips_params=lpips_params)
    t0 = time.perf_counter()
    st = eng.init("cuda")
    sd = tex.to_torch(tex.nlayer_discriminator_state_dict(
        tex.jax_tree(st.disc), tex.jax_buffer_tree(st.disc),
        cfg.disc_num_layers))
    variables, unused = import_nlayer_discriminator(sd, cfg.disc_num_layers)
    load_jax_params(st.disc, variables["params"])
    load_jax_buffers(st.disc, variables["batch_stats"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if unused:
        raise AssertionError(f"import_nlayer_discriminator: unused {unused}")
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in
                (("vae", st.vae), ("disc", st.disc), ("lpips", eng.lpips))}
    gstep, dstep = eng.make_generator_step(), eng.make_discriminator_step()
    gen = torch.Generator("cuda").manual_seed(SEED + 84)
    counters = cli_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    times, losses, problems = {"g": [], "d": []}, [], []
    for i in range(steps):
        for kind, fn, params in (("g", gstep, st.gen_params()),
                                 ("d", dstep, list(st.disc.parameters()))):
            # the snapshots wait on the host, out of the step's peak memory
            before = flat(params).cpu()
            stats = flat(st.disc.buffers())
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            _, loss, lg = fn(st, x, generator=gen)
            marks[1].record()
            torch.cuda.synchronize()
            times[kind].append(marks[0].elapsed_time(marks[1]))
            vals = {k: float(v) for k, v in lg.items()}
            losses.append((kind, float(loss), vals))
            if not all(math.isfinite(v)
                       for v in [float(loss)] + list(vals.values())):
                problems.append(f"step {i} {kind}: a non-finite loss {vals}")
            if torch.equal(before, flat(params).cpu()):
                problems.append(f"step {i} {kind}: parameters unchanged")
            if kind == "g" and not torch.equal(stats, flat(st.disc.buffers())):
                problems.append(f"step {i} g: the generator pass moved the "
                                f"running statistics")
            del before, stats
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {}
    for per_step in autoencoder_launches(cfg, AE_BATCH, AE_HW):
        for k, shapes in per_step.items():
            for key, n in shapes.items():
                want.setdefault(k, {})[key] = (want.get(k, {}).get(key, 0)
                                               + steps * n)
    summary = dict(
        setup_s=setup_s, n_params=n_params, peak_gib=peak / 2**30,
        g_ms=sum(times["g"][1:]) / (steps - 1),
        d_ms=sum(times["d"][1:]) / (steps - 1), times=times)
    log(f"autoencoder {name}: {steps} generator + {steps} discriminator "
        f"steps at {AE_BATCH} x {AE_HW}^2 px, f32 ({ {k: round(v / 1e6, 3) for k, v in n_params.items()} } "
        f"M params; setup {setup_s:.2f} s): ms a generator step "
        f"{[round(t, 2) for t in times['g']]} (steady {summary['g_ms']:.2f})"
        f", a discriminator step {[round(t, 2) for t in times['d']]} "
        f"(steady {summary['d_ms']:.2f}); peak device memory "
        f"{summary['peak_gib']:.2f} GiB")
    for i in range(0, len(losses), 2):
        (_, gl, gv), (_, dl, dv) = losses[i], losses[i + 1]
        log(f"  step {i // 2}: generator loss {gl:.6g} (rec "
            f"{gv['loss/rec']:.5f}, nll {gv['loss/nll']:.5g}, g "
            f"{gv['loss/g']:.5f}, d_weight {gv['scalars/d_weight']:.5g}"
            + "".join(f", {k} {gv[k]:.5g}" for k in ("kl_loss", "loss/vq")
                      if k in gv)
            + f"); discriminator loss {dl:.6f} (logits real "
            f"{dv['logits/real']:.4f}, fake {dv['logits/fake']:.4f})")
    if problems:
        raise AssertionError(f"autoencoder {name}: {problems}")
    check_counted(f"autoencoder {name} ({steps} step pairs)", launches, want)
    return eng, st, launches, summary


@contextlib.contextmanager
def plain_train_attention():
    """The differentiable attention's plain version (autograd through
    `attention_reference`) in place of the flash kernels."""
    from neurons_tpu_torch.ops import attention as attn

    fn = attn.flash_attention
    attn.flash_attention = lambda q, k, v, bias=None, scale=None: \
        attn.attention_reference(q, k, v, bias=bias, scale=scale)
    try:
        yield
    finally:
        attn.flash_attention = fn


def ae_fused_check(eng, st, x, noise):
    """One generator step in the fused-norm configuration (every
    GroupNormSiLU of the VAE through #7; no #8, the VAE has no GN -> conv
    pair) against the unfused step, both against the same step in f32
    without TF32 and with the plain attention: the fused gradients' error
    within 1.5x the unfused one's (the fused forwards' rule), taken as the
    norm of the error over the norm of the reference's 83.7 M gradients
    (the max error of one element is logged too: both runs' TF32
    convolutions, whose wgrad sums in no fixed order, set it, so it
    differs between two unfused runs); #7 launched once a GroupNormSiLU
    (the backward is the plain version's VJP). Gradient recorders stand in
    for Adam. Returns #7's launches by shape."""
    import torch

    st.opt_g = GradRecorder(st.gen_params())
    step = eng.make_generator_step()
    runs = {}
    for name in ("reference", "unfused", "fused"):
        tf32 = name != "reference"
        torch.backends.cudnn.allow_tf32 = tf32
        ctx = (plain_train_attention() if name == "reference"
               else contextlib.nullcontext())
        counters = gn_counters()
        for c in counters.values():
            c.reset()
        with configuration(name == "fused"), ctx:
            _, loss, lg = step(st, x, noise)
        torch.cuda.synchronize()
        runs[name] = (flat(st.opt_g.grads), float(loss),
                      float(lg["scalars/d_weight"]),
                      dict(counters["gn_silu"].by_shape),
                      counters["gn_silu_conv"].total)
    torch.backends.cudnn.allow_tf32 = True
    ref = runs["reference"][0].double()
    err, err_max = {}, {}
    for n in ("unfused", "fused"):
        diff = runs[n][0].double() - ref
        err[n] = float(diff.norm() / ref.norm())
        err_max[n] = float(diff.abs().max() / ref.abs().max())
    launches = runs["fused"][3]
    want = gn_sites(st.vae)
    ok = (err["fused"] <= 1.5 * err["unfused"]
          and sum(launches.values()) == want and not runs["unfused"][3]
          and not runs["fused"][4])  # the VAE has no GN -> conv pair
    log(f"autoencoder fused generator step (#7): gradients' error norm / "
        f"norm of the f32 reference fused {err['fused']:.3e}, unfused "
        f"{err['unfused']:.3e} (fused <= 1.5x unfused; max error / max "
        f"fused {err_max['fused']:.3e}, unfused {err_max['unfused']:.3e}); "
        f"loss "
        + ", ".join(f"{n} {r[1]:.6g}" for n, r in runs.items())
        + "; d_weight " + ", ".join(f"{n} {r[2]:.6g}"
                                    for n, r in runs.items())
        + f"; #7 launches {sum(launches.values())} (one a GroupNormSiLU: "
        f"{want}): {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the fused generator step fails its checks: "
                             f"{err}, {launches}")
    return launches


def t5_phase():
    """T5: a reduced encoder (2 blocks of width 256 over 150 ids) on the
    card against the CPU, the same weights drawn on the CPU (2e-2 * max);
    `T5Encoder(t5_v1_1_xxl())` (4.76 B parameters, f32, about 19 GB) built
    on the card from a seeded generator, 2 prompts of 77 ids: s a batch,
    peak memory, freed after; `byt5_base` on `byt5_tokenize` ids, its
    importer round trip in memory (the exporter's HF T5EncoderModel keys
    read back through `import_t5_encoder`, equal outputs)."""
    import copy

    import torch
    from neurons_tpu_torch.interop import torch_export as tex
    from neurons_tpu_torch.interop.from_jax import load_jax_params
    from neurons_tpu_torch.models import t5 as T5

    small = T5.T5Config(vocab_size=384, d_model=256, d_kv=64, d_ff=512,
                        num_layers=2, num_heads=4)
    torch.manual_seed(SEED + 90)
    cpu = T5.T5Encoder(small, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    ids = torch.randint(0, 384, (2, 150),
                        generator=torch.Generator().manual_seed(SEED + 91))
    with torch.inference_mode():
        want = cpu(ids)
        err = float((card(ids.cuda()).cpu() - want).abs().max()
                    / want.abs().max())
    log(f"t5 small check (reduced, f32) card vs CPU: rel err {err:.3e} "
        f"(<= 2e-2)")
    if not err <= 2e-2:
        raise AssertionError("the reduced T5 on the card disagrees with the "
                             "CPU")
    del cpu, card
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(SEED + 92)
    t0 = time.perf_counter()
    xxl = T5.T5Encoder(T5.t5_v1_1_xxl(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(p.numel() for p in xxl.parameters())
    ids = torch.randint(0, xxl.cfg.vocab_size, (2, T5_TOKENS), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.inference_mode():
        out = xxl(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = xxl(ids)
        torch.cuda.synchronize()
        s_batch = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    ok = bool(torch.isfinite(out).all()) and tuple(out.shape) == (
        2, T5_TOKENS, xxl.cfg.d_model)
    log(f"t5: t5_v1_1_xxl {n / 1e9:.3f} B params f32 built on the card in "
        f"{build_s:.2f} s; 2 x {T5_TOKENS} ids: {s_batch:.4f} s a batch, "
        f"peak device memory {peak / 2**30:.2f} GiB, output "
        f"{list(out.shape)} finite: {ok}")
    del xxl, out
    torch.cuda.empty_cache()
    cfg = T5.byt5_base()
    torch.manual_seed(SEED + 93)
    byt5 = T5.T5Encoder(cfg, device="cuda")
    sd = tex.to_torch(tex.t5_encoder_state_dict(tex.jax_tree(byt5), cfg))
    params, unused = T5.import_t5_encoder(sd, cfg)
    del sd
    fresh = T5.T5Encoder(cfg, device="cuda")
    load_jax_params(fresh, params)
    del params
    ids = torch.from_numpy(T5.byt5_tokenize(
        ["a photo of a cat", "naïve façade — 漢字"], T5_TOKENS)).cuda()
    with torch.inference_mode():
        a, b = byt5(ids), fresh(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        byt5(ids)
        torch.cuda.synchronize()
        byt5_s = time.perf_counter() - t0
    same = torch.equal(a, b)
    log(f"t5: byt5_base {sum(p.numel() for p in byt5.parameters()) / 1e9:.3f}"
        f" B params on byt5_tokenize ids [2, {T5_TOKENS}]: {byt5_s:.4f} s a "
        f"batch; its importer round trip (HF keys -> import_t5_encoder) "
        f"unused {unused}, outputs equal: {same}")
    del byt5, fresh, a, b
    torch.cuda.empty_cache()
    if not (ok and same and not unused):
        raise AssertionError("t5 fails its checks")
    return dict(s_batch=s_batch, peak_gib=peak / 2**30, byt5_s=byt5_s)


def autoencoder_phase():
    """The sgm autoencoder trainer at full width on the card, then T5.

    1. `ae_small_check`.
    2. `AutoencoderTrainConfig(disc_start=0)`: `VAEConfig()` (83.7 M
       params), LPIPS VGG16 (seeded, through `lpips_from_file`), the
       3-layer PatchGAN of width 64 (through its importer), f32 with
       PyTorch's defaults (TF32 convolutions, f32 products), batch 4 of
       seeded 256 px images, the GAN term and d_weight live from step 0:
       `ae_train_run` for the KL regularizer (6 step pairs), one EMA update
       over the VAE's parameters (its ms), one profiled step pair (busy
       time, idle share), `ae_fused_check`; then the VQ regularizer (8192
       codes, 3 step pairs).
    3. `t5_phase`.
    Returns ({"autoencoder step": {kernel: launches by shape}},
    {"autoencoder step": step pairs}, #7's launches by shape in the fused
    step)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.training import train_autoencoder as tta
    from neurons_tpu_torch.utils import ema

    ae_small_check()
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's defaults, as a
    torch.backends.cuda.matmul.allow_tf32 = False  # user runs the trainer
    with ckpt_tmpdir("autoencoder: vgg.pth") as d:
        lpips_params = lpips_from_file(d)
    gen = torch.Generator("cuda").manual_seed(SEED + 85)
    x = torch.rand((AE_BATCH, 3, AE_HW, AE_HW), generator=gen,
                   device="cuda") * 2 - 1
    by_shape = {k: collections.Counter() for k in cli_counters()}
    pairs = 0
    for reg in ("kl", "vq"):
        cfg = tta.AutoencoderTrainConfig(disc_start=0, regularizer=reg)
        eng, st, launches, summary = ae_train_run(
            reg, cfg, lpips_params, AE_STEPS[reg], x)
        pairs += AE_STEPS[reg]
        for k, v in launches.items():
            by_shape[k].update(v)
        if reg != "kl":
            del eng, st
            torch.cuda.empty_cache()
            continue
        ema_state = ema.init(dict(st.vae.named_parameters()))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.make_generator_step()(st, x, generator=gen)
            eng.make_discriminator_step()(st, x, generator=gen)
            torch.cuda.synchronize()
        device_profile(prof, time.perf_counter() - t0,
                       f"autoencoder step pair (kl; unprofiled steady: "
                       f"generator {summary['g_ms']:.2f} ms, discriminator "
                       f"{summary['d_ms']:.2f} ms)",
                       {"flash forward": FLASH_FWD_SYMBOLS,
                        **FLASH_BWD_SYMBOLS})
        before = flat(ema_state.shadow.values())
        params = dict(st.vae.named_parameters())
        ema_ms = cuda_ms(lambda: ema.update(ema_state, params), 10)
        moved = not torch.equal(before, flat(ema_state.shadow.values()))
        log(f"autoencoder: ema.update over the VAE's "
            f"{len(params)} tensors ({summary['n_params']['vae'] / 1e6:.3f} "
            f"M params): {ema_ms:.4f} ms a call; the shadow moved: {moved}")
        if not moved:
            raise AssertionError("ema.update left the shadow unchanged")
        del before, ema_state, params
        noise = torch.randn((AE_BATCH, 4, AE_HW // 8, AE_HW // 8),
                            generator=gen, device="cuda")
        fused = ae_fused_check(eng, st, x, noise)
        del eng, st
        torch.cuda.empty_cache()
    t5 = t5_phase()
    log(f"autoencoder phase: {pairs} step pairs counted; t5 {t5}")
    return ({"autoencoder step": {k: dict(v) for k, v in by_shape.items()}},
            {"autoencoder step": pairs}, fused)


def cli_kernel_checks(by_path, flash_records, temporal_records,
                      train_records):
    """Every shape the CLI runs launched that the kernel phases did not
    check, held to the same rule now (the flash forward, the forward with
    lse, the backward and the temporal kernel): the records gain them."""
    import torch
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    flash, temporal, train = [], [], {}
    for path, launches in by_path.items():
        for key in launches["flash_attn_fwd"]:
            b, h, tq, tk, d, dt, variant = key
            if variant == "" and key not in flash_records:
                flash.append((f"{path} {b}x{tq}", (b, h, tq, tk, d),
                              dts[dt]))
            elif variant and key not in train_records[0]:
                train[key[:6] + ("bias" in variant,)] = path
        for key in launches["flash_attn_bwd"]:
            b, h, tq, tk, d, dt, variant = key
            if key not in train_records[1]:
                train[key[:6] + (variant == "bias",)] = path
        for key in launches["temporal_attn_fwd"]:
            if key not in temporal_records:
                bf, d, c, f, h, dt = key
                temporal.append((f"{path} {bf}x{d}", (bf, d, c, f, h),
                                 dts[dt]))
    # the port's training sites: a bias is the prior's per-head bias over
    # multi-query k/v (one kv head); without one, kv heads = heads
    train_checks = [(f"{path} {b}x{tq}", (b, h, tq, tk, d, 1 if bias else h),
                     (h, tq, tk) if bias else None, dts[dt])
                    for (b, h, tq, tk, d, dt, bias), path
                    in sorted(train.items(), key=str)]
    log(f"cli kernel checks: {len(flash)} flash, {len(temporal)} temporal, "
        f"{len(train_checks)} training shapes the kernel phases had not "
        f"checked")
    if flash:
        flash_records.update(flash_phase(flash))
    if temporal:
        temporal_records.update(temporal_phase(temporal))
    if train_checks:
        fwd, bwd = train_kernel_phase(train_checks)
        train_records[0].update(fwd)
        train_records[1].update(bwd)


def kernels_record(flash_records, temporal_records, train_records, by_shape,
                   train_by_shape, gn_records, fused_by_shapes, f32_checks,
                   ptxas, runs, fast_by_shape, stage46_by_path,
                   cli_by_path):
    """The kernels JSON: one entry per (kernel, shape) of the main paths
    (the unfused clip's, then stage 2's, then the fast clip's, the "max"
    preset, then stage 4's caption batch and stage 6's scored clip; for #7
    and #8 the fused clip's, then the fused step's, then the fused
    autoencoder step's, f32); per
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
    for path, kernels in cli_by_path.items():
        for key, launches in sorted(kernels["flash_attn_fwd"].items()):
            b, h, tq, tk, d, dt, variant = key
            rec = fwd_records.get(key)
            if rec is None:
                raise AssertionError(f"the {path} launched the flash kernel "
                                     f"at {key}, a shape no check held")
            entries.append({
                "name": (f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} "
                         + ("bf16" if dt == "bfloat16" else "f32")
                         + (f" {variant}" if variant else "") + f" {path}]"),
                "route": "cuda",
                "source": "neurons_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": ("neurons_tpu/ops/attention.py:185"
                             if "bias" in variant else
                             "neurons_tpu/ops/attention.py:137"
                             if tk * 2 <= 4608 else
                             "neurons_tpu/ops/attention.py:226"),
                "launches": launches,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                **({"device_ms": rec["device_ms"]} if "device_ms" in rec
                   else {}),
            })
            groups.append(("flash_attn_fwd", path, runs[path]))
        for key, launches in sorted(kernels["flash_attn_bwd"].items()):
            b, h, tq, tk, d, dt, variant = key
            rec = train_records[1].get(key)
            if rec is None:
                raise AssertionError(f"the {path} launched the flash "
                                     f"backward at {key}, a shape no check "
                                     f"held")
            entries.append({
                "name": (f"flash_attn_bwd[{b}x{h}x{tq}x{tk}x{d} "
                         + ("bf16" if dt == "bfloat16" else "f32")
                         + (f" {variant}" if variant else "") + f" {path}]"),
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
            groups.append(("flash_attn_bwd", path, runs[path]))
        for key, launches in sorted(kernels["temporal_attn_fwd"].items()):
            bf, d, c, f, h, dt = key
            rec = temporal_records.get(key)
            if rec is None:
                raise AssertionError(f"the {path} launched the temporal "
                                     f"kernel at {key}, a shape no check "
                                     f"held")
            entries.append({
                "name": (f"temporal_attn_fwd[{bf}x{d}x{c} F{f} H{h} "
                         + ("bf16" if dt == "bfloat16" else "f32")
                         + f" {path}]"),
                "route": "cuda",
                "source": "neurons_tpu_torch/csrc/temporal_attn_fwd.cu",
                "replaces": "neurons_tpu/ops/temporal_attention.py:91",
                "launches": launches,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "device_ms": rec["device_ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
            })
            groups.append(("temporal_attn_fwd", path, runs[path]))
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
                # bf16 in the clip and the step, f32 in the autoencoder's
                if rec is None or (key[-1] != "bfloat16"
                                   and path != "autoencoder step"):
                    raise AssertionError(f"the fused {path} launched {kernel} "
                                         f"at {key}, a shape the kernel "
                                         f"phase did not check")
                if kernel == "gn_silu":
                    shape = "x".join(map(str, key[:-2]))
                else:
                    shape = "x".join(map(str, key[:4])) + f"->{key[4]}"
                dt = "bf16" if key[-1] == "bfloat16" else "f32"
                entries.append({
                    "name": f"{kernel}[{shape} G{key[-2]} {dt} {path}]",
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
    """The f32 flash checks at two of the clip's shapes (F32_CHECKS: the
    UNet's cross-attention on the TF32 register kernel, the VAE's d = 512
    on the first design), which no main path launches in f32, recorded
    with their bound and library time. The f32 route's main-path launches
    (stage 6, stage e, the seg panels) are entries of the kernels list and
    of `f32_route_totals`."""
    return [dict(name=f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} float32]",
                 site=rec["site"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                 bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                 library_ms=rec["library_ms"], max_abs_err=rec["max_abs_err"])
            for (b, h, tq, tk, d, dt, _), rec in sorted(flash_records.items())
            if dt == "float32" and rec["site"] in F32_CHECKS]


def f32_route_totals(fwd_records, paths):
    """The flash forward's f32 route (the TF32 register kernel at d <= 128)
    over its paths, for one unit of each: `paths` is [(path, {shape key:
    launches}, units the launches span)]. Per path: launches and the sums
    of launches x time of the kernel (by events and by device time), of its
    bound, of its plain version and of the library call, in seconds."""
    out = []
    for path, launches, units in paths:
        t = dict(path=path, launches=0.0, kernel_s=0.0, device_s=0.0,
                 bound_s=0.0, plain_s=0.0, library_s=0.0, routes=set())
        for key, n in launches.items():
            rec = fwd_records[key]
            n = n / units
            t["launches"] += n
            for k, ms in (("kernel_s", "ms"), ("device_s", "device_ms"),
                          ("bound_s", "bound_ms"), ("plain_s", "plain_ms"),
                          ("library_s", "library_ms")):
                t[k] += n * rec[ms] / 1e3
            t["routes"].add(rec["route"])
        t["routes"] = sorted(t["routes"])
        out.append(t)
    return out


def tf32_instances(ptxas):
    """The TF32 register kernel's instances in the -Xptxas -v summary, by
    (padded head dim, bias, lse); raises if one spills."""
    import re
    out = []
    for f in ptxas:
        m = re.search(r"flash_fwd_tf32_kernelILi(\d+)ELb([01])ELb([01])E",
                      f["function"])
        if m:
            out.append(dict(dk=int(m.group(1)), bias=m.group(2) == "1",
                            lse=m.group(3) == "1", registers=f["registers"],
                            spill_stores=f.get("spill_stores", 0),
                            spill_loads=f.get("spill_loads", 0)))
    for i in sorted(out, key=lambda i: (i["dk"], i["bias"], i["lse"])):
        log(f"  tf32 instance d {i['dk']} bias {i['bias']} lse {i['lse']}: "
            f"{i['registers']} registers, spill stores {i['spill_stores']} "
            f"B, loads {i['spill_loads']} B")
    if len(out) != 12 or any(i["spill_stores"] or i["spill_loads"]
                             for i in out):
        raise AssertionError(f"the TF32 register kernel's instances: {out}")
    return out


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
    tf32_instances(ptxas)
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
    clip_by_shape, fast_by_config, sample, (serve, engine) = slice_phase()
    with configuration(False):
        stage46_by_path, stage46_runs = stage46_phase(sample)
    del sample
    cli_by_path, cli_runs = cli_phase()
    precompute = precompute_phase()
    with configuration(False):
        svd = svd_phase(flash_records)
        *autoencoder, ae_fused = autoencoder_phase()
    for by_path, path_runs in (serve, engine, precompute, svd, autoencoder):
        cli_by_path.update(by_path)
        cli_runs.update(path_runs)
    with configuration(False):
        train_by_shape, fused_train_by_shape = train_phase()
        stage1_phase()
        stage1_checkpoints()
        chained_tiny_check()
    fused_by_shapes = (("clip", clip_by_shape[True]),
                       ("step", fused_train_by_shape),
                       ("autoencoder step", {"gn_silu": ae_fused,
                                             "gn_silu_conv": {}}))
    gn_records = gn_kernel_phase(
        *({k for _, shapes in fused_by_shapes for k in shapes[kernel]}
          for kernel in ("gn_silu", "gn_silu_conv")))
    cli_kernel_checks(cli_by_path, flash_records, temporal_records,
                      train_records)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    # the clips and steps the counted runs span: 2 requests a
    # configuration, run_stage2's steps, the 4 fixed fused steps
    # (from the backward's launches: the seg panel adds forwards only)
    stage2_steps = (sum(train_by_shape["flash_attn_bwd"].values())
                    / sum(STEP_LAUNCHES["flash_attn_bwd"].values()))
    runs = {"clip": CLIP_REQUESTS, "step": stage2_steps,
            "fast clip": CLIP_REQUESTS, "fused clip": CLIP_REQUESTS,
            "fused step": FIXED_STEPS, "fused autoencoder step": 1,
            **stage46_runs, **cli_runs}
    record = kernels_record(flash_records, temporal_records, train_records,
                            clip_by_shape[False], train_by_shape, gn_records,
                            fused_by_shapes, f32_check_records(flash_records),
                            ptxas, runs, fast_by_config[FAST_PRESET],
                            stage46_by_path, cli_by_path)
    log("kernel totals (a clip or a step; s of launches x time): " + " | ".join(
        f"{t['kernel']} {t['path']} x{t['launches']:g}: kernel "
        f"{t['kernel_s']:.4f}" + (f" (device {t['device_s']:.4f})"
                                  if "device_s" in t else "")
        + f" bound {t['bound_s']:.4f} plain {t['plain_s']:.4f} library "
        f"{t['library_s']:.4f}" + (f" (backward alone {t['library_bwd_s']:.4f})"
                                   if "library_bwd_s" in t else "")
        for t in record["totals"]))
    # the f32 route: a scored clip, the run's one seg panel (one stage-2
    # epoch), the CLI's stage e a clip (its f32 launches but stage 6's), a
    # precompute batch of 16 frames (the bigG vision tower at d = 104) and
    # one validate run (its f32 UNet2D, UNet3D and SparseCtrl)
    cli_fwd = cli_by_path["cli pipeline 35e6"]["flash_attn_fwd"]
    stage6 = scored_clip_launches(CLI_FRAMES)

    def f32_upto_128(path):
        return {k: n for k, n in cli_by_path[path]["flash_attn_fwd"].items()
                if k[5] == "float32" and k[4] <= 128}

    record["f32_route"] = f32_route_totals(
        flash_records,
        [("scored clip", stage46_by_path["scored clip"], runs["scored clip"]),
         ("seg panel", {k: n for k, n in train_by_shape["flash_attn_fwd"]
                        .items() if k[5] == "float32"}, 1),
         ("cli stage e", {k: n for k, n in cli_fwd.items()
                          if k[5] == "float32" and k not in stage6},
          runs["cli pipeline 35e6"]),
         ("precompute batch", f32_upto_128("cli precompute"),
          runs["cli precompute"]),
         ("validate run", f32_upto_128("cli validate"),
          runs["cli validate"])])
    log("f32 route (the flash forward on f32; s of launches x time): "
        + " | ".join(f"{t['path']} x{t['launches']:g} {t['routes']}: kernel "
                     f"{t['kernel_s']:.4f} (device {t['device_s']:.4f}) "
                     f"bound {t['bound_s']:.4f} plain {t['plain_s']:.4f} "
                     f"library {t['library_s']:.4f}"
                     for t in record["f32_route"]))
    if any(t["routes"] != ["flash_fwd_tf32_kernel"]
           for t in record["f32_route"]):
        raise AssertionError("an f32 path launched the flash forward off "
                             "the TF32 register kernel")
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
