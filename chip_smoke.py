#!/usr/bin/env python3
"""Drive the PyTorch port of stages 3 and 5 on one CUDA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order:
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA source of the port (one nvcc per source, started together);
  2. kernel phase: the flash-attention kernel at every attention shape of
     the full-width clip (stage 3 and stage 5), in bf16 (and two shapes in
     f32), against an f32 reference; its error must be no worse than 1.5x
     the plain version's at the kernel's precision (bf16 operands; for
     f32, operands rounded to TF32 as the kernel rounds them). The
     temporal-attention kernel at its four stage-5 shapes in bf16 (and one
     in f32), against the float64 result on the same inputs, by the same
     1.5x rule. Times: kernel, plain version, one PyTorch library call
     (scaled_dot_product_attention, a yardstick the port never calls), and
     the bound max(ops / peak, bytes / 3.35 TB/s);
  3. small check: the tiny stage-3 pipeline (f32, attention sites of 256
     and 1024 tokens, so the flash kernel runs) and the tiny stage-5
     `reconstruct_video` (16x16 latents: flash at 256 tokens, the temporal
     kernel at every level) on the card against the same pipelines on the
     CPU, where every attention is the plain version;
  4. slice phase: the full-width clip (`PipelineConfig()`, `GPT2Config()`,
     `CLIPTextConfig.sd15()`) in bf16 with seeded random weights: stage 3
     (`reconstruct_keyframes(enhance=True)`, the blurry-video decode and
     the 256-px artifact resize) then stage 5 (SD-1.5 text tower, 25-step
     CFG-8.5 DDIM through UNet3D + SparseCtrl over 16 frames of 32x32
     latents, VAE decode) for 2 voxel requests one at a time; the kernels'
     launch counts are zeroed just before and read just after;
  5. profile: one more clip under torch.profiler (device activity only),
     outside the counted run: its wall time and the device's busy time
     (the sum of kernel and copy times) in the same run, the idle share
     they give, each kernel's share of busy time, and the top kernels.
The last two lines are the kernels' JSON record and the device JSON. Any
failure raises and exits non-zero; without CUDA the script exits 2 before
printing anything.
"""

from __future__ import annotations

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
]
F32_CHECKS = ["unet cross 48x48", "vae blurry 64x64"]

# ((B F), D, C) of every temporal-attention launch of the full-width clip:
# 16 frames, 8 heads, the CFG batch of one clip
N_FRAMES, MOTION_HEADS = 16, 8
TEMPORAL_SHAPES = [
    ("motion 32x32", (32, 1024, 320)),
    ("motion 16x16", (32, 256, 640)),
    ("motion 8x8", (32, 64, 1280)),
    ("motion 4x4", (32, 16, 1280)),
]
TEMPORAL_F32_CHECKS = ["motion 32x32"]


def log(msg):
    print(msg, flush=True)


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


def attention_bound(b, h, tq, tk, d, esize, peak_flops):
    ops = 4.0 * b * h * tq * tk * d
    nbytes = esize * (2 * b * h * tq * d + 2 * b * h * tk * d)
    t_ops, t_bytes = ops / peak_flops, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
            f"(plain {plain_err:.3e})  kernel_ms {kernel_ms:.4f} "
            f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
            f"bound_ms {bound_ms:.4f} ({bound_by})  {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees at {name} {tname}: "
                                 f"{err:.3e} > 1.5 x {plain_err:.3e}")
        records[(b, h, tq, tk, d, tname)] = dict(
            site=name, max_abs_err=err, plain_err=plain_err, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by)
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
        warps, smem = ta.temporal_plan(f, hd, dt)
        ok = bool(torch.isfinite(got).all()) and err <= 1.5 * plain_err
        tname = str(dt).split(".")[-1]
        log(f"temporal {name:13s} {tname:8s} [{bf},{d},{c}] F={f} H={h} "
            f"warps {warps} smem {smem} B  max_abs_err {err:.3e} (plain "
            f"{plain_err:.3e})  kernel_ms {kernel_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by})  {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"temporal kernel disagrees at {name} "
                                 f"{tname}: {err:.3e} > 1.5 x "
                                 f"{plain_err:.3e}")
        records[(bf, d, c, f, h, tname)] = dict(
            site=name, max_abs_err=err, plain_err=plain_err, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        del q, k, v, want, got, plain
    torch.cuda.empty_cache()
    return records


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


def small_check():
    """The tiny stage-3 pipeline on the card (kernel at the 256-token UNet
    and 1024-token VAE sites) against the CPU (plain attention), f32, the
    same weights and draws. The card's attention multiplies in TF32
    (relative 2^-11); three CFG-5 Euler steps and the decoder carry that
    into the pixels, hence 2e-2 * max |CPU| on keyframes; the prior
    (no kernel) is held to 1e-3, captions and argmax to equality."""
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
    for dev, models in (("cpu", cpu), ("cuda", gpu)):
        outs[dev] = kf.reconstruct_keyframes(
            *models, voxel, class_text_embeds=classes,
            sampler_cfg=pcfg.sampler, latent_hw=lat, enhance=True,
            caption_len=8, noise=noise,
            device=dev)
    launched = FLASH_FWD_LAUNCHES.total - before
    ref, got = outs["cpu"], outs["cuda"]

    def rel(name):
        a, r = getattr(got, name).cpu(), getattr(ref, name)
        return ((a - r).abs().max() / r.abs().max()).item()

    kf_err, prior_err = rel("keyframes"), rel("prior_tokens")
    same_caps = torch.equal(got.captions.cpu(), ref.captions)
    same_cls = torch.equal(got.cls_logits.argmax(-1).cpu(),
                           ref.cls_logits.argmax(-1))
    log(f"small check: kernel launches {launched}, keyframes rel err "
        f"{kf_err:.3e} (<= 2e-2), prior tokens {prior_err:.3e} (<= 1e-3), "
        f"captions equal {same_caps}, class argmax equal {same_cls}")
    if not (launched > 0 and kf_err <= 2e-2 and prior_err <= 1e-3
            and same_caps and same_cls):
        raise AssertionError("tiny pipeline on the card disagrees with the "
                             "CPU plain version")


def small_video_check():
    """Tiny stage 5 (`reconstruct_video`, 3 DDIM steps, 4 frames of 16x16
    latents) on the card against the CPU, f32, the same weights, inputs
    and init noise: the flash kernel runs at the 256-token level-0
    self-attention and the VAE mid-block, the temporal kernel in every
    motion module. The card's flash attention multiplies in TF32 (relative
    2^-11) and CFG 8.5 multiplies the difference of the two halves' eps by
    8.5 at each of three steps before the decoder, hence 2e-2 * max |CPU|
    on latents and video, as for the stage-3 keyframes; the temporal
    kernel alone is exact f32."""
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
    for dev, (vae, unet3d, cn) in (("cpu", cpu), ("cuda", gpu)):
        outs[dev] = reconstruct_video(
            unet3d, cn, vae, blurry, keyframe, text, uncond,
            num_steps=pcfg.sampler.video_steps, n_frames=f, noise=noise,
            device=dev)
    flash = FLASH_FWD_LAUNCHES.total - flash0
    temporal = TEMPORAL_ATTN_LAUNCHES.total - temporal0
    ref, got = outs["cpu"], outs["cuda"]

    def rel(name):
        a, r = getattr(got, name).cpu(), getattr(ref, name)
        return ((a - r).abs().max() / r.abs().max()).item()

    lat_err, vid_err = rel("latents"), rel("video")
    log(f"small video check: flash launches {flash}, temporal launches "
        f"{temporal}, latents rel err {lat_err:.3e} (<= 2e-2), video rel err "
        f"{vid_err:.3e} (<= 2e-2)")
    if not (flash > 0 and temporal > 0 and lat_err <= 2e-2
            and vid_err <= 2e-2):
        raise AssertionError("tiny stage 5 on the card disagrees with the "
                             "CPU plain version")


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


def clip_request(models, pcfg, classes, g):
    """One full-width clip: stage 3 (`run_stage3`: keyframes in enhance
    mode, the blurry-video decode, the 256-px artifacts) then stage 5
    (`run_stage5`), each ending in a synchronize. Returns (stage-3
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
                         generator=g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vid = e2e.run_stage5(text, unet3d, cn, vae, art, pcfg.sampler,
                         generator=g)
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


def slice_phase(n_requests: int = 2):
    """The full-width clip for `n_requests` requests, one at a time.
    Returns ({kernel: launches by shape}, the request's context, the last
    request's s)."""
    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import GPT2Config
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from neurons_tpu_torch.ops.temporal_attention import \
        TEMPORAL_ATTN_LAUNCHES

    t0 = time.perf_counter()
    pcfg = config.PipelineConfig()
    models = build_models((pcfg, GPT2Config()), "cuda", torch.bfloat16, SEED)
    models += build_video_models(pcfg, CLIPTextConfig.sd15(), "cuda",
                                 torch.bfloat16, SEED)
    dec, unet, vae, text, unet3d, cn = models
    torch.cuda.synchronize()
    n_params = [sum(p.numel() for p in m.parameters()) for m in models]
    log(f"slice: built full-width models ({sum(n_params) / 1e9:.3f} B "
        f"params, bf16, of which stage 5's own {sum(n_params[3:]) / 1e9:.3f}"
        f" B) in {time.perf_counter() - t0:.1f} s")
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
                "temporal_attn_fwd": TEMPORAL_ATTN_LAUNCHES}
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
        log(f"slice request {r}: {s3 + s5:.3f} s per clip (stage 3 "
            f"{s3:.3f} s, stage 5 {s5:.3f} s)  launches {launches}  device "
            f"split (s): {split_s}")
        failed = [k for k, ok in clip_checks(art, vid).items() if not ok]
        if failed:
            raise AssertionError(f"slice outputs fail {failed}")
        per_request.append(s3 + s5)
    by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
    timer.close()
    peak = torch.cuda.max_memory_allocated()
    totals = {k: c.total for k, c in counters.items()}
    per_clip = {k: v / n_requests for k, v in totals.items()}
    log(f"slice: {n_requests} requests, s/clip "
        f"{[round(s, 3) for s in per_request]}, launches {totals} "
        f"({per_clip} per clip), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    for kernel, total in totals.items():
        if total == 0:
            raise AssertionError(f"the main path launched no {kernel}")
    return by_shape, ctx, per_request[-1]


def profile_request(ctx, steady_s: float):
    """One more clip, after the counted run, under torch.profiler with
    device activity only: its wall time and the device's busy time (the
    sum of kernel and copy times on the one stream) come from the same
    run. `steady_s` is the unprofiled steady clip's time, printed beside
    it so the profiler's own cost shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, s3, s5 = clip_request(*ctx)
    wall = s3 + s5

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("profile: the profiler recorded no device time; busy time not "
            "measured")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    shares = []
    for kernel, symbol in (("flash", "flash_fwd_kernel"),
                           ("temporal", "temporal_fwd_kernel")):
        sec = sum(dev_us(e) for e in events if symbol in e.key) / 1e6
        shares.append(f"{kernel} kernel {sec:.3f} s ({sec / busy:.3f} of "
                      f"busy)")
    log(f"profile: clip wall {wall:.3f} s under the profiler (stage 3 "
        f"{s3:.3f} s, stage 5 {s5:.3f} s; unprofiled steady clip "
        f"{steady_s:.3f} s), device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; " + "; ".join(shares))
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(e) / 1e3:10.2f} ms {e.count:6d}x  {e.key[:100]}")


def kernels_record(flash_records, temporal_records, by_shape):
    """The kernels JSON: one entry per (kernel, shape) of the main path."""
    entries = []
    for key, launches in sorted(by_shape["flash_attn_fwd"].items()):
        b, h, tq, tk, d, dt = key
        rec = flash_records.get(key)
        if rec is None or dt != "bfloat16":
            raise AssertionError(f"the main path launched the flash kernel "
                                 f"at {key}, a shape the kernel phase did "
                                 f"not check")
        whole_kv = tk * 2 <= 4608  # the TPU package's whole-KV regime
        entries.append({
            "name": f"flash_attn_fwd[{b}x{h}x{tq}x{tk}x{d} bf16]",
            "route": "cuda",
            "source": "neurons_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": ("neurons_tpu/ops/attention.py:137" if whole_kv
                         else "neurons_tpu/ops/attention.py:226"),
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    for key, launches in sorted(by_shape["temporal_attn_fwd"].items()):
        bf, d, c, f, h, dt = key
        rec = temporal_records.get(key)
        if rec is None or dt != "bfloat16":
            raise AssertionError(f"the main path launched the temporal "
                                 f"kernel at {key}, a shape the kernel "
                                 f"phase did not check")
        entries.append({
            "name": f"temporal_attn_fwd[{bf}x{d}x{c} F{f} H{h} bf16]",
            "route": "cuda",
            "source": "neurons_tpu_torch/csrc/temporal_attn_fwd.cu",
            "replaces": "neurons_tpu/ops/temporal_attention.py:91",
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    return {"kernels": entries}


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
    for name in sources:
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    del libs

    flash_records = flash_phase()
    temporal_records = temporal_phase()
    small_check()
    small_video_check()
    by_shape, ctx, steady_s = slice_phase()
    profile_request(ctx, steady_s)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels_record(flash_records, temporal_records,
                                  by_shape)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
