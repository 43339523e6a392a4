#!/usr/bin/env python3
"""Drive the PyTorch port of stage 3 on one CUDA card and hold its kernel
against the plain PyTorch version.

    python3 chip_smoke.py

Phases, in order:
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA source of the port (one nvcc per source, started together);
  2. kernel phase: the flash-attention kernel at every attention shape of
     full-width stage 3, in bf16 (and two shapes in f32), against an f32
     reference; its error must be no worse than 1.5x the plain version's
     at the kernel's precision (bf16 operands; for f32, operands rounded
     to TF32 as the kernel rounds them). Times: kernel, plain version, one
     PyTorch library call (scaled_dot_product_attention, a yardstick the
     port never calls), and the bound max(ops / peak, bytes / 3.35 TB/s);
  3. small check: the tiny pipeline (f32, attention sites of 256 and 1024
     tokens, so the kernel runs) on the card against the same pipeline on
     the CPU, where every attention is the plain version;
  4. slice phase: full-width stage 3 (BrainModelConfig(), PriorConfig(),
     DecouplerConfig(), GPT-2, UNet2DConfig(), VAEConfig()) in bf16 with
     seeded random weights, `reconstruct_keyframes(enhance=True)` plus the
     blurry-video decode for 2 voxel requests one at a time, at the
     reference sampler steps; the kernel's launch count is zeroed just
     before and read just after;
  5. profile: one more request under torch.profiler (device activity
     only), outside the counted run: its wall time and the device's busy
     time (the sum of kernel and copy times) in the same run, the idle
     share they give, and the top kernels by device time.
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
HBM_BYTES_PER_S = 3.35e12
SEED = 0

# (B, H, Tq, Tk, D) of every flash-attention launch of full-width stage 3
STAGE3_SHAPES = [
    ("unet self 48x48", (2, 10, 2304, 2304, 64)),
    ("unet cross 48x48", (2, 10, 2304, 256, 64)),
    ("unet self 24x24", (2, 20, 576, 576, 64)),
    ("unet cross 24x24", (2, 20, 576, 256, 64)),
    ("decoder 16x16", (6, 1, 256, 256, 128)),
    ("decoder 32x32", (6, 1, 1024, 1024, 64)),
    ("decoder 64x64", (6, 1, 4096, 4096, 32)),
    ("vae blurry 64x64", (1, 1, 4096, 4096, 512)),
    ("vae keyframe 96x96", (1, 1, 9216, 9216, 512)),
]
F32_CHECKS = ["unet cross 48x48", "vae blurry 64x64"]


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


def kernel_phase():
    """Kernel vs plain version at every stage-3 shape. Returns
    {shape: record}."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    gen = torch.Generator("cuda").manual_seed(SEED)
    records = {}
    checks = [(name, shape, torch.bfloat16) for name, shape in STAGE3_SHAPES]
    checks += [(name, shape, torch.float32) for name, shape in STAGE3_SHAPES
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
        log(f"kernel {name:20s} {tname:8s} [{b},{h},{tq},{tk},{d}] "
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


def build_models(cfgs, device, dtype, seed):
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


def small_check():
    """The tiny pipeline on the card (kernel at the 256-token UNet and
    1024-token VAE sites) against the CPU (plain attention), f32, the
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


def stage3_request(models, pcfg, classes, g):
    """One full-width stage-3 request: `reconstruct_keyframes` in enhance
    mode plus the blurry-video decode, ending in a synchronize. Returns
    (outputs, video, seconds on the host clock)."""
    import torch
    from neurons_tpu_torch.pipelines import keyframe as kf

    dec, unet, vae = models
    voxel = 0.5 * torch.randn((1, 1, pcfg.brain.voxel_counts[0]),
                              generator=g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = kf.reconstruct_keyframes(
        dec, unet, vae, voxel, class_text_embeds=classes,
        sampler_cfg=pcfg.sampler, latent_hw=96, enhance=True,
        caption_len=60, generator=g)
    video = kf.decode_blurry_video(vae, out.blurry_latents,
                                   pcfg.decoupler.n_frames)
    torch.cuda.synchronize()
    return out, video, time.perf_counter() - t0


def slice_phase(n_requests: int = 2):
    """Full-width stage 3 for `n_requests` requests, one at a time. Returns
    (launches by shape, the request's context, the last request's s)."""
    import torch
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.gpt2 import GPT2Config
    from neurons_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES

    t0 = time.perf_counter()
    pcfg = config.PipelineConfig()
    models = build_models((pcfg, GPT2Config()), "cuda", torch.bfloat16, SEED)
    dec, unet, vae = models
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in models for p in m.parameters())
    log(f"slice: built full-width models ({n_params / 1e9:.3f} B params, "
        f"bf16) in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator("cuda").manual_seed(SEED)
    classes = torch.randn((pcfg.decoupler.num_classes,
                           pcfg.decoupler.clip_txt_emb_dim), generator=g,
                          device="cuda")
    ctx = (models, pcfg, classes, g)
    timer = StageTimer({"brain encoder": dec.core, "prior": dec.prior_net,
                        "seg+blurry decoder": dec.text_seg_dec,
                        "caption": dec.text_dec.lm, "unclip unet": unet,
                        "vae decode": vae.decoder})
    torch.cuda.reset_peak_memory_stats()
    FLASH_FWD_LAUNCHES.reset()
    per_request = []
    for r in range(n_requests):
        launched0 = FLASH_FWD_LAUNCHES.total
        out, video, seconds = stage3_request(*ctx)
        split = timer.take()
        launches = FLASH_FWD_LAUNCHES.total - launched0
        checks = {
            "keyframes [1,3,768,768]": out.keyframes.shape == (1, 3, 768, 768),
            "blurry video [1,6,3,512,512]": video.shape == (1, 6, 3, 512, 512),
            "captions [1,60]": out.captions.shape == (1, 60),
            "prior tokens [1,256,1664]": out.prior_tokens.shape == (1, 256,
                                                                    1664),
            "finite": all(bool(torch.isfinite(x).all()) for x in
                          (out.keyframes, video, out.prior_tokens,
                           out.cls_logits, out.seg_masks)),
            "keyframes in [0,1]": bool((out.keyframes >= 0).all()
                                       and (out.keyframes <= 1).all()),
        }
        split_s = " ".join(f"{k}={v:.3f}" for k, v in split.items())
        log(f"slice request {r}: {seconds:.3f} s  kernel launches "
            f"{launches}  device split (s): {split_s}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"slice outputs fail {failed}")
        per_request.append(dict(seconds=seconds, launches=launches,
                                split=split))
    by_shape = dict(FLASH_FWD_LAUNCHES.by_shape)
    total = FLASH_FWD_LAUNCHES.total
    timer.close()
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: {n_requests} requests, s/request "
        f"{[round(p['seconds'], 3) for p in per_request]}, kernel launches "
        f"{total} ({total / n_requests:.0f}/request), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    if total == 0:
        raise AssertionError("the main path launched no flash kernel")
    return by_shape, ctx, per_request[-1]["seconds"]


def profile_request(ctx, steady_s: float):
    """One more request, after the counted run, under torch.profiler with
    device activity only: its wall time and the device's busy time (the
    sum of kernel and copy times on the one stream) come from the same
    run. `steady_s` is the unprofiled steady request's time, printed
    beside it so the profiler's own cost shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall = stage3_request(*ctx)

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
    flash = sum(dev_us(e) for e in events if "flash_fwd_kernel" in e.key) / 1e6
    log(f"profile: request wall {wall:.3f} s under the profiler "
        f"(unprofiled steady request {steady_s:.3f} s), device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}; flash kernel "
        f"{flash:.3f} s ({flash / busy:.3f} of busy)")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:10.2f} ms {e.count:6d}x  {e.key[:100]}")


def kernels_record(records, by_shape):
    """The kernels JSON: one entry per (kernel, shape) of the main path."""
    shown = {(b, h, tq, tk, d): rec for (b, h, tq, tk, d, dt), rec
             in records.items() if dt == "bfloat16"}
    entries = []
    for key, launches in sorted(by_shape.items()):
        b, h, tq, tk, d, dt = key
        rec = shown.get((b, h, tq, tk, d))
        if rec is None or dt != "bfloat16":
            raise AssertionError(f"the main path launched the kernel at {key},"
                                 f" a shape the kernel phase did not check")
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

    records = kernel_phase()
    small_check()
    by_shape, ctx, steady_s = slice_phase()
    profile_request(ctx, steady_s)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels_record(records, by_shape)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
