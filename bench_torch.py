#!/usr/bin/env python3
"""Benchmark of the PyTorch port: end-to-end seconds per clip, stage 3 +
stage 5, the counterpart of bench.py (which times the JAX package).

    python3 bench_torch.py

One clip is the whole generative path at the reference shapes:

  stage 3: voxels [13447] -> brain encoder -> 100-step prior over 256 x 1664
    tokens -> decoupler heads (enhance mode) -> blurry-video decode ->
    60-token GPT-2 caption -> 38-step CFG-5 EulerEDM unCLIP at 4 x 96 x 96
    latents -> 768-px keyframe, both artifacts resized to 256 px
  stage 5: caption -> SD-1.5 CLIP text tower -> 25-step CFG-8.5 DDIM
    through UNet3D + SparseCtrl over 16 frames of 4 x 32 x 32 latents ->
    VAE decode

through `neurons_tpu_torch.pipelines.e2e.run_stage3` and `run_stage5`, with
the models `chip_smoke.py:build_clip` builds (seeded random weights, bf16:
timing does not depend on the weights). It warms up once and times one
clip; BENCH_ITERS=N > 1 times N - 1 more and prints their mean on stderr.

Knobs (bench.py's names and meaning):
  BENCH_TGATE=N          stage-3 TGATE gate step
  BENCH_TGATE_VIDEO=N    stage-5 TGATE gate step
  BENCH_TGATE_PAB=N      PAB inside the gated phase, both stages
  BENCH_PAB=Is,It,Ic     stage-5 PAB intervals; BENCH_PAB_KF=Is,Ix stage 3
  BENCH_PAB_RANGE=lo,hi  the steps PAB broadcasts in, both stages
  BENCH_ENC_REUSE=N      encoder reuse, both stages
  BENCH_DEEPCACHE=N      stage-3 DeepCache
  BENCH_BATCH=N          clips a pass (default 1)
  NEURONS_TPU_FUSED_NORM=1, NEURONS_TPU_FUSED_GNCONV=1
                         the fused-norm kernels (#7, #8), read by the port
It runs on the card; BENCH_TINY=1 BENCH_PLATFORM=cpu (both) runs the
tiny configuration on the CPU, the only way there.

Progress goes to stderr; the last line of stdout is one JSON object,
{"metric": "sec_per_clip_e2e_stage3+5", "value", "unit", "vs_baseline"},
vs_baseline being the 10 s/clip target over the measured time.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

_T0 = time.perf_counter()


def note(msg):
    print(f"[bench_torch +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _ints(name):
    v = os.environ.get(name)
    return tuple(int(x) for x in v.split(",")) if v else None


def fast_knobs():
    """bench.py's fast-path knobs -> (stage 3's `unclip_sample` options,
    stage 5's `reconstruct_video` keywords), as bench.py passes them."""
    enc_reuse = int(os.environ.get("BENCH_ENC_REUSE", "1"))
    tgate_pab = int(os.environ.get("BENCH_TGATE_PAB", "0"))
    pab_range = _ints("BENCH_PAB_RANGE")
    stage3 = dict(tgate_step=int(os.environ.get("BENCH_TGATE", "0")),
                  tgate_pab=tgate_pab, encoder_reuse=enc_reuse,
                  pab=_ints("BENCH_PAB_KF"), pab_range=pab_range,
                  deep_cache=int(os.environ.get("BENCH_DEEPCACHE", "0")))
    stage5 = dict(encoder_reuse=enc_reuse,
                  tgate_step=int(os.environ.get("BENCH_TGATE_VIDEO", "0")),
                  tgate_pab=tgate_pab, pab=_ints("BENCH_PAB"),
                  pab_range=pab_range)
    return stage3, stage5


def build(tiny: bool, device):
    """The clip's models with seeded random weights (bf16 on the card, f32
    on the CPU) and its shapes: (models, pipeline config, keyframe latent
    side, artifact side, caption tokens)."""
    import torch
    from chip_smoke import SEED, build_models, build_video_models
    from neurons_tpu_torch import config
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import GPT2Config, tiny_gpt2_config

    if tiny:
        pcfg = config.tiny_pipeline_config()
        text_cfg = CLIPTextConfig.tiny()
        pcfg = config.replace(
            pcfg, unet2d=config.replace(pcfg.unet2d, adm_in_channels=1024),
            unet3d=config.replace(pcfg.unet3d,
                                  cross_attention_dim=text_cfg.width,
                                  motion_max_seq_length=8))
        gcfg, shapes = tiny_gpt2_config(), (8, 16, 8)
    else:
        pcfg, gcfg, text_cfg = (config.PipelineConfig(), GPT2Config(),
                                CLIPTextConfig.sd15())
        shapes = (96, 256, 60)
    dtype = torch.float32 if tiny else torch.bfloat16
    models = build_models((pcfg, gcfg), device, dtype, SEED)
    models += build_video_models(pcfg, text_cfg, device, dtype, SEED)
    return models, pcfg, shapes


def run_once(models, pcfg, shapes, classes, seed, batch, device):
    """One pass of `batch` clips through stage 3 then stage 5; returns the
    seconds it took, ending when the video's checksum is on the host."""
    import torch
    from neurons_tpu_torch.pipelines import e2e

    dec, unet, vae, text, unet3d, cn = models
    latent_hw, artifact_hw, caption_len = shapes
    s3_opts, s5_opts = fast_knobs()
    g = torch.Generator(device).manual_seed(seed)
    voxel = 0.5 * torch.randn((batch, 1, pcfg.brain.voxel_counts[0]),
                              generator=g, device=device)
    t0 = time.perf_counter()
    art = e2e.run_stage3(dec, unet, vae, voxel, classes, pcfg.sampler,
                         latent_hw=latent_hw, artifact_hw=artifact_hw,
                         caption_len=caption_len, generator=g,
                         sampler_opts=s3_opts, device=device)
    vid = e2e.run_stage5(text, unet3d, cn, vae, art, pcfg.sampler,
                         generator=g, device=device, **s5_opts)
    checksum = float(vid.video.sum())
    if checksum != checksum or abs(checksum) == float("inf"):
        raise AssertionError(f"non-finite video (checksum {checksum})")
    return time.perf_counter() - t0


def result(sec: float) -> str:
    return json.dumps({"metric": "sec_per_clip_e2e_stage3+5",
                       "value": round(sec, 3), "unit": "s/clip",
                       "vs_baseline": round(10.0 / sec, 3)})


def main():
    import torch
    from neurons_tpu_torch import resolve_device

    tiny = os.environ.get("BENCH_TINY") == "1"
    platform = os.environ.get("BENCH_PLATFORM", "cuda")
    if platform == "cpu" and not tiny:
        raise SystemExit("bench_torch: BENCH_PLATFORM=cpu runs only the "
                         "tiny configuration (BENCH_TINY=1)")
    if platform not in ("cpu", "cuda"):
        raise SystemExit(f"bench_torch: BENCH_PLATFORM={platform!r} is "
                         f"neither cuda nor cpu")
    device = resolve_device(platform)
    batch = int(os.environ.get("BENCH_BATCH", "1"))
    n_iters = int(os.environ.get("BENCH_ITERS", "1"))
    switches = {k: os.environ.get(k, "") for k in (
        "NEURONS_TPU_FUSED_NORM", "NEURONS_TPU_FUSED_GNCONV")}
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    note(f"device {device} ({name}), tiny={tiny}, batch {batch}, fast "
         f"options {fast_knobs()}, fused switches {switches}")
    models, pcfg, shapes = build(tiny, device)
    d = pcfg.decoupler
    classes = torch.randn((d.num_classes, d.clip_txt_emb_dim),
                          generator=torch.Generator(device).manual_seed(7),
                          device=device)
    note("built; warm-up pass")
    run_once(models, pcfg, shapes, classes, 0, batch, device)
    sec = run_once(models, pcfg, shapes, classes, 1, batch, device) / batch
    note(f"measured: {sec:.3f} s/clip")
    if n_iters > 1:
        total = sum(run_once(models, pcfg, shapes, classes, i + 2, batch,
                             device) for i in range(n_iters - 1))
        note(f"refined over {n_iters - 1} more passes: "
             f"{result(total / ((n_iters - 1) * batch))}")
    print(result(sec), flush=True)


if __name__ == "__main__":
    main()
