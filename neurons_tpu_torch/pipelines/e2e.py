"""One clip end to end: stage 3 (voxel -> keyframe, blurry video, caption)
chained into stage 5 (caption + keyframe + blurry video -> 16-frame video).

The port's counterpart of the JAX bench's `stage3` + `stage5` composition
(bench.py:252-331), so that every caller runs the same glue:

  stage 3: `reconstruct_keyframes(enhance=True)` and the blurry-video
           decode, then both resized to the 256-px artifact resolution;
  stage 5: the caption's GPT-2 ids reduced modulo the CLIP vocabulary into
           a zero-padded 77-token row, the text tower on it and on the
           all-zero row (the unconditional prompt), then `reconstruct_video`.

The fast paths pass through as bench.py passes them: one dict of
`unclip_sample` options for stage 3 (`sampler_opts`) and the
`reconstruct_video` keywords for stage 5 (`video_opts`);
`config.fast_options` expands a named preset into both.

The artifact resize is the bench's `jax.image.resize(..., "linear")`,
which antialiases (a triangle filter stretched by the downsampling factor);
`F.interpolate(mode="bilinear", antialias=True)` computes the same taps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import SamplerConfig
from neurons_tpu_torch.pipelines.keyframe import (KeyframeNoise,
                                                  KeyframeOutputs,
                                                  _check_device,
                                                  decode_blurry_video,
                                                  reconstruct_keyframes)
from neurons_tpu_torch.pipelines.video import (VideoPipelineOutputs,
                                               reconstruct_video)


def resize_linear(x: torch.Tensor, hw: int) -> torch.Tensor:
    """[..., H, W] -> [..., hw, hw], as jax.image.resize(..., "linear")."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(hw, hw),
                      mode="bilinear", antialias=True, align_corners=False)
    return y.reshape(*lead, hw, hw)


class ClipNoise(NamedTuple):
    """Explicit draws of a clip: stage 3's and stage 5's init noise
    [B, 4, F, h, w]."""

    keyframe: KeyframeNoise
    video: torch.Tensor


class Stage3Artifacts(NamedTuple):
    outputs: KeyframeOutputs
    keyframe: torch.Tensor       # [B, 3, art, art] in [0, 1]
    blurry_video: torch.Tensor   # [B, F0, 3, art, art] in [0, 1]


class ClipOutputs(NamedTuple):
    stage3: Stage3Artifacts
    latents: torch.Tensor        # [B, 4, F, h, w]
    video: torch.Tensor          # [B, F, 3, art, art] in [0, 1]


@torch.inference_mode()
def run_stage3(decoupler: nn.Module, unet: nn.Module, vae: nn.Module,
               voxel: torch.Tensor, class_text_embeds: torch.Tensor,
               sampler_cfg: SamplerConfig = SamplerConfig(),
               latent_hw: int = 96, artifact_hw: int = 256,
               caption_len: int = 60,
               generator: Optional[torch.Generator] = None,
               noise: Optional[KeyframeNoise] = None,
               sampler_opts: Optional[dict] = None,
               device="cuda") -> Stage3Artifacts:
    """Stage 3 in enhance mode and its artifacts at `artifact_hw` px;
    `sampler_opts` are `unclip_sample`'s fast-path options."""
    out = reconstruct_keyframes(
        decoupler, unet, vae, voxel, class_text_embeds=class_text_embeds,
        sampler_cfg=sampler_cfg, latent_hw=latent_hw, enhance=True,
        caption_len=caption_len, generator=generator, noise=noise,
        sampler_opts=sampler_opts, device=device)
    blurry = decode_blurry_video(vae, out.blurry_latents,
                                 out.motion_embeds.shape[1])
    return Stage3Artifacts(out, resize_linear(out.keyframes, artifact_hw),
                           resize_linear(blurry, artifact_hw))


def caption_tokens(captions: torch.Tensor, context_length: int,
                   vocab_size: int) -> torch.Tensor:
    """GPT-2 caption ids [B, L] -> CLIP token rows [B, context_length]:
    the first ids modulo the CLIP vocabulary, then zeros (the bench's
    stand-in for re-tokenizing the caption text)."""
    b, n = captions.shape
    n = min(n, context_length)
    toks = torch.zeros((b, context_length), dtype=torch.int64,
                       device=captions.device)
    toks[:, :n] = captions[:, :n] % vocab_size
    return toks


@torch.inference_mode()
def run_stage5(text_tower: nn.Module, unet3d: nn.Module,
               controlnet: nn.Module, vae: nn.Module,
               artifacts: Stage3Artifacts,
               sampler_cfg: SamplerConfig = SamplerConfig(),
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               device="cuda", **video_opts) -> VideoPipelineOutputs:
    """Stage 5 on stage 3's artifacts: caption embedding, then the DDIM
    video sampler; `video_opts` are `reconstruct_video`'s fast-path
    keywords (encoder_reuse, tgate_step, tgate_pab, pab, pab_range)."""
    dev = resolve_device(device)
    _check_device(dev, text_tower=text_tower)
    tc = text_tower.cfg
    toks = caption_tokens(artifacts.outputs.captions.to(dev),
                          tc.context_length, tc.vocab_size)
    text = text_tower(toks)[0].float()
    uncond = text_tower(torch.zeros_like(toks))[0].float()
    return reconstruct_video(
        unet3d, controlnet, vae, artifacts.blurry_video, artifacts.keyframe,
        text, uncond, num_steps=sampler_cfg.video_steps,
        guidance_scale=sampler_cfg.video_cfg_scale,
        low_strength=sampler_cfg.low_strength,
        n_frames=sampler_cfg.n_video_frames, generator=generator,
        noise=noise, device=dev, **video_opts)


def reconstruct_clip(decoupler: nn.Module, unet: nn.Module, vae: nn.Module,
                     text_tower: nn.Module, unet3d: nn.Module,
                     controlnet: nn.Module, voxel: torch.Tensor,
                     class_text_embeds: torch.Tensor,
                     sampler_cfg: SamplerConfig = SamplerConfig(),
                     latent_hw: int = 96, artifact_hw: int = 256,
                     caption_len: int = 60,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[ClipNoise] = None,
                     sampler_opts: Optional[dict] = None,
                     video_opts: Optional[dict] = None,
                     device="cuda") -> ClipOutputs:
    """voxel [B, 1, n_voxels] -> the clip: stage 3 then stage 5, the one
    VAE serving both. Draws come from `generator` or from `noise`;
    `sampler_opts` / `video_opts` are the two stages' fast-path options."""
    art = run_stage3(decoupler, unet, vae, voxel, class_text_embeds,
                     sampler_cfg, latent_hw, artifact_hw, caption_len,
                     generator, None if noise is None else noise.keyframe,
                     sampler_opts, device)
    vid = run_stage5(text_tower, unet3d, controlnet, vae, art, sampler_cfg,
                     generator, None if noise is None else noise.video,
                     device, **(video_opts or {}))
    return ClipOutputs(art, vid.latents, vid.video)
