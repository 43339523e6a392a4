"""Stage-5 video reconstruction (the NeuroClips sampler), exact path.

Counterpart of neurons_tpu/pipelines/video.py:

  blurry 6-frame video --cccat--> 16 frames --VAE encode--> init latents
  keyframe --VAE encode--> SparseCtrl condition at frame 0
  DDIM(25) loop: SparseCtrl residuals -> UNet3D eps -> CFG -> DDIM step
  VAE decode in chunks of at most 16 frames -> video [B, F, 3, H, W] in [0, 1]

Reproduced as the JAX package has it: the partial-noise init noises the
blurry latents at `timesteps[:t_start][:1]`, which is timesteps[0]
(t = 961 for 25 steps) for every `low_strength` below about 0.96; the
CFG batch is [uncond, cond]; SparseCtrl sees the VAE-encoded keyframe at
frame 0 only, with the frame-0 mask set to 1. The loop state is f32; the
UNet3D and the controlnet run in their own dtype. The encoder-reuse, TGATE
and PAB fast paths are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.diffusion.ddim import DDIMScheduler
from neurons_tpu_torch.pipelines.keyframe import _check_device, _dtype


def cccat_interpolate(blurry: torch.Tensor,
                      target_frames: int = 16) -> torch.Tensor:
    """6 -> 16 frames: two 2/3-1/3 blends between consecutive frames.
    blurry [B, F0, C, H, W] -> [B, 3 (F0 - 1) + 1, C, H, W], resampled to
    `target_frames` by rounding a linspace when the counts differ."""
    f0 = blurry.shape[1]
    outs = []
    for i in range(f0 - 1):
        a, nxt = blurry[:, i], blurry[:, i + 1]
        outs += [a, a * (2 / 3) + nxt * (1 / 3), a * (1 / 3) + nxt * (2 / 3)]
    outs.append(blurry[:, -1])
    out = torch.stack(outs, dim=1)
    if out.shape[1] != target_frames:
        idx = torch.linspace(0, out.shape[1] - 1, target_frames).round().long()
        out = out[:, idx.to(out.device)]
    return out


class VideoPipelineOutputs(NamedTuple):
    latents: torch.Tensor   # [B, 4, F, h, w]
    video: torch.Tensor     # [B, F, 3, H, W] in [0, 1]


@torch.inference_mode()
def reconstruct_video(
    unet3d: nn.Module, controlnet: nn.Module, vae: nn.Module,
    blurry_video: torch.Tensor,        # [B, F0, 3, H, W] in [0, 1]
    keyframe: torch.Tensor,            # [B, 3, H, W] in [0, 1]
    text_embeddings: torch.Tensor,     # [B, 77, ctx] (conditional)
    uncond_embeddings: torch.Tensor,   # [B, 77, ctx] (empty prompt)
    num_steps: int = 25, guidance_scale: float = 8.5,
    low_strength: float = 0.3, n_frames: int = 16,
    controlnet_scale: float = 1.0, latent_scale: float = 0.18215,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device="cuda",
) -> VideoPipelineOutputs:
    """One batched stage-5 reconstruction. `unet3d` is a UNet3DModel,
    `controlnet` a SparseControlNetModel, `vae` an AutoencoderKL, all on
    `device`. `noise` is the init noise [B, 4, F, h, w]; without it the
    draw comes from `generator`."""
    dev = resolve_device(device)
    _check_device(dev, unet3d=unet3d, controlnet=controlnet, vae=vae)
    udt, cdt, vdt = _dtype(unet3d), _dtype(controlnet), _dtype(vae)
    blurry_video, keyframe = blurry_video.to(dev), keyframe.to(dev)
    b = blurry_video.shape[0]
    sched = DDIMScheduler.create(num_steps, device=dev)

    def encode(x):  # pixels in [0, 1] -> scaled latent means, f32
        z = vae.encode((2.0 * x - 1.0).to(vdt)).mode()
        return z.float() * latent_scale

    # init latents from the interpolated blurry video
    motion = cccat_interpolate(blurry_video, n_frames)
    lat = encode(motion.reshape(b * n_frames, *motion.shape[2:]))
    latents = lat.reshape(b, n_frames, *lat.shape[1:]).transpose(1, 2)
    init_timestep = min(int(num_steps * low_strength), num_steps)
    t_start = max(num_steps - init_timestep, 1)
    latent_timestep = sched.timesteps[:t_start][:1]
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev)
    latents = sched.add_noise(latents, noise.to(dev, torch.float32),
                              latent_timestep.expand(b))

    # SparseCtrl condition: the keyframe's latent at frame 0, mask 1 there
    key_lat = encode(keyframe)
    cond = torch.zeros((b, key_lat.shape[1], n_frames, *key_lat.shape[2:]),
                       device=dev)
    cond[:, :, 0] = key_lat
    mask = torch.zeros((b, 1, n_frames, *key_lat.shape[2:]), device=dev)
    mask[:, :, 0] = 1.0

    # CFG-doubled inputs, uncond first
    text2 = torch.cat([uncond_embeddings, text_embeddings]).to(dev)
    text2_c, text2_u = text2.to(cdt), text2.to(udt)
    cond2 = torch.cat([cond, cond]).to(cdt)
    mask2 = torch.cat([mask, mask]).to(cdt)
    for t in sched.timesteps.tolist():
        x2 = torch.cat([latents, latents])
        t2 = torch.full((2 * b,), float(t), device=dev)
        down, mid = controlnet(x2.to(cdt), t2, text2_c, cond2, mask2,
                               controlnet_scale)
        eps = unet3d(x2.to(udt), t2, text2_u, down, mid).float()
        eps_u, eps_c = eps.chunk(2)
        latents = sched.step(eps_u + guidance_scale * (eps_c - eps_u), t,
                             latents)

    # decode in chunks: the largest divisor of B*F that is at most 16
    lat_f = latents.transpose(1, 2).reshape(b * n_frames,
                                            *latents.shape[1:2],
                                            *latents.shape[3:])
    n_total = lat_f.shape[0]
    chunk = next(c for c in range(min(16, n_total), 0, -1)
                 if n_total % c == 0)
    frames = torch.cat([vae.decode((z / latent_scale).to(vdt)).float()
                        for z in lat_f.split(chunk)])
    frames = torch.clamp(frames / 2 + 0.5, 0.0, 1.0)
    return VideoPipelineOutputs(
        latents=latents, video=frames.reshape(b, n_frames, *frames.shape[1:]))
