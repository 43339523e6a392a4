"""SVD image-to-video sampling over the port's SVD stack.

Counterpart of neurons_tpu/pipelines/svd.py (the reference's svd.yaml
wiring): a `ContinuousDenoiser` with the v-prediction scalings and the
EDM noise conditioning, the `VideoUNet`, the conditioning (the CLIP-H
image embedding as crossattn; fps id, motion bucket and cond aug through
ConcatTimestepEmbedderND as vector; the cond-aug-noised conditioning-frame
latent concatenated to every frame), the linear per-frame CFG ramp, and
EulerEDM over the EDM ladder; then the temporal decoder, in chunks of
frames where `decode_chunk` asks for them.

The UNet runs in its own parameter dtype (bf16 on the card); the sampler
state and the outputs stay f32. The two draws (the cond-aug noise and the
start noise) are explicit (`SVDNoise`) or come from a generator.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from neurons_tpu_torch.diffusion.denoiser import ContinuousDenoiser
from neurons_tpu_torch.diffusion.samplers import (
    make_linear_prediction_denoiser, sample_euler)
from neurons_tpu_torch.diffusion.schedule import edm_sigmas
from neurons_tpu_torch.models.conditioner import concat_timestep_embedder


def v_scaling_edm_cnoise(sigma: torch.Tensor):
    """VScalingWithEDMcNoise: the v-prediction scalings with the EDM noise
    conditioning c_noise = 0.25 * ln(sigma)."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    c_noise = 0.25 * torch.log(torch.clamp(sigma, min=1e-20))
    return c_skip, c_out, c_in, c_noise


def svd_vector_conditioning(batch: int, fps_id: float,
                            motion_bucket_id: float, cond_aug: float,
                            device="cpu") -> torch.Tensor:
    """The `vector` conditioning: fps id, motion bucket id and cond aug,
    each through ConcatTimestepEmbedderND at outdim 256 -> [B, 768]."""
    vals = torch.tensor([[fps_id, motion_bucket_id, cond_aug]],
                        dtype=torch.float32, device=device).repeat(batch, 1)
    return concat_timestep_embedder(vals, outdim=256)


class SVDResult(NamedTuple):
    video: torch.Tensor    # [B, T, 3, H, W] in [-1, 1]
    latents: torch.Tensor  # [(B T), 4, h, w]


class SVDNoise(NamedTuple):
    """svd_img2vid's draws, standard normal: `aug` [B, 4, h, w] (the
    conditioning frame's cond-aug noise) and `start` [(B T), 4, h, w]."""

    aug: torch.Tensor
    start: torch.Tensor


@torch.no_grad()
def svd_img2vid(unet, decode_fn: Callable, cond_latent: torch.Tensor,
                clip_emb: torch.Tensor, num_frames: int = 14,
                num_steps: int = 25, fps_id: float = 6.0,
                motion_bucket_id: float = 127.0, cond_aug: float = 0.02,
                min_scale: float = 1.0, max_scale: float = 2.5,
                sigma_min: float = 0.002, sigma_max: float = 700.0,
                rho: float = 7.0, decode_chunk: int = 0,
                noise: Optional[SVDNoise] = None,
                generator: Optional[torch.Generator] = None) -> SVDResult:
    """Image -> video clip.

    unet: a `VideoUNet` over [(B T), 8, h, w] (4 noisy ++ 4 conditioning
      channels);
    decode_fn(z, num_frames) -> frames [(B T), 3, H, W] (the temporal
      VideoDecoder; the plain VAE decode for an image-decoder SVD);
    cond_latent: [B, 4, h, w], the VAE-encoded conditioning frame;
    clip_emb: [B, 1024], the CLIP-H image embedding.

    The unconditional branch zeroes both the CLIP tokens and the concat
    frames. The start is noise * sigma_0 (no DDPM rescale for an EDM
    model)."""
    b, c4, h, w = cond_latent.shape
    dev = cond_latent.device
    if noise is None:
        aug = torch.randn(cond_latent.shape, generator=generator, device=dev)
        start = torch.randn((b * num_frames, c4, h, w), generator=generator,
                            device=dev)
        noise = SVDNoise(aug, start)
    cond_latent = cond_latent.float()
    aug = cond_latent + cond_aug * noise.aug.to(dev, torch.float32)
    concat = aug.repeat_interleave(num_frames, dim=0)
    crossattn = clip_emb.float()[:, None, :].repeat_interleave(num_frames,
                                                               dim=0)
    vector = svd_vector_conditioning(b, fps_id, motion_bucket_id, cond_aug,
                                     device=dev).repeat_interleave(
                                         num_frames, dim=0)
    cond = {"crossattn": crossattn, "vector": vector, "concat": concat}
    uc = {"crossattn": torch.zeros_like(crossattn), "vector": vector,
          "concat": torch.zeros_like(concat)}
    dt = next(unet.parameters()).dtype

    def network(x, t_cond, crossattn, vector, concat):
        x_in = torch.cat([x, concat], dim=1).to(dt)
        return unet(x_in, t_cond, crossattn.to(dt), vector.to(dt),
                    num_frames=num_frames).float()

    denoise = make_linear_prediction_denoiser(
        ContinuousDenoiser(scaling=v_scaling_edm_cnoise), network, cond, uc,
        num_frames=num_frames, min_scale=min_scale, max_scale=max_scale)
    sigmas = edm_sigmas(num_steps, sigma_min, sigma_max, rho, device=dev)
    z = sample_euler(denoise, noise.start.to(dev, torch.float32) * sigmas[0],
                     sigmas, prepare=False)

    chunk = decode_chunk if 0 < decode_chunk < num_frames else num_frames
    zt = z.reshape(b, num_frames, c4, h, w)
    frames = []
    for i in range(0, num_frames, chunk):
        n = min(chunk, num_frames - i)
        f = decode_fn(zt[:, i:i + n].reshape(-1, c4, h, w), n).float()
        frames.append(f.reshape(b, n, *f.shape[1:]))
    return SVDResult(video=torch.clamp(torch.cat(frames, dim=1), -1.0, 1.0),
                     latents=z)
