"""Stage-3 keyframe reconstruction (base + enhance modes).

Counterpart of neurons_tpu/pipelines/keyframe.py:

  voxel -> ridge/backbone -> 100-step prior -> CLIP image tokens
       -> [enhance: classifier top-1 concept -> class-name text embed ->
           seg masks; masks gate the blurry latents and modulate the prior
           tokens]
       -> blurry video latents (recon head)
       -> caption (GPT-2 greedy)
       -> keyframe (EulerEDM 38-step CFG unCLIP sampling -> VAE decode)

and `decode_blurry_video`, the blurry-latent VAE decode to pixels that
stage 3 hands to stage 5. Only the exact sampler is ported (sample_euler
with the cross-attention K/V hoisted out of the loop); the TGATE, PAB,
DeepCache and encoder-reuse variants are later work.

Modules run in their own parameter dtype (bf16 on the card); the sampler
state, the prior loop and every output stay f32, as in the JAX bench.
Random draws come from `generator`, or from `noise` (explicit tensors, so
a test can replay the JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import SamplerConfig
from neurons_tpu_torch.diffusion import prior as prior_lib
from neurons_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from neurons_tpu_torch.diffusion.samplers import sample_euler
from neurons_tpu_torch.diffusion.schedule import sd_sigmas
from neurons_tpu_torch.models.prior import prior_attn_bias
from neurons_tpu_torch.models.unet2d import (precompute_context_kv,
                                             timestep_embedding)


def unclip_vector_suffix(batch_size: int = 1,
                         orig_size: Sequence[int] = (768, 768),
                         crop_coords: Sequence[int] = (0, 0),
                         outdim: int = 256, device="cpu") -> torch.Tensor:
    """The constant `vector` conditioning of the unclip engine:
    cat(embed(orig_size), embed(crop)) -> [B, 4 * outdim]."""
    def embed(values):
        v = torch.tensor([values], dtype=torch.float32,
                         device=device).repeat(batch_size, 1)
        return timestep_embedding(v.reshape(-1), outdim).reshape(
            batch_size, -1)
    return torch.cat([embed(orig_size), embed(crop_coords)], dim=-1)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def _dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def _check_device(device: torch.device, **modules: nn.Module):
    for name, m in modules.items():
        got = next(m.parameters()).device
        if got.type != device.type or (device.index is not None
                                       and got.index != device.index):
            raise ValueError(f"{name} lies on {got}, the pipeline runs on "
                             f"{device}")


class UnclipNoise(NamedTuple):
    """Explicit draws of `unclip_sample`: z and noise [B, 4, h, w], the
    per-sample offset [B], the unconditional tokens (clip_tokens' shape)."""

    z: torch.Tensor
    noise: torch.Tensor
    offset: torch.Tensor
    uc: torch.Tensor


class KeyframeNoise(NamedTuple):
    prior: prior_lib.PriorNoise
    unclip: UnclipNoise


@torch.inference_mode()
def unclip_sample(unet: nn.Module, vae: nn.Module, clip_tokens: torch.Tensor,
                  num_steps: int = 38, cfg_scale: float = 5.0,
                  offset_noise_level: float = 0.04, latent_hw: int = 96,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[UnclipNoise] = None) -> torch.Tensor:
    """unclip_recon, batched: clip_tokens [B, 256, 1664] -> images NCHW in
    [0, 1]. x0 = z + noise * sigma_0 (the sampler's prepare step cancels
    the reference's divide by sqrt(1 + sigma_0^2)). Each cross-attention
    site's K/V projection of the CFG-doubled context is hoisted out of the
    loop (exact); latents are unscaled by the UNet config's
    `scale_factor` before the VAE decode."""
    device = clip_tokens.device
    b = clip_tokens.shape[0]
    shape = (b, 4, latent_hw, latent_hw)
    if noise is None:
        def normal(*s):
            return torch.randn(s, generator=generator, device=device)
        noise = UnclipNoise(normal(*shape), normal(*shape), normal(b),
                            normal(*clip_tokens.shape))
    z, eps, offset, uc = (t.to(device, torch.float32) for t in noise)
    if offset_noise_level > 0:
        eps = eps + offset_noise_level * offset[:, None, None, None]
    sigmas = sd_sigmas(num_steps, device=device)
    x = z + eps * sigmas[0]
    vector = unclip_vector_suffix(b, device=device)

    udt = _dtype(unet)
    denoiser = DiscreteDenoiser.create_sd(device=device)
    ctx2 = torch.cat([uc, clip_tokens.float()]).to(udt)
    vec2 = torch.cat([vector, vector]).to(udt)
    kv2 = precompute_context_kv(unet, ctx2)

    def denoise(xs, s):
        x2, s2 = torch.cat([xs, xs]), torch.cat([s, s])
        idx = denoiser.sigma_to_idx(s2)
        c_skip, c_out, c_in, _ = denoiser.scaling(
            denoiser.sigmas[idx].reshape(-1, 1, 1, 1))
        out = unet((x2 * c_in).to(udt), idx.float(), ctx2, vec2,
                   ctx_kv=kv2).float()
        d_u, d_c = (out * c_out + x2 * c_skip).chunk(2)
        return d_u + cfg_scale * (d_c - d_u)

    samples_z = sample_euler(denoise, x, sigmas, prepare=False)
    # one sample at a time: the 768x768 decoder activations are large
    vdt = _dtype(vae)
    samples_x = torch.cat([vae.decode((zi[None] / unet.cfg.scale_factor)
                                      .to(vdt)).float()
                           for zi in samples_z])
    return torch.clamp(samples_x * 0.8 + 0.2, 0.0, 1.0)


class KeyframeOutputs(NamedTuple):
    prior_tokens: torch.Tensor        # [B, 256, 1664]
    motion_embeds: torch.Tensor       # [B, F, 256, 1664]
    keyframes: torch.Tensor           # [B, 3, 768, 768] in [0, 1]
    blurry_latents: torch.Tensor      # [(B F), 4, h, w]
    captions: torch.Tensor            # [B, max_len] token ids
    cls_logits: Optional[torch.Tensor] = None   # enhance: [B, 51]
    seg_masks: Optional[torch.Tensor] = None    # enhance: [(B F), 1, h, w]


@torch.inference_mode()
def reconstruct_keyframes(
    decoupler: nn.Module, unet: nn.Module, vae: nn.Module,
    voxel: torch.Tensor,
    class_text_embeds: Optional[torch.Tensor] = None,
    sampler_cfg: SamplerConfig = SamplerConfig(),
    latent_hw: int = 96, enhance: bool = False, caption_len: int = 60,
    mask_latent_hw: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[KeyframeNoise] = None,
    device="cuda",
) -> KeyframeOutputs:
    """Full stage-3 forward for one batch of voxels [B, 1, n_voxels].
    `decoupler` is a NeuronsDecoupler, `unet` a UNetModel, `vae` an
    AutoencoderKL, all on `device`; `class_text_embeds` is the [51, 1280]
    class-name CLIP table (enhance mode). The blurry latents come back
    divided by the VAE config's `scaling_factor`."""
    dev = resolve_device(device)
    _check_device(dev, decoupler=decoupler, unet=unet, vae=vae)
    if enhance and class_text_embeds is None:
        raise ValueError("enhance=True requires class_text_embeds "
                         "(the [51, 1280] class-name CLIP table)")
    ddt = _dtype(decoupler)
    voxel = voxel.to(dev)
    b = voxel.shape[0]

    def run(fn, *args, **kw):
        """a decoupler method on args cast to its dtype; f32 results"""
        args = [a.to(ddt) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        out = fn(*args, **kw)
        return out.float() if out.is_floating_point() else out

    _, clip_vision, _ = decoupler.encode(voxel.to(ddt))
    clip_vision = clip_vision.float()

    prior_bias = prior_attn_bias(decoupler.prior_net)
    diffusion = prior_lib.PriorDiffusion.create(sampler_cfg.prior_steps,
                                                device=dev)

    def prior_net(image_embed, times, brain_embed, **kw):
        return run(decoupler.prior_apply, image_embed, times, brain_embed,
                   attn_bias=prior_bias, **kw)

    prior_out = prior_lib.p_sample_loop(
        diffusion, prior_net, tuple(clip_vision.shape), clip_vision,
        generator=generator, noise=None if noise is None else noise.prior)

    motion = run(decoupler.motion, prior_out)        # [B, F, N, C]
    n_frames = motion.shape[1]
    pooled_text = run(decoupler.project_text, motion.mean(dim=1))
    flat_motion = motion.reshape(b * n_frames, motion.shape[2],
                                 motion.shape[3])
    cls_logits = seg_masks = None
    if enhance:
        # classifier top-1 concept -> class text embed -> seg masks
        cls_logits = run(decoupler.classify, motion.mean(dim=1).mean(dim=1))
        best_text = class_text_embeds.to(dev)[cls_logits.argmax(dim=-1)]
        seg_masks = run(decoupler.seg_decode, flat_motion, best_text,
                        b * n_frames)

    blurry = run(decoupler.seg_decode, flat_motion, pooled_text,
                 b * n_frames, is_seg=False)
    # jax.image.resize "nearest" samples at half-pixel centres, as
    # "nearest-exact" does (plain "nearest" does not)
    if mask_latent_hw is not None:
        blurry = F.interpolate(blurry, size=(mask_latent_hw,) * 2,
                               mode="nearest-exact")
    gate = None
    if enhance:
        # sigmoid -> binarize > 0.5 -> map to {0.5, 1.0}
        gate = ((torch.sigmoid(seg_masks) > 0.5).float() + 1.0) / 2.0
        gate = F.interpolate(gate, size=blurry.shape[-2:],
                             mode="nearest-exact")
        blurry = blurry * gate

    # caption: the prefix is the normalized clipproj vector
    captions = decoupler.caption_greedy(l2norm(pooled_text).to(ddt),
                                        caption_len)

    tokens = prior_out
    if gate is not None:
        # frame-mean mask -> sqrt(N) x sqrt(N) grid -> [B, N, 1] gate
        n = prior_out.shape[1]
        grid = int(n ** 0.5)
        image_mask = gate.reshape(b, n_frames, *gate.shape[1:]).mean(dim=1)
        image_mask = F.interpolate(image_mask, size=(grid, grid),
                                   mode="nearest-exact")
        tokens = tokens * image_mask.reshape(b, n, 1)

    keyframes = unclip_sample(
        unet, vae, tokens, num_steps=sampler_cfg.unclip_steps,
        cfg_scale=sampler_cfg.unclip_cfg_scale,
        offset_noise_level=sampler_cfg.offset_noise_level,
        latent_hw=latent_hw, generator=generator,
        noise=None if noise is None else noise.unclip)

    return KeyframeOutputs(prior_tokens=prior_out, motion_embeds=motion,
                           keyframes=keyframes,
                           blurry_latents=blurry / vae.cfg.scaling_factor,
                           captions=captions, cls_logits=cls_logits,
                           seg_masks=seg_masks)


@torch.inference_mode()
def decode_blurry_video(vae: nn.Module, blurry_latents: torch.Tensor,
                        n_frames: int) -> torch.Tensor:
    """Blurry-video latents [(B F), 4, h, w] (already divided by the VAE
    latent scale) -> pixels [B, F, 3, 8h, 8w] in [0, 1], one frame at a
    time to bound the decoder's activations."""
    vdt = _dtype(vae)
    px = torch.cat([vae.decode(zi[None].to(vdt)).float()
                    for zi in blurry_latents])
    px = torch.clamp(px / 2 + 0.5, 0.0, 1.0)
    return px.reshape(-1, n_frames, *px.shape[1:])
