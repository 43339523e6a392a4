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
stage 3 hands to stage 5. The unCLIP sampler is exact EulerEDM (the
cross-attention K/V hoisted out of the loop) or one of the JAX package's
fast paths, chosen by `unclip_sample`'s options (`sampler_opts` of
`reconstruct_keyframes`): TGATE with an optional PAB phase inside the gated
steps, PAB, DeepCache or encoder reuse.

Modules run in their own parameter dtype (bf16 on the card); the sampler
state, the prior loop and every output stay f32, as in the JAX bench.
Random draws come from `generator`, or from `noise` (explicit tensors, so
a test can replay the JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import SamplerConfig
from neurons_tpu_torch.diffusion import prior as prior_lib
from neurons_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from neurons_tpu_torch.diffusion.samplers import (
    sample_euler, sample_euler_encoder_reuse, sample_euler_pab,
    sample_euler_tgate)
from neurons_tpu_torch.diffusion.schedule import sd_sigmas
from neurons_tpu_torch.models.conditioner import unclip_vector_suffix
from neurons_tpu_torch.models.prior import prior_attn_bias
from neurons_tpu_torch.models.unet2d import precompute_context_kv


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


def draw_keyframe_noise(batch: int, tokens: int, width: int,
                        prior_steps: int, latent_hw: int,
                        generator: torch.Generator) -> KeyframeNoise:
    """Every draw of `reconstruct_keyframes` for `batch` voxels, on the
    generator's device: the prior's initial sample and its noise at each of
    `prior_steps` steps ([batch, tokens, width] each), then unCLIP's z and
    noise [batch, 4, latent_hw, latent_hw], offset [batch] and the
    unconditional tokens."""
    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    tok = (batch, tokens, width)
    lat = (batch, 4, latent_hw, latent_hw)
    prior = prior_lib.PriorNoise(normal(*tok),
                                 [normal(*tok) for _ in range(prior_steps)])
    return KeyframeNoise(prior, UnclipNoise(normal(*lat), normal(*lat),
                                            normal(batch), normal(*tok)))


def check_fast_options(tgate_step: int = 0, tgate_pab: int = 0,
                       pab=None, encoder_reuse: int = 1,
                       deep_cache: int = 0):
    """The JAX package's exclusivity rules of the fast paths."""
    if tgate_step > 0 and encoder_reuse > 1:
        raise ValueError("tgate_step and encoder_reuse>1 are mutually "
                         "exclusive")
    if pab is not None and (tgate_step > 0 or encoder_reuse > 1):
        raise ValueError("pab is exclusive with tgate/encoder_reuse")
    if tgate_pab > 0 and tgate_step <= 0:
        raise ValueError("tgate_pab requires tgate_step > 0")
    if deep_cache > 1 and (tgate_step > 0 or encoder_reuse > 1
                           or pab is not None):
        raise ValueError("deep_cache is exclusive with "
                         "tgate/encoder_reuse/pab")


@torch.inference_mode()
def unclip_sample(unet: nn.Module, vae: nn.Module, clip_tokens: torch.Tensor,
                  num_steps: int = 38, cfg_scale: float = 5.0,
                  offset_noise_level: float = 0.04, latent_hw: int = 96,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[UnclipNoise] = None,
                  encoder_reuse: int = 1, tgate_step: int = 0,
                  tgate_pab: int = 0, pab: Optional[tuple] = None,
                  pab_range: Optional[tuple] = None,
                  deep_cache: int = 0,
                  vector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """unclip_recon, batched: clip_tokens [B, 256, 1664] -> images NCHW in
    [0, 1]. x0 = z + noise * sigma_0 (the sampler's prepare step cancels
    the reference's divide by sqrt(1 + sigma_0^2)). `vector` is the UNet's
    adm conditioning [B, adm_in_channels] (default: the constant
    `unclip_vector_suffix`). Each cross-attention
    site's K/V projection of the CFG-doubled context is hoisted out of the
    loop (exact); latents are unscaled by the UNet config's
    `scale_factor` before the VAE decode.

    Fast paths (at most one, as `check_fast_options` rules; the defaults
    give the exact sampler):
      * tgate_step > 0: TGATE. The step before `tgate_step` caches each
        site's cross-attention residual, averaged over the uncond and cond
        halves; later steps run the UNet on batch B with those residuals.
        tgate_pab > 1 also caches the self-attention residuals on every
        tgate_pab-th gated step and reuses them in between;
      * pab = (i_s, i_x): PAB over the CFG batch, within `pab_range`;
      * deep_cache > 1: DeepCache, the full UNet every deep_cache-th step;
      * encoder_reuse > 1: the encoder every encoder_reuse-th step."""
    check_fast_options(tgate_step, tgate_pab, pab, encoder_reuse, deep_cache)
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
    vector = (unclip_vector_suffix(b, device=device) if vector is None
              else vector.to(device, torch.float32))

    udt = _dtype(unet)
    denoiser = DiscreteDenoiser.create_sd(device=device)
    ctx2 = torch.cat([uc, clip_tokens.float()]).to(udt)
    vec2 = torch.cat([vector, vector]).to(udt)
    kv2 = precompute_context_kv(unet, ctx2)
    ctx1, vec1 = clip_tokens.to(udt), vector.to(udt)

    def run(xs, s, ctx, vec, **kw):
        """(D(xs, s) from the UNet's eps, the UNet's extras); xs is the
        CFG-doubled batch when `ctx` is."""
        idx = denoiser.sigma_to_idx(s)
        c_skip, c_out, c_in, _ = denoiser.scaling(
            denoiser.sigmas[idx].reshape(-1, 1, 1, 1))
        out = unet((xs * c_in).to(udt), idx.float(), ctx, vec, **kw)
        out, extras = (out[0], out[1:]) if isinstance(out, tuple) else (
            out, ())
        return out.float() * c_out + xs * c_skip, extras

    def cfg(xs, s, **kw):
        """CFG over the doubled batch: (denoised, the UNet's extras)."""
        d, extras = run(torch.cat([xs, xs]), torch.cat([s, s]), ctx2, vec2,
                        ctx_kv=kv2, **kw)
        d_u, d_c = d.chunk(2)
        return d_u + cfg_scale * (d_c - d_u), extras

    def denoise_full(xs, s):
        return cfg(xs, s)[0]

    if tgate_step > 0:
        def denoise_capture(xs, s):
            d, (xattn,) = cfg(xs, s, capture_xattn=True)
            # [depth, 2B, T, C] -> the mean of the two halves
            return d, {k: 0.5 * (a[:, :b] + a[:, b:])
                       for k, a in xattn.items()}

        def denoise_gated(xs, s, cache):
            return run(xs, s, ctx1, vec1, xattn_cached=cache)[0]

        def denoise_gated_capture(xs, s, cache):
            d, (sattn,) = run(xs, s, ctx1, vec1, xattn_cached=cache,
                              capture_sattn=True)
            return d, sattn

        def denoise_gated_reuse(xs, s, cache, sattn):
            return run(xs, s, ctx1, vec1, xattn_cached=cache,
                       sattn_cached=sattn)[0]

        samples_z = sample_euler_tgate(
            denoise_full, denoise_capture, denoise_gated, x, sigmas,
            tgate_step, prepare=False,
            denoise_gated_capture=denoise_gated_capture,
            denoise_gated_reuse=denoise_gated_reuse,
            gated_interval=tgate_pab)
    elif pab is not None:
        def denoise_pab(xs, s, caches, use_x, use_s):
            xattn, sattn = caches
            kw = ({"xattn_cached": xattn} if use_x
                  else {"capture_xattn": True})
            kw.update({"sattn_cached": sattn} if use_s
                      else {"capture_sattn": True})
            d, extras = cfg(xs, s, **kw)
            extras = list(extras)
            return d, (xattn if use_x else extras.pop(0),
                       sattn if use_s else extras.pop(0))

        samples_z = sample_euler_pab(denoise_pab, x, sigmas, pab,
                                     pab_range=pab_range, prepare=False)
    elif deep_cache > 1:
        def denoise_full_deep(xs, s):
            d, (deep,) = cfg(xs, s, return_deep_cache=True)
            return d, deep

        def denoise_deep_cached(xs, s, deep):
            return cfg(xs, s, deep_cached=deep)[0]

        samples_z = sample_euler_encoder_reuse(
            denoise_full_deep, denoise_deep_cached, x, sigmas, deep_cache,
            prepare=False)
    elif encoder_reuse > 1:
        def denoise_full_cache(xs, s):
            d, (cache,) = cfg(xs, s, return_cache=True)
            return d, cache

        def denoise_cached(xs, s, cache):
            return cfg(xs, s, cached=cache)[0]

        samples_z = sample_euler_encoder_reuse(
            denoise_full_cache, denoise_cached, x, sigmas, encoder_reuse,
            prepare=False)
    else:
        samples_z = sample_euler(denoise_full, x, sigmas, prepare=False)
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
    sampler_opts: Optional[dict] = None,
    device="cuda",
) -> KeyframeOutputs:
    """Full stage-3 forward for one batch of voxels [B, 1, n_voxels].
    `decoupler` is a NeuronsDecoupler, `unet` a UNetModel, `vae` an
    AutoencoderKL, all on `device`; `class_text_embeds` is the [51, 1280]
    class-name CLIP table (enhance mode). `sampler_opts` are the fast-path
    options of `unclip_sample`. The blurry latents come back divided by the
    VAE config's `scaling_factor`."""
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
        noise=None if noise is None else noise.unclip,
        **(sampler_opts or {}))

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
