"""Stage-5 video reconstruction (the NeuroClips sampler), exact path.

Counterpart of neurons_tpu/pipelines/video.py:

  blurry 6-frame video --cccat--> 16 frames --VAE encode--> init latents
  keyframe --VAE encode--> SparseCtrl condition at frame 0
  DDIM(25) loop: SparseCtrl residuals -> UNet3D eps -> CFG -> DDIM step
  VAE decode in chunks of at most 16 frames -> video [B, F, 3, H, W] in [0, 1]

Reproduced as the JAX package has it: the partial-noise init noises the
blurry latents at `timesteps[:t_start][:1]`, which is timesteps[0]
(t = 961 for 25 steps) for every `low_strength` below about 0.96; the
CFG batch is [uncond, cond]; SparseCtrl sees the keyframe at frame 0
only (its VAE latent, or its pixels with `use_simplified_cond=False` and
the RGB condition branch), with the frame-0 mask set to 1. The loop state
is f32; the UNet3D and the controlnet run in their own dtype.

The JAX package's fast paths, one at a time: TGATE (`tgate_step`, with an
optional PAB phase inside the gated steps, `tgate_pab`), PAB (`pab`,
`pab_range`) and encoder reuse (`encoder_reuse`). `animate` is stock
AnimateDiff text-to-video: pure-noise DDIM with CFG and no controlnet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.diffusion.ddim import DDIMScheduler
from neurons_tpu_torch.pipelines.keyframe import (_check_device, _dtype,
                                                  check_fast_options)


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


def _guide(eps: torch.Tensor, scale: float) -> torch.Tensor:
    """CFG: the [uncond, cond] halves of eps -> u + scale (c - u)."""
    eps_u, eps_c = eps.chunk(2)
    return eps_u + scale * (eps_c - eps_u)


def _decode_frames(vae: nn.Module, latents: torch.Tensor,
                   latent_scale: float) -> torch.Tensor:
    """[B, 4, F, h, w] -> [B, F, 3, H, W] in [0, 1], decoded in chunks of
    the largest divisor of B*F that is at most 16."""
    b, f = latents.shape[0], latents.shape[2]
    lat_f = latents.transpose(1, 2).reshape(b * f, *latents.shape[1:2],
                                            *latents.shape[3:])
    chunk = next(c for c in range(min(16, b * f), 0, -1)
                 if (b * f) % c == 0)
    vdt = _dtype(vae)
    frames = torch.cat([vae.decode((z / latent_scale).to(vdt)).float()
                        for z in lat_f.split(chunk)])
    frames = torch.clamp(frames / 2 + 0.5, 0.0, 1.0)
    return frames.reshape(b, f, *frames.shape[1:])


@torch.inference_mode()
def reconstruct_video(
    unet3d: nn.Module, controlnet: Optional[nn.Module], vae: nn.Module,
    blurry_video: torch.Tensor,        # [B, F0, 3, H, W] in [0, 1]
    keyframe: torch.Tensor,            # [B, 3, H, W] in [0, 1]
    text_embeddings: torch.Tensor,     # [B, 77, ctx] (conditional)
    uncond_embeddings: torch.Tensor,   # [B, 77, ctx] (empty prompt)
    num_steps: int = 25, guidance_scale: float = 8.5,
    low_strength: float = 0.3, n_frames: int = 16,
    controlnet_scale: float = 1.0, latent_scale: float = 0.18215,
    use_simplified_cond: bool = True, encoder_reuse: int = 1,
    tgate_step: int = 0, tgate_pab: int = 0,
    pab: Optional[Tuple[int, int, int]] = None,
    pab_range: Optional[Tuple[int, int]] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device="cuda",
) -> VideoPipelineOutputs:
    """One batched stage-5 reconstruction. `unet3d` is a UNet3DModel,
    `controlnet` a SparseControlNetModel (or None), `vae` an AutoencoderKL,
    all on `device`. `noise` is the init noise [B, 4, F, h, w]; without it
    the draw comes from `generator`.

    Fast paths (at most one; the defaults give the exact sampler):
      * tgate_step > 0: TGATE. The step before `tgate_step` caches the
        cross-attention residuals and the controlnet's residuals, each the
        mean of the uncond and cond halves; later steps run the UNet3D on
        batch B with them and no controlnet. tgate_pab > 1 also caches the
        spatial and temporal attention residuals on every tgate_pab-th
        gated step and reuses them in between;
      * pab = (Is, It, Ic), Is | It | Ic: step i runs in full when
        i % Ic == 0 or i lies outside `pab_range`; otherwise the cross
        attention is reused, the temporal when i % It != 0 and the spatial
        when also i % Is != 0;
      * encoder_reuse > 1: the UNet3D's encoder features and the
        controlnet's residuals are recomputed every encoder_reuse-th step
        only."""
    check_fast_options(tgate_step, tgate_pab, pab, encoder_reuse)
    if pab is not None and not (pab[1] % pab[0] == 0
                                and pab[2] % pab[1] == 0):
        raise ValueError("pab intervals must nest: Is | It | Ic")
    dev = resolve_device(device)
    nets = dict(unet3d=unet3d, vae=vae)
    if controlnet is not None:
        nets["controlnet"] = controlnet
    _check_device(dev, **nets)
    udt, vdt = _dtype(unet3d), _dtype(vae)
    blurry_video, keyframe = blurry_video.to(dev), keyframe.to(dev)
    b = blurry_video.shape[0]
    bf = b * n_frames
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

    text2 = torch.cat([uncond_embeddings, text_embeddings]).to(dev)
    text2_u = text2.to(udt)
    text1_u = text_embeddings.to(dev, udt)

    if controlnet is not None:
        # SparseCtrl condition at frame 0 (the keyframe's latent, or its
        # pixels for the RGB branch), mask 1 there
        cdt = _dtype(controlnet)
        key = encode(keyframe) if use_simplified_cond else keyframe.float()
        cond = torch.zeros((b, key.shape[1], n_frames, *key.shape[2:]),
                           device=dev)
        cond[:, :, 0] = key
        mask = torch.zeros((b, 1, n_frames, *key.shape[2:]), device=dev)
        mask[:, :, 0] = 1.0
        text2_c = text2.to(cdt)
        cond2 = torch.cat([cond, cond]).to(cdt)
        mask2 = torch.cat([mask, mask]).to(cdt)

    def residuals(x2, t2):
        if controlnet is None:
            return None, None
        return controlnet(x2.to(cdt), t2, text2_c, cond2, mask2,
                          controlnet_scale)

    def unet(x, t, text, down, mid, **kw):
        """(eps f32, the UNet3D's extras)."""
        out = unet3d(x.to(udt), t, text, down, mid, **kw)
        out, extras = (out[0], out[1:]) if isinstance(out, tuple) else (
            out, ())
        return out.float(), extras

    def unet_cfg(latents, t, down, mid, **kw):
        """CFG over the doubled batch: (eps, the UNet3D's extras)."""
        x2 = torch.cat([latents, latents])
        t2 = torch.full((2 * b,), float(t), device=dev)
        eps, extras = unet(x2, t2, text2_u, down, mid, **kw)
        return _guide(eps, guidance_scale), extras

    def cfg(latents, t, **kw):
        """CFG with fresh controlnet residuals: (eps, the UNet3D's extras,
        the residuals)."""
        t2 = torch.full((2 * b,), float(t), device=dev)
        down, mid = residuals(torch.cat([latents, latents]), t2)
        return unet_cfg(latents, t, down, mid, **kw) + ((down, mid),)

    def half(a, dim=0):
        """The mean of the uncond and cond rows of the folded (B F) axis."""
        return 0.5 * (a.narrow(dim, 0, bf) + a.narrow(dim, bf, bf))

    timesteps = sched.timesteps.tolist()
    n = len(timesteps)
    if tgate_step > 0:
        m = min(max(int(tgate_step), 1), n)
        for t in timesteps[:m - 1]:
            latents = sched.step(cfg(latents, t)[0], t, latents)
        t = timesteps[m - 1]
        eps, (xattn,), (down, mid) = cfg(latents, t, capture_xattn=True)
        # stacked captures are [depth, 2BF, ...]: halves on axis 1
        xattn = {k: half(a, 1) for k, a in xattn.items()}
        down = None if down is None else tuple(half(r) for r in down)
        mid = None if mid is None else half(mid)
        latents = sched.step(eps, t, latents)
        st = None
        for j, t in enumerate(timesteps[m:]):
            t1 = torch.full((b,), float(t), device=dev)
            if tgate_pab <= 1:
                eps, _ = unet(latents, t1, text1_u, down, mid,
                              xattn_cached=xattn)
            elif j % tgate_pab == 0:
                eps, st = unet(latents, t1, text1_u, down, mid,
                               xattn_cached=xattn, capture_sattn=True,
                               capture_tattn=True)
            else:
                eps, _ = unet(latents, t1, text1_u, down, mid,
                              xattn_cached=xattn, sattn_cached=st[0],
                              tattn_cached=st[1])
            latents = sched.step(eps, t, latents)
    elif pab is not None:
        i_s, i_t, i_c = pab
        lo, hi = pab_range or (0, n)
        caches = {"x": None, "s": None, "t": None}
        for i, t in enumerate(timesteps):
            if i % i_c == 0 or i < lo or i >= hi:
                reuse = ()
            elif i % i_t == 0:
                reuse = ("x",)
            elif i % i_s == 0:
                # spatial-only recompute: cross and temporal cached
                reuse = ("x", "t")
            else:
                reuse = ("x", "s", "t")
            kw = {}
            for kind in ("x", "s", "t"):
                if kind in reuse:
                    kw[f"{kind}attn_cached"] = caches[kind]
                else:
                    kw[f"capture_{kind}attn"] = True
            eps, extras, _ = cfg(latents, t, **kw)
            extras = list(extras)
            for kind in ("x", "s", "t"):
                if kind not in reuse:
                    caches[kind] = extras.pop(0)
            latents = sched.step(eps, t, latents)
    elif encoder_reuse > 1:
        cache = None
        for i, t in enumerate(timesteps):
            if i % encoder_reuse == 0:
                eps, (enc,), (down, mid) = cfg(latents, t, return_cache=True)
                cache = (enc, down, mid)
            else:
                enc, down, mid = cache
                eps, _ = unet_cfg(latents, t, down, mid, cached=enc)
            latents = sched.step(eps, t, latents)
    else:
        for t in timesteps:
            latents = sched.step(cfg(latents, t)[0], t, latents)

    return VideoPipelineOutputs(
        latents=latents, video=_decode_frames(vae, latents, latent_scale))


@torch.inference_mode()
def animate(
    unet3d: nn.Module, vae: nn.Module,
    text_embeddings: torch.Tensor, uncond_embeddings: torch.Tensor,
    n_frames: int = 16, latent_hw: int = 32, num_steps: int = 25,
    guidance_scale: float = 7.5, latent_scale: float = 0.18215,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None, device="cuda",
) -> VideoPipelineOutputs:
    """Stock AnimateDiff text-to-video: DDIM with CFG from pure noise
    [B, 4, F, h, w] (`noise`, else drawn from `generator`; DDIM's initial
    noise sigma is 1), no blurry-latent init and no controlnet."""
    dev = resolve_device(device)
    _check_device(dev, unet3d=unet3d, vae=vae)
    udt = _dtype(unet3d)
    b = text_embeddings.shape[0]
    sched = DDIMScheduler.create(num_steps, device=dev)
    shape = (b, 4, n_frames, latent_hw, latent_hw)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=dev)
    latents = noise.to(dev, torch.float32)
    text2 = torch.cat([uncond_embeddings, text_embeddings]).to(dev, udt)
    for t in sched.timesteps.tolist():
        x2 = torch.cat([latents, latents]).to(udt)
        t2 = torch.full((2 * b,), float(t), device=dev)
        eps = unet3d(x2, t2, text2).float()
        latents = sched.step(_guide(eps, guidance_scale), t, latents)
    return VideoPipelineOutputs(
        latents=latents, video=_decode_frames(vae, latents, latent_scale))
