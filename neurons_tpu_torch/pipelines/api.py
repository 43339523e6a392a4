"""The sgm inference API: model presets, sampling parameters, txt2img and
img2img over a DiffusionEngine, and the invisible watermark.

Counterpart of neurons_tpu/pipelines/api.py (sgm's inference/api.py and
inference/helpers.py). The presets are typed configs; the sampler enum
maps to the samplers of `diffusion/samplers.py`; the img2img strength
prunes the zero-appended sigma ladder as the reference's
Img2ImgDiscretizationWrapper does. Random draws (the start noise, the
offset noise, the stochastic samplers' per-step noise) are explicit
tensors or come from a generator.

The watermark is the JAX package's numpy blind block-DCT tag: the
reference's fixed 48-bit message, quantization-index modulated into the
blue channel's (2, 1) coefficient of every 8x8 block.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neurons_tpu_torch.config import UNet2DConfig, VideoUNetConfig
from neurons_tpu_torch.diffusion import samplers as S
from neurons_tpu_torch.diffusion.schedule import edm_sigmas, sd_sigmas


class ModelArchitecture(str, enum.Enum):
    """The reference's presets, the NEURONS unclip engine and SVD."""

    SD_UNCLIP = "sd21-unclip"
    SD_2_1 = "stable-diffusion-v2-1"
    SD_2_1_768 = "stable-diffusion-v2-1-768"
    SDXL_BASE = "stable-diffusion-xl-v1-base"
    SDXL_REFINER = "stable-diffusion-xl-v1-refiner"
    SVD = "stable-video-diffusion"


class Sampler(str, enum.Enum):
    EULER_EDM = "EulerEDMSampler"
    HEUN_EDM = "HeunEDMSampler"
    EULER_ANCESTRAL = "EulerAncestralSampler"
    DPMPP2S_ANCESTRAL = "DPMPP2SAncestralSampler"
    DPMPP2M = "DPMPP2MSampler"
    LINEAR_MULTISTEP = "LinearMultistepSampler"


class Discretization(str, enum.Enum):
    LEGACY_DDPM = "LegacyDDPMDiscretization"
    EDM = "EDMDiscretization"


class Guider(str, enum.Enum):
    VANILLA = "VanillaCFG"
    IDENTITY = "IdentityGuider"


@dataclass
class SamplingParams:
    """The reference's SamplingParams, field for field."""

    width: int = 1024
    height: int = 1024
    steps: int = 50
    sampler: Sampler = Sampler.DPMPP2M
    discretization: Discretization = Discretization.LEGACY_DDPM
    guider: Guider = Guider.VANILLA
    scale: float = 6.0
    aesthetic_score: float = 5.0
    negative_aesthetic_score: float = 5.0
    img2img_strength: float = 1.0
    orig_width: int = 1024
    orig_height: int = 1024
    crop_coords_top: int = 0
    crop_coords_left: int = 0
    sigma_min: float = 0.0292
    sigma_max: float = 14.6146
    rho: float = 3.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = 999.0
    s_noise: float = 1.0
    eta: float = 1.0
    order: int = 4


@dataclass
class SamplingSpec:
    """The reference's SamplingSpec with a typed config for the yaml."""

    width: int
    height: int
    channels: int
    factor: int
    is_legacy: bool
    config: object  # UNet2DConfig | VideoUNetConfig
    ckpt: str
    is_guided: bool


# UNet shapes of the reference's inference yamls (sd_2_1, sd_xl_base,
# sd_xl_refiner) and unclip6.yaml
_SD21_UNET = UNet2DConfig(
    model_channels=320, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
    attention_resolutions=(4, 2, 1), transformer_depth=(1, 1, 1, 1),
    num_head_channels=64, context_dim=1024, adm_in_channels=0)
_SDXL_BASE_UNET = UNet2DConfig(
    model_channels=320, channel_mult=(1, 2, 4), num_res_blocks=2,
    attention_resolutions=(4, 2), transformer_depth=(1, 2, 10),
    num_head_channels=64, context_dim=2048, adm_in_channels=2816)
_SDXL_REFINER_UNET = UNet2DConfig(
    model_channels=384, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
    attention_resolutions=(4, 2), transformer_depth=(4, 4, 4, 4),
    num_head_channels=64, context_dim=1280, adm_in_channels=2560)

model_specs: Dict[ModelArchitecture, SamplingSpec] = {
    ModelArchitecture.SD_UNCLIP: SamplingSpec(
        height=768, width=768, channels=4, factor=8, is_legacy=True,
        config=UNet2DConfig(), ckpt="unclip6_epoch0_step110000.ckpt",
        is_guided=True),
    ModelArchitecture.SD_2_1: SamplingSpec(
        height=512, width=512, channels=4, factor=8, is_legacy=True,
        config=_SD21_UNET, ckpt="v2-1_512-ema-pruned.safetensors",
        is_guided=True),
    ModelArchitecture.SD_2_1_768: SamplingSpec(
        height=768, width=768, channels=4, factor=8, is_legacy=True,
        config=_SD21_UNET, ckpt="v2-1_768-ema-pruned.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_BASE: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=False,
        config=_SDXL_BASE_UNET, ckpt="sd_xl_base_1.0.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_REFINER: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=True,
        config=_SDXL_REFINER_UNET, ckpt="sd_xl_refiner_1.0.safetensors",
        is_guided=True),
    ModelArchitecture.SVD: SamplingSpec(
        height=576, width=1024, channels=4, factor=8, is_legacy=False,
        config=VideoUNetConfig(), ckpt="svd.safetensors", is_guided=True),
}


def build_sigmas(params: SamplingParams, device="cpu") -> torch.Tensor:
    """The discretization's ladder with its trailing 0, pruned by the
    img2img strength as the reference's wrapper prunes it: the last
    max(int(strength * len), 1) entries of the zero-appended ladder, so
    steps=10, strength=0.4 keep 4 of 11 entries, 3 denoising steps."""
    if params.discretization == Discretization.EDM:
        sigmas = edm_sigmas(params.steps, params.sigma_min, params.sigma_max,
                            params.rho, append_zero=True, device=device)
    else:
        sigmas = sd_sigmas(params.steps, append_zero=True, device=device)
    if params.img2img_strength < 1.0:
        keep = max(int(params.img2img_strength * sigmas.shape[0]), 1)
        sigmas = sigmas[-keep:]
    return sigmas


def run_sampler(params: SamplingParams, denoise, x: torch.Tensor,
                sigmas: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                prepare: bool = True) -> torch.Tensor:
    """The sampler enum -> its sampler. `noise` / `generator` feed the
    stochastic ones (EulerEDM with s_churn > 0 and the two ancestral)."""
    s = params.sampler
    if s == Sampler.EULER_EDM:
        return S.sample_euler(denoise, x, sigmas, prepare=prepare,
                              s_churn=params.s_churn, s_noise=params.s_noise,
                              noise=noise, generator=generator)
    if s == Sampler.HEUN_EDM:
        return S.sample_heun(denoise, x, sigmas, prepare=prepare)
    if s == Sampler.EULER_ANCESTRAL:
        return S.sample_euler_ancestral(
            denoise, x, sigmas, eta=params.eta, s_noise=params.s_noise,
            prepare=prepare, noise=noise, generator=generator)
    if s == Sampler.DPMPP2S_ANCESTRAL:
        return S.sample_dpmpp2s_ancestral(
            denoise, x, sigmas, eta=params.eta, s_noise=params.s_noise,
            prepare=prepare, noise=noise, generator=generator)
    if s == Sampler.DPMPP2M:
        return S.sample_dpmpp2m(denoise, x, sigmas, prepare=prepare)
    if s == Sampler.LINEAR_MULTISTEP:
        return S.sample_lms(denoise, x, sigmas, order=params.order,
                            prepare=prepare)
    raise ValueError(s)


def _cfg_denoise(engine, params: SamplingParams, cond: Dict, uc: Dict):
    if params.guider == Guider.IDENTITY or not uc:
        return S.make_identity_denoiser(engine.denoiser, engine.network, cond)
    return S.make_cfg_denoiser(engine.denoiser, engine.network, cond, uc,
                               scale=params.scale)


def _draw(shape, start, generator, device) -> torch.Tensor:
    if start is not None:
        return start.to(device, torch.float32)
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def do_sample(engine, params: SamplingParams, cond: Dict,
              uc: Optional[Dict] = None, num_samples: int = 1,
              return_latents: bool = False,
              start_noise: Optional[torch.Tensor] = None,
              noise: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None):
    """txt2img over a DiffusionEngine: noise at the latent shape
    (`start_noise`, else drawn), CFG-sample, decode, map to [0, 1]."""
    factor = 2 ** (len(engine.vae_cfg.block_out_channels) - 1)
    h, w = params.height // factor, params.width // factor
    x = _draw((num_samples, engine.unet_cfg.in_channels, h, w), start_noise,
              generator, engine.device)
    sigmas = build_sigmas(dataclasses.replace(params, img2img_strength=1.0),
                          device=engine.device)
    denoise = _cfg_denoise(engine, params, cond, uc or {})
    z = run_sampler(params, denoise, x, sigmas, noise=noise,
                    generator=generator)
    samples = torch.clamp((engine.decode_first_stage(z) + 1.0) / 2.0,
                          0.0, 1.0)
    return (samples, z) if return_latents else samples


@torch.no_grad()
def do_img2img(img, engine, params: SamplingParams, cond: Dict,
               uc: Optional[Dict] = None, offset_noise_level: float = 0.0,
               skip_encode: bool = False, return_latents: bool = False,
               start_noise: Optional[torch.Tensor] = None,
               offset_noise: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
    """img2img: encode, noise at the strength-pruned sigma_0, resample,
    decode. The loop runs on z + sigma_0 * noise directly: the reference
    divides by sqrt(1 + sigma_0^2) only because its sampler's prepare
    multiplies it back, so both are skipped. `offset_noise` [B, 1, 1, 1]
    (else drawn after the start noise) adds offset_noise_level times it."""
    z = img if skip_encode else engine.encode_first_stage(img)
    z = z.to(engine.device, torch.float32)
    sigmas = build_sigmas(params, device=engine.device)
    eps = _draw(z.shape, start_noise, generator, engine.device)
    if offset_noise_level > 0.0:
        eps = eps + offset_noise_level * _draw(
            (z.shape[0],) + (1,) * (z.dim() - 1), offset_noise, generator,
            engine.device)
    noised = z + eps * sigmas[0]
    denoise = _cfg_denoise(engine, params, cond, uc or {})
    z_out = run_sampler(params, denoise, noised, sigmas, noise=noise,
                        generator=generator, prepare=False)
    samples = torch.clamp((engine.decode_first_stage(z_out) + 1.0) / 2.0,
                          0.0, 1.0)
    return (samples, z_out) if return_latents else samples


# ---------------------------------------------------------------------------
# The watermark
# ---------------------------------------------------------------------------

# the reference's fixed 48-bit message
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = [int(b) for b in bin(WATERMARK_MESSAGE)[2:]]
_STRENGTH = 4.0  # DCT-coefficient quantization step


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1)
                                  * k[:, None] / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m


def _blocks(ch: np.ndarray, nbh: int, nbw: int) -> np.ndarray:
    """[H, W] -> its 8x8 blocks [nbh, nbw, 8, 8]."""
    return ch[:nbh * 8, :nbw * 8].reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3)


def embed_watermark(images: np.ndarray) -> np.ndarray:
    """Embed the 48-bit tag into the blue channel's (2, 1) block-DCT
    coefficient. images: [..., B, C, H, W] float in [0, 1]. Needs >= 48
    8x8 blocks (about 56x56 px) to carry the whole message. Each block's
    DCT is two matrix products (D X D^T), not a 3-operand einsum."""
    imgs = np.asarray(images, np.float32)
    squeeze = imgs.ndim == 4
    if squeeze:
        imgs = imgs[None]
    n, b, c, hh, ww = imgs.shape
    out = imgs.reshape(n * b, c, hh, ww).copy()
    D = _dct_matrix()
    nbh, nbw = hh // 8, ww // 8
    bits = np.asarray(WATERMARK_BITS, np.float32)
    idx = (np.arange(nbh * nbw) % len(bits)).reshape(nbh, nbw)
    tgt = bits[idx]  # bit per block
    for i in range(out.shape[0]):
        ch = out[i, -1] * 255.0  # blue channel
        coef = D @ _blocks(ch, nbh, nbw) @ D.T
        # QIM: snap the coefficient to the lattice of its bit
        q = np.round(coef[:, :, 2, 1] / _STRENGTH - 0.5 * tgt)
        coef[:, :, 2, 1] = (q + 0.5 * tgt) * _STRENGTH
        blocks = D.T @ coef @ D
        ch[:nbh * 8, :nbw * 8] = blocks.transpose(0, 2, 1, 3).reshape(
            nbh * 8, nbw * 8)
        out[i, -1] = ch / 255.0
    out = np.clip(out, 0.0, 1.0).reshape(n, b, c, hh, ww)
    return out[0] if squeeze else out


def decode_watermark(image: np.ndarray) -> list:
    """Recover the 48-bit tag of one image [C, H, W] (majority vote over
    its blocks)."""
    img = np.asarray(image, np.float32)
    ch = img[-1] * 255.0
    hh, ww = ch.shape
    nbh, nbw = hh // 8, ww // 8
    D = _dct_matrix()
    coef = D @ _blocks(ch, nbh, nbw) @ D.T
    v = coef[:, :, 2, 1] / _STRENGTH
    frac = v - np.floor(v)
    is_one = np.abs(frac - 0.5) < 0.25  # closer to the bit-1 lattice
    nbits = len(WATERMARK_BITS)
    idx = (np.arange(nbh * nbw) % nbits).reshape(nbh, nbw)
    votes_one = np.bincount(idx.ravel(), weights=is_one.ravel(),
                            minlength=nbits)
    counts = np.bincount(idx.ravel(), minlength=nbits)
    return (votes_one * 2 > counts).astype(int).tolist()
