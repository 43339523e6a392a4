"""DiffusionEngine: the sgm engine's inference surface over the port's
modules.

Counterpart of neurons_tpu/models/engine.py. The reference builds
`sgm.models.diffusion.DiffusionEngine` from unclip6.yaml and uses four of
its capabilities at inference: the conditioner, the denoiser, the sampler
and `decode_first_stage`. This bundles the port's unCLIP UNet and VAE
behind the same four, with `from_checkpoint` assembling both from the
unclip6 Lightning file (the EMA weights swapped in).

The modules run in their own parameter dtype (bf16 on the card); the
sampler state and every output stay f32. `sample` takes its start noise
and its random unconditional tokens as explicit tensors, or draws them
from a generator.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import SamplerConfig, UNet2DConfig, VAEConfig
from neurons_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from neurons_tpu_torch.diffusion.samplers import (make_cfg_denoiser,
                                                  sample_euler)
from neurons_tpu_torch.diffusion.schedule import sd_sigmas
from neurons_tpu_torch.models.conditioner import unclip_vector_suffix
from neurons_tpu_torch.models.unet2d import UNetModel
from neurons_tpu_torch.models.vae import AutoencoderKL


@dataclass
class DiffusionEngine:
    """`unet` and `vae` default to new modules of the configs on `device`
    in `dtype` (torch's initialisation; `init_random` or `from_checkpoint`
    give them weights)."""

    unet_cfg: UNet2DConfig = field(default_factory=UNet2DConfig)
    vae_cfg: VAEConfig = field(default_factory=VAEConfig)
    sampler_cfg: SamplerConfig = field(default_factory=SamplerConfig)
    unet: Optional[UNetModel] = None
    vae: Optional[AutoencoderKL] = None
    device: Any = "cuda"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        dev = resolve_device(self.device)
        if self.unet is None:
            self.unet = UNetModel(self.unet_cfg, device=dev, dtype=self.dtype)
        if self.vae is None:
            self.vae = AutoencoderKL(self.vae_cfg, device=dev,
                                     dtype=self.dtype)
        self.unet.eval()
        self.vae.eval()
        first = next(self.unet.parameters())
        self.device, self.dtype = first.device, first.dtype
        self.denoiser = DiscreteDenoiser.create_sd(device=self.device)
        self.import_report = None

    @classmethod
    def from_checkpoint(cls, ckpt_path: str,
                        unet_cfg: Optional[UNet2DConfig] = None,
                        vae_cfg: Optional[VAEConfig] = None,
                        sampler_cfg: Optional[SamplerConfig] = None,
                        use_ema: bool = True, device="cuda",
                        dtype: torch.dtype = torch.float32
                        ) -> "DiffusionEngine":
        """Assemble from the unclip6 Lightning checkpoint
        (`load_weights.load_unclip_engine`): the modules are built on the
        meta device and filled on `device` in `dtype`."""
        from neurons_tpu_torch.interop.from_jax import load_jax_params
        from neurons_tpu_torch.interop.load_weights import (
            load_unclip_engine, materialize)

        unet_cfg = unet_cfg or UNet2DConfig()
        vae_cfg = vae_cfg or VAEConfig()
        dev = resolve_device(device)
        up, vp, report = load_unclip_engine(ckpt_path, unet_cfg, vae_cfg,
                                            use_ema=use_ema)
        unet = materialize(functools.partial(UNetModel, unet_cfg), dev, dtype)
        load_jax_params(unet, up)
        del up
        vae = materialize(functools.partial(AutoencoderKL, vae_cfg), dev,
                          dtype)
        load_jax_params(vae, vp)
        eng = cls(unet_cfg=unet_cfg, vae_cfg=vae_cfg,
                  sampler_cfg=sampler_cfg or SamplerConfig(), unet=unet,
                  vae=vae, device=dev, dtype=dtype)
        eng.import_report = report
        return eng

    def init_random(self, seed: int = 0, host: bool = False) -> None:
        """Seeded random weights (`synth_params_`: no head is zero)."""
        from neurons_tpu_torch.utils.synth_init import synth_params_

        synth_params_(self.unet, seed=seed, host=host)
        synth_params_(self.vae, seed=seed + 1, host=host)

    # --- the reference's four inference capabilities -----------------------

    def conditioner(self, batch_size: int = 1, orig_size=(768, 768),
                    crop=(0, 0)) -> torch.Tensor:
        """The constant `vector` conditioning (the two
        ConcatTimestepEmbedderND embedders on a placeholder batch); outdim
        is adm_in_channels / (2 embedders x 2 scalars)."""
        return unclip_vector_suffix(batch_size, orig_size, crop,
                                    outdim=self.unet_cfg.adm_in_channels // 4,
                                    device=self.device)

    def network(self, x: torch.Tensor, t_cond: torch.Tensor,
                crossattn: torch.Tensor,
                vector: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The UNet in its own dtype on f32 inputs; f32 out."""
        dt = self.dtype
        return self.unet(x.to(dt), t_cond, crossattn.to(dt),
                         None if vector is None else vector.to(dt)).float()

    @torch.no_grad()
    def sample(self, crossattn: torch.Tensor,
               uc_crossattn: Optional[torch.Tensor] = None, shape=None,
               num_steps: Optional[int] = None,
               cfg_scale: Optional[float] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """EulerEDM with VanillaCFG. crossattn [B, 256, 1664] CLIP tokens;
        the unconditional tokens default to random ones (the reference's
        unclip_recon), drawn before the start noise. Returns first-stage
        latents [B, 4, h, w], f32."""
        scfg = self.sampler_cfg
        num_steps = num_steps or scfg.unclip_steps
        cfg_scale = (cfg_scale if cfg_scale is not None
                     else scfg.unclip_cfg_scale)
        crossattn = crossattn.to(self.device, torch.float32)
        b = crossattn.shape[0]
        if shape is None:
            shape = (b, self.unet_cfg.in_channels, 96, 96)
        if uc_crossattn is None:
            uc_crossattn = torch.randn(crossattn.shape, generator=generator,
                                       device=self.device)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=self.device)
        vector = self.conditioner(b)
        denoise = make_cfg_denoiser(
            self.denoiser, self.network,
            cond={"crossattn": crossattn, "vector": vector},
            uc={"crossattn": uc_crossattn.to(self.device, torch.float32),
                "vector": vector},
            scale=cfg_scale)
        sigmas = sd_sigmas(num_steps, device=self.device)
        return sample_euler(denoise, noise.to(self.device, torch.float32),
                            sigmas, prepare=True)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """z / scale_factor -> the VAE decode, in [-1, 1], f32."""
        return self.vae.decode(
            (z / self.unet_cfg.scale_factor).to(self.dtype)).float()

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """The VAE posterior's mode times scale_factor, f32."""
        return (self.vae.encode(x.to(self.dtype)).mode().float()
                * self.unet_cfg.scale_factor)
