"""AutoencoderKL — the SD first-stage VAE, NCHW.

Counterpart of neurons_tpu/models/vae.py: ch 128, ch_mult (1, 2, 4, 4),
2 res blocks a level, mid-block attention (one head, d=512, over every
latent position: 9216 tokens for the 96x96 keyframe latents, 4096 for the
64x64 blurry frames; through the dispatcher, so the flash kernel on the
card), double_z encoder. GroupNorm eps 1e-6 throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import VAEConfig
from neurons_tpu_torch.ops.attention import dot_product_attention
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNormSiLU(groups, in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNormSiLU(groups, out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head full attention over the spatial positions."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).flatten(2).transpose(1, 2)          # [B, HW, C]
        q, k, v = (lin(t)[:, None] for lin in (self.q, self.k, self.v))
        out = self.proj_out(dot_product_attention(q, k, v)[:, 0])
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    """Asymmetric (0, 1, 0, 1) pad, then a stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = c = cfg
        g = min(c.norm_num_groups, c.block_out_channels[0])
        self.conv_in = nn.Conv2d(c.in_channels, c.block_out_channels[0], 3,
                                 padding=1)
        prev = c.block_out_channels[0]
        for i, ch in enumerate(c.block_out_channels):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_block_{j}",
                                VAEResnetBlock(prev, ch, g))
                prev = ch
            if i != len(c.block_out_channels) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
        self.mid_block_1 = VAEResnetBlock(prev, prev, g)
        self.mid_attn = VAEAttnBlock(prev, g)
        self.mid_block_2 = VAEResnetBlock(prev, prev, g)
        self.norm_out = GroupNormSiLU(g, prev, 1e-6)
        self.conv_out = nn.Conv2d(prev, 2 * c.latent_channels, 3, padding=1)

    def forward(self, x):
        c = self.cfg
        h = self.conv_in(x)
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(c.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = c = cfg
        g = min(c.norm_num_groups, c.block_out_channels[0])
        prev = c.block_out_channels[-1]
        self.conv_in = nn.Conv2d(c.latent_channels, prev, 3, padding=1)
        self.mid_block_1 = VAEResnetBlock(prev, prev, g)
        self.mid_attn = VAEAttnBlock(prev, g)
        self.mid_block_2 = VAEResnetBlock(prev, prev, g)
        for i, ch in enumerate(reversed(c.block_out_channels)):
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}",
                                VAEResnetBlock(prev, ch, g))
                prev = ch
            if i != len(c.block_out_channels) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        self.norm_out = GroupNormSiLU(g, prev, 1e-6)
        self.conv_out = nn.Conv2d(prev, c.out_channels, 3, padding=1)

    def forward(self, z):
        c = self.cfg
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(z))))
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != len(c.block_out_channels) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(self.norm_out(h))


class DiagonalGaussian(NamedTuple):
    """Posterior q(z|x): the mean/logvar split of the encoder moments."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        std = torch.exp(0.5 * self.logvar.clamp(-30.0, 20.0))
        eps = torch.randn(self.mean.shape, generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + std * eps

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """encode(x) -> DiagonalGaussian (x NCHW in [-1, 1]); decode(z) -> x."""

    def __init__(self, cfg: VAEConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
            self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        self.to(dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        posterior = self.encode(x)
        z = posterior.mode() if generator is None else posterior.sample(
            generator)
        return self.decode(z), posterior
