"""SparseCtrl controlnet (AnimateDiff-SparseCtrl, latent or RGB condition).

Counterpart of neurons_tpu/models/sparse_controlnet.py: a copy of the
UNet3D down path whose noisy-sample input is zeroed, conditioned by a
per-frame sparse condition concatenated with its binary frame mask, with a
1x1 conv head per skip and for the mid block. The condition is embedded

  * by one conv (`cond_embedding`) in the "simplified" latent mode that
    stage 5 uses (`use_simplified_condition_embedding=True`), or
  * for an RGB condition at pixel resolution, by `cond_in` (16 channels),
    then `cond_b{i}a` / `cond_b{i}b` (the second of each pair with stride
    2) through widths 16, 32, 96, 256, and a conv `cond_out` to the first
    block's width: three halvings take the pixels to the latent grid.

Its motion modules exist at every level, whatever
`motion_module_resolutions` says, with one temporal attention each. The
residuals come back in the folded [(B F), C, H, W] layout of
models/unet3d.py, scaled by `conditioning_scale`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import UNet3DConfig
from neurons_tpu_torch.models.unet3d import VideoEncoderMixin, fold

# the RGB condition embedding's widths
COND_WIDTHS = (16, 32, 96, 256)


class SparseControlNetModel(VideoEncoderMixin, nn.Module):
    """forward(sample [B, 4, F, H, W], timesteps [B], text [B, 77, ctx],
    cond [B, Cc, F, H', W'], cond_mask [B, 1, F, H', W'], scale) ->
    (down residuals, one per UNet3D skip, mid residual). H' = H for the
    latent condition, 8 H for the RGB one."""

    def __init__(self, cfg: UNet3DConfig, n_frames: int = 16,
                 conditioning_channels: int = 4,
                 use_simplified_condition_embedding: bool = True,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        self.n_frames = n_frames
        self.simplified = use_simplified_condition_embedding
        ch0, cin = c.block_out_channels[0], conditioning_channels + 1
        with torch.device(resolve_device(device)):
            self._build_time_embedding()
            if self.simplified:
                self.cond_embedding = nn.Conv2d(cin, ch0, 3, padding=1)
            else:
                w = COND_WIDTHS
                self.cond_in = nn.Conv2d(cin, w[0], 3, padding=1)
                for i in range(len(w) - 1):
                    self.add_module(f"cond_b{i}a",
                                    nn.Conv2d(w[i], w[i], 3, padding=1))
                    self.add_module(f"cond_b{i}b", nn.Conv2d(
                        w[i], w[i + 1], 3, stride=2, padding=1))
                self.cond_out = nn.Conv2d(w[-1], ch0, 3, padding=1)
            skips = self._build_down(("Temporal_Self",), gate_motion=False)
            for i, ch in enumerate(skips):
                self.add_module(f"controlnet_down_{i}",
                                nn.Conv2d(ch, ch, 1))
            ch = c.block_out_channels[-1]
            self.controlnet_mid = nn.Conv2d(ch, ch, 1)
        self.to(dtype)

    def embed_condition(self, cond: torch.Tensor) -> torch.Tensor:
        """Folded condition and mask [(B F), Cc + 1, H', W'] -> the first
        block's width on the latent grid."""
        if self.simplified:
            return self.cond_embedding(cond)
        e = F.silu(self.cond_in(cond))
        for i in range(len(COND_WIDTHS) - 1):
            e = F.silu(getattr(self, f"cond_b{i}a")(e))
            e = F.silu(getattr(self, f"cond_b{i}b")(e))
        return self.cond_out(e)

    def forward(self, sample, timesteps, encoder_hidden_states,
                controlnet_cond, conditioning_mask,
                conditioning_scale: float = 1.0
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        temb = self._time_embedding(timesteps)
        # the noisy sample is zeroed (set_noisy_sample_input_to_zero)
        h = self.conv_in(torch.zeros_like(fold(sample)))
        cond = torch.cat([controlnet_cond, conditioning_mask], dim=1)
        h = h + self.embed_condition(fold(cond))
        h, skips = self._down(h, temb, encoder_hidden_states)
        h = self._mid(h, temb, encoder_hidden_states)
        down = tuple(getattr(self, f"controlnet_down_{i}")(s)
                     * conditioning_scale for i, s in enumerate(skips))
        return down, self.controlnet_mid(h) * conditioning_scale
