"""SparseCtrl controlnet (AnimateDiff-SparseCtrl, latent condition).

Counterpart of neurons_tpu/models/sparse_controlnet.py: a copy of the
UNet3D down path whose noisy-sample input is zeroed, conditioned by a
per-frame sparse latent condition concatenated with its binary frame mask
and embedded by one conv (`cond_embedding`, the "simplified" latent mode
that stage 5 uses), with a 1x1 conv head per skip and for the mid block.
Its motion modules exist at every level, whatever
`motion_module_resolutions` says, with one temporal attention each. The
residuals come back in the folded [(B F), C, H, W] layout of
models/unet3d.py, scaled by `conditioning_scale`.

The RGB condition branch (`cond_in` / `cond_b*`) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import UNet3DConfig
from neurons_tpu_torch.models.unet3d import VideoEncoderMixin, fold


class SparseControlNetModel(VideoEncoderMixin, nn.Module):
    """forward(sample [B, 4, F, H, W], timesteps [B], text [B, 77, ctx],
    cond [B, Cc, F, H, W], cond_mask [B, 1, F, H, W], scale) ->
    (down residuals, one per UNet3D skip, mid residual)."""

    def __init__(self, cfg: UNet3DConfig, n_frames: int = 16,
                 conditioning_channels: int = 4, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        self.n_frames = n_frames
        with torch.device(resolve_device(device)):
            self._build_time_embedding()
            self.cond_embedding = nn.Conv2d(conditioning_channels + 1,
                                            c.block_out_channels[0], 3,
                                            padding=1)
            skips = self._build_down(("Temporal_Self",), gate_motion=False)
            for i, ch in enumerate(skips):
                self.add_module(f"controlnet_down_{i}",
                                nn.Conv2d(ch, ch, 1))
            ch = c.block_out_channels[-1]
            self.controlnet_mid = nn.Conv2d(ch, ch, 1)
        self.to(dtype)

    def forward(self, sample, timesteps, encoder_hidden_states,
                controlnet_cond, conditioning_mask,
                conditioning_scale: float = 1.0
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        temb = self._time_embedding(timesteps)
        # the noisy sample is zeroed (set_noisy_sample_input_to_zero)
        h = self.conv_in(torch.zeros_like(fold(sample)))
        cond = torch.cat([controlnet_cond, conditioning_mask], dim=1)
        h = h + self.cond_embedding(fold(cond))
        h, skips = self._down(h, temb, encoder_hidden_states)
        down = tuple(getattr(self, f"controlnet_down_{i}")(s)
                     * conditioning_scale for i, s in enumerate(skips))
        return down, self.controlnet_mid(h) * conditioning_scale
