"""The SVD temporal VAE decoder, NCHW.

Counterpart of neurons_tpu/models/temporal_ae.py (sgm's autoencoding/
temporal_ae.py): the SD VAE decoder whose every resnet block carries a
temporal res stack (`VideoVAEResBlock`), whose conv_out is followed by a
3-D time-mix conv (`AE3DConv`), and whose mid attention gains a temporal
transformer under time_mode 'all' or 'attn-only' (`VideoAttnBlock`).
Frames are folded into the batch, [(B T), C, H, W]; the temporal stacks
run `nn.Conv3d` on the [B, C, T, H, W] view. The mid block's spatial
attention (one head, d = the deepest width, every latent position) goes
through the dispatcher, so the flash kernel on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import VideoDecoderConfig
from neurons_tpu_torch.models.unet2d import timestep_embedding
from neurons_tpu_torch.models.vae import (Upsample, VAEAttnBlock,
                                          VAEResnetBlock)
from neurons_tpu_torch.models.video_unet import (AlphaBlender,
                                                 TemporalResBlock,
                                                 VideoTransformerBlock,
                                                 from_frames_seq,
                                                 from_video, to_frames_seq,
                                                 to_video)
from neurons_tpu_torch.ops.attention import dot_product_attention
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU


class VideoVAEResBlock(nn.Module):
    """VAE resnet + an emb-free temporal res stack + a scalar alpha blend.
    Here alpha weights the TEMPORAL branch (alpha * temporal + (1 - alpha)
    * spatial), the opposite of the UNet's AlphaBlender."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), groups: int = 32,
                 merge_strategy: str = "learned", alpha: float = 0.0):
        super().__init__()
        self.spatial = VAEResnetBlock(in_channels, out_channels, groups)
        self.time_stack = TemporalResBlock(out_channels, out_channels, kernel,
                                           groups)
        self.time_mixer = AlphaBlender(merge_strategy, alpha)

    def forward(self, x, num_frames: int):
        x = self.spatial(x)
        xt = from_video(self.time_stack(to_video(x, num_frames)))
        return self.time_mixer(xt, x)


class AE3DConv(nn.Module):
    """A 3x3 conv, then a 3-D time-mix conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_mix_conv = nn.Conv3d(out_channels, out_channels, kernel,
                                       padding=tuple(k // 2 for k in kernel))

    def forward(self, x, num_frames: int):
        return from_video(self.time_mix_conv(to_video(self.conv(x),
                                                      num_frames)))


class VideoAttnBlock(nn.Module):
    """The VAE mid attention with a temporal transformer mix: single-head
    spatial attention, then a frame-position-embedded temporal block,
    alpha-blended before the output projection."""

    def __init__(self, channels: int, groups: int = 32,
                 merge_strategy: str = "learned", alpha: float = 0.0):
        super().__init__()
        c = channels
        self.norm = GroupNorm(groups, c, 1e-6)
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.video_time_embed_0 = nn.Linear(c, c * 4)
        self.video_time_embed_2 = nn.Linear(c * 4, c)
        self.time_mix_block = VideoTransformerBlock(c, heads=1, dim_head=c,
                                                    ff_in=True)
        self.time_mixer = AlphaBlender(merge_strategy, alpha)
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, num_frames: int):
        bt, c, hh, ww = x.shape
        s = hh * ww
        t = self.norm(x).flatten(2).transpose(1, 2)          # [(B T), S, C]
        q, k, v = (lin(t)[:, None] for lin in (self.q, self.k, self.v))
        t = dot_product_attention(q, k, v)[:, 0]
        frames = torch.arange(num_frames, device=x.device).repeat(
            bt // num_frames)
        emb = timestep_embedding(frames, c).to(self.q.weight.dtype)
        emb = self.video_time_embed_2(F.silu(self.video_time_embed_0(emb)))
        mix = self.time_mix_block(to_frames_seq(
            t + emb[:, None, :].to(t.dtype), num_frames))
        t = self.time_mixer(t, from_frames_seq(mix, s))
        t = self.proj_out(t)
        return x + t.transpose(1, 2).reshape(bt, c, hh, ww)


class VideoDecoder(nn.Module):
    """z [(B T), C, h, w] latents -> frames [(B T), 3, H, W], for
    `num_frames` frames a clip. time_mode: 'all' (temporal convs and
    attention), 'conv-only' (SVD's), 'attn-only'."""

    def __init__(self, cfg: VideoDecoderConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        v = c.vae
        g = min(v.norm_num_groups, v.block_out_channels[0])
        self.conv_time = c.time_mode in ("all", "conv-only")
        attn_time = c.time_mode in ("all", "attn-only")
        kernel = tuple(c.video_kernel_size)

        def res(cin, cout):
            if c.time_mode == "attn-only":
                return VAEResnetBlock(cin, cout, g)
            return VideoVAEResBlock(cin, cout, kernel, g, c.merge_strategy,
                                    c.alpha)

        with torch.device(resolve_device(device)):
            ch = v.block_out_channels[-1]
            self.conv_in = nn.Conv2d(v.latent_channels, ch, 3, padding=1)
            self.mid_block_1 = res(ch, ch)
            self.mid_attn = (VideoAttnBlock(ch, g, c.merge_strategy, c.alpha)
                             if attn_time else VAEAttnBlock(ch, g))
            self.mid_block_2 = res(ch, ch)
            for i, out in enumerate(reversed(v.block_out_channels)):
                for j in range(v.layers_per_block + 1):
                    self.add_module(f"up_{i}_block_{j}", res(ch, out))
                    ch = out
                if i != len(v.block_out_channels) - 1:
                    self.add_module(f"up_{i}_upsample", Upsample(ch))
            self.norm_out = GroupNormSiLU(g, ch, 1e-6)
            self.conv_out = (AE3DConv(ch, v.out_channels, kernel)
                             if self.conv_time
                             else nn.Conv2d(ch, v.out_channels, 3, padding=1))
        self.to(dtype)

    @staticmethod
    def _block(block, h, num_frames):
        """A spatial-only block takes h alone, a temporal one the frames."""
        if isinstance(block, (VAEResnetBlock, VAEAttnBlock)):
            return block(h)
        return block(h, num_frames)

    def forward(self, z, num_frames: int):
        v = self.cfg.vae
        h = self.conv_in(z)
        for block in (self.mid_block_1, self.mid_attn, self.mid_block_2):
            h = self._block(block, h, num_frames)
        for i in range(len(v.block_out_channels)):
            for j in range(v.layers_per_block + 1):
                h = self._block(getattr(self, f"up_{i}_block_{j}"), h,
                                num_frames)
            if i != len(v.block_out_channels) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        h = self.norm_out(h)
        return (self.conv_out(h, num_frames) if self.conv_time
                else self.conv_out(h))
