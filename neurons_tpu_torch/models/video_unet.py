"""The SVD spatiotemporal UNet (`VideoUNet`), NCHW.

Counterpart of neurons_tpu/models/video_unet.py (sgm's video_model.py
`VideoUNet`/`VideoResBlock`, video_attention.py `VideoTransformerBlock`/
`SpatialVideoTransformer`, and `AlphaBlender`). Frames are folded into the
batch, [(B T), C, H, W], as at the JAX package's boundary:

  * spatial compute reuses the port's UNet2D blocks (`ResBlock`,
    `BasicTransformerBlock`, `CrossAttention`, `GEGLUFeedForward`,
    `Downsample2D`, `UpsampleConv`) where the JAX file reuses the JAX ones;
  * the temporal res stacks view the batch as [B, C, T, H, W] and run
    `nn.Conv3d` (kernel (3, 1, 1) in the UNet), the channels of each
    GroupNorm grouped over (T, H, W) together, as the JAX NDHWC GroupNorm
    groups them;
  * temporal attention runs on the per-pixel [(B S), T, C] view.

Every attention goes through ops.attention.dot_product_attention: the
spatial self-attention of 128 tokens or more (latent grids from 12x12 up)
takes the flash kernel on the card; the cross-attention over the one
CLIP-H token and the temporal attention over the frames stay on the plain
path, as the JAX package routes them to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import VideoUNetConfig
from neurons_tpu_torch.models.unet2d import (BasicTransformerBlock,
                                             CrossAttention, Downsample2D,
                                             GEGLUFeedForward, ResBlock,
                                             UpsampleConv, timestep_embedding)
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU


def to_video(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[(B T), C, H, W] -> [B, C, T, H, W]."""
    bt = x.shape[0]
    return x.reshape(bt // num_frames, num_frames,
                     *x.shape[1:]).transpose(1, 2)


def from_video(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [(B T), C, H, W]."""
    b, c, t = x.shape[:3]
    return x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])


def to_frames_seq(t: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Tokens [(B T), S, C] -> per-pixel frame sequences [(B S), T, C]."""
    bt, s, c = t.shape
    return t.reshape(bt // num_frames, num_frames, s, c).transpose(
        1, 2).reshape(-1, num_frames, c)


def from_frames_seq(t: torch.Tensor, s: int) -> torch.Tensor:
    """[(B S), T, C] -> [(B T), S, C]."""
    bs, nf, c = t.shape
    return t.reshape(bs // s, s, nf, c).transpose(1, 2).reshape(-1, s, c)


class AlphaBlender(nn.Module):
    """alpha * x_spatial + (1 - alpha) * x_temporal on frame-folded
    tensors [(B T), ...]. 'learned_with_images' forces alpha = 1 (pure
    spatial) on the frames `image_only_indicator` [B, T] flags as stills;
    the learned alpha is the sigmoid of `mix_factor` taken in f32, cast to
    the inputs' type."""

    def __init__(self, merge_strategy: str = "learned_with_images",
                 alpha: float = 0.5):
        super().__init__()
        if merge_strategy not in ("fixed", "learned", "learned_with_images"):
            raise ValueError(merge_strategy)
        self.merge_strategy, self.alpha = merge_strategy, alpha
        if merge_strategy != "fixed":
            self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                image_only_indicator: Optional[torch.Tensor] = None):
        if self.merge_strategy == "fixed":
            alpha = torch.tensor(self.alpha, dtype=x_spatial.dtype,
                                 device=x_spatial.device)
        else:
            alpha = torch.sigmoid(self.mix_factor.float())[0]
            if self.merge_strategy == "learned_with_images":
                if image_only_indicator is None:
                    raise ValueError("learned_with_images needs "
                                     "image_only_indicator [B, T]")
                alpha = torch.where(image_only_indicator.bool(),
                                    torch.ones_like(alpha), alpha)
                alpha = alpha.reshape((-1,) + (1,) * (x_spatial.dim() - 1))
            alpha = alpha.to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class TemporalResBlock(nn.Module):
    """The `time_stack` res block on [B, C, T, H, W]: GN+SiLU -> 3-D conv ->
    (+ per-frame emb) -> GN+SiLU -> 3-D conv, residual (1x1x1 skip conv
    where the widths differ). emb: [B, T, E] or None."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 1, 1), groups: int = 32,
                 emb_dim: int = 0, eps: float = 1e-5):
        super().__init__()
        pad = tuple(k // 2 for k in kernel)
        self.in_norm = GroupNormSiLU(groups, in_channels, eps)
        self.in_conv = nn.Conv3d(in_channels, out_channels, kernel,
                                 padding=pad)
        if emb_dim:
            self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = GroupNormSiLU(groups, out_channels, eps)
        self.out_conv = nn.Conv3d(out_channels, out_channels, kernel,
                                  padding=pad)
        if in_channels != out_channels:
            self.skip_conv = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x, emb=None):
        h = self.in_conv(self.in_norm(x))
        if hasattr(self, "emb_proj"):
            e = self.emb_proj(F.silu(emb))  # [B, T, C]
            h = h + e.transpose(1, 2)[..., None, None].to(h.dtype)
        h = self.out_conv(self.out_norm(h))
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return x + h


class VideoResBlock(nn.Module):
    """The spatial ResBlock, a temporal res stack on its output, and the
    alpha blend of the two."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 kernel: Tuple[int, int, int] = (3, 1, 1), groups: int = 32,
                 merge_strategy: str = "learned_with_images",
                 merge_factor: float = 0.5):
        super().__init__()
        self.spatial = ResBlock(in_channels, out_channels, emb_dim, groups)
        self.time_stack = TemporalResBlock(out_channels, out_channels,
                                           kernel, groups, emb_dim)
        self.time_mixer = AlphaBlender(merge_strategy, merge_factor)

    def forward(self, x, emb, num_frames: int, image_only_indicator=None):
        x = self.spatial(x, emb)
        xt = self.time_stack(to_video(x, num_frames),
                             emb.reshape(-1, num_frames, emb.shape[-1]))
        return self.time_mixer(x, from_video(xt), image_only_indicator)


class VideoTransformerBlock(nn.Module):
    """Temporal transformer block over per-pixel frame sequences [(B S), T,
    C]: optional ff_in, temporal self-attention, temporal cross-attention
    on `context` (self-attention where there is none), GEGLU FF, each
    pre-norm residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int = 0, ff_in: bool = False,
                 disable_temporal_crossattention: bool = False,
                 switch_temporal_ca_to_sa: bool = False):
        super().__init__()
        self.switch_temporal_ca_to_sa = switch_temporal_ca_to_sa
        if ff_in:
            self.norm_in = nn.LayerNorm(dim, eps=1e-5)
            self.ff_in = GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        if not disable_temporal_crossattention:
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(dim, heads, dim_head,
                                        context_dim or None)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context=None):
        if hasattr(self, "ff_in"):
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        if hasattr(self, "attn2"):
            ctx = None if self.switch_temporal_ca_to_sa else context
            x = self.attn2(self.norm2(x), ctx) + x
        return self.ff(self.norm3(x)) + x


class SpatialVideoTransformer(nn.Module):
    """The spatial transformer with an interleaved temporal mix stack: per
    depth, a BasicTransformerBlock over the frame's tokens, then a
    VideoTransformerBlock over each pixel's frames (with a sinusoidal
    frame-position MLP added), alpha-blended; one `time_mixer` serves every
    depth."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, time_context_dim: int = 0,
                 use_spatial_context: bool = True,
                 merge_strategy: str = "learned_with_images",
                 merge_factor: float = 0.5, ff_in: bool = False,
                 disable_temporal_crossattention: bool = False,
                 max_time_embed_period: int = 10000, groups: int = 32):
        super().__init__()
        c = channels
        self.depth, self.use_spatial_context = depth, use_spatial_context
        self.max_time_embed_period = max_time_embed_period
        time_ctx_dim = context_dim if use_spatial_context else time_context_dim
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = nn.Linear(c, c)
        self.time_pos_embed_0 = nn.Linear(c, c * 4)
        self.time_pos_embed_2 = nn.Linear(c * 4, c)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                c, heads, dim_head, context_dim))
            self.add_module(f"time_stack_{i}", VideoTransformerBlock(
                c, heads, dim_head, context_dim=time_ctx_dim, ff_in=ff_in,
                disable_temporal_crossattention=(
                    disable_temporal_crossattention)))
        self.time_mixer = AlphaBlender(merge_strategy, merge_factor)
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, context, num_frames: int, time_context=None,
                image_only_indicator=None):
        bt, c, hh, ww = x.shape
        s = hh * ww
        b = bt // num_frames
        if self.use_spatial_context:
            # the first frame's context, repeated for every pixel
            time_context = context[::num_frames].repeat_interleave(s, dim=0)
        elif time_context is not None:
            if time_context.dim() == 2:
                time_context = time_context[:, None, :]
            time_context = time_context.repeat_interleave(s, dim=0)
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        frames = torch.arange(num_frames, device=x.device).repeat(b)
        emb = timestep_embedding(frames, c,
                                 max_period=self.max_time_embed_period)
        emb = self.time_pos_embed_0(emb.to(self.proj_in.weight.dtype))
        emb = self.time_pos_embed_2(F.silu(emb))[:, None, :].to(t.dtype)
        for i in range(self.depth):
            t = getattr(self, f"block_{i}")(t, context)
            mix = getattr(self, f"time_stack_{i}")(
                to_frames_seq(t + emb, num_frames), time_context)
            t = self.time_mixer(t, from_frames_seq(mix, s),
                                image_only_indicator)
        t = self.proj_out(t)
        return t.transpose(1, 2).reshape(bt, c, hh, ww) + x


class VideoUNet(nn.Module):
    """x [(B T), C, H, W], timesteps [(B T)], context [(B T), Tk,
    context_dim], y [(B T), adm_in_channels] or None, num_frames T,
    image_only_indicator [B, T] or None (all video) -> [(B T), out, H, W].
    Time embedding (+ the adm vector), input blocks (VideoResBlock and, at
    the attention resolutions, SpatialVideoTransformer), the middle, the
    skip-concatenating output blocks, GN+SiLU and the output conv."""

    def __init__(self, cfg: VideoUNetConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        mc = c.model_channels
        ted = mc * 4
        groups = 32 if mc % 32 == 0 else mc
        kernel = tuple(c.video_kernel_size)

        def res(cin, cout):
            return VideoResBlock(cin, cout, ted, kernel, groups,
                                 c.merge_strategy, c.merge_factor)

        def attn(ch, depth):
            return SpatialVideoTransformer(
                ch, ch // c.num_head_channels, c.num_head_channels, depth,
                c.context_dim, time_context_dim=c.time_context_dim,
                use_spatial_context=c.use_spatial_context,
                merge_strategy=c.merge_strategy,
                merge_factor=c.merge_factor, ff_in=c.extra_ff_mix_layer,
                disable_temporal_crossattention=(
                    c.disable_temporal_crossattention),
                max_time_embed_period=c.max_ddpm_temb_period, groups=groups)

        with torch.device(resolve_device(device)):
            self.time_embed_0 = nn.Linear(mc, ted)
            self.time_embed_2 = nn.Linear(ted, ted)
            if c.adm_in_channels > 0:
                self.label_emb_0 = nn.Linear(c.adm_in_channels, ted)
                self.label_emb_2 = nn.Linear(ted, ted)
            self.conv_in = nn.Conv2d(c.in_channels, mc, 3, padding=1)
            ch, skips, ds = mc, [mc], 1
            for level, mult in enumerate(c.channel_mult):
                out = mc * mult
                for i in range(c.num_res_blocks):
                    self.add_module(f"down_{level}_res_{i}", res(ch, out))
                    ch = out
                    if ds in c.attention_resolutions:
                        self.add_module(f"down_{level}_attn_{i}", attn(
                            ch, c.transformer_depth[level]))
                    skips.append(ch)
                if level != len(c.channel_mult) - 1:
                    self.add_module(f"down_{level}_downsample",
                                    Downsample2D(ch))
                    skips.append(ch)
                    ds *= 2
            self.mid_res_0 = res(ch, ch)
            self.mid_attn = attn(ch, c.transformer_depth[-1])
            self.mid_res_1 = res(ch, ch)
            for level, mult in reversed(list(enumerate(c.channel_mult))):
                out = mc * mult
                for i in range(c.num_res_blocks + 1):
                    self.add_module(f"up_{level}_res_{i}",
                                    res(ch + skips.pop(), out))
                    ch = out
                    if ds in c.attention_resolutions:
                        self.add_module(f"up_{level}_attn_{i}", attn(
                            ch, c.transformer_depth[level]))
                    if level and i == c.num_res_blocks:
                        self.add_module(f"up_{level}_upsample",
                                        UpsampleConv(ch))
                        ds //= 2
            self.out_norm = GroupNormSiLU(groups, mc, 1e-5)
            self.out_conv = nn.Conv2d(mc, c.out_channels, 3, padding=1)
        self.to(dtype)

    def forward(self, x, timesteps, context, y=None, num_frames: int = 1,
                image_only_indicator: Optional[torch.Tensor] = None):
        c = self.cfg
        if image_only_indicator is None:
            image_only_indicator = torch.zeros(
                (x.shape[0] // num_frames, num_frames), device=x.device)
        dtype = self.conv_in.weight.dtype
        emb = self.time_embed_0(timestep_embedding(
            timesteps, c.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if y is not None:
            emb = emb + self.label_emb_2(F.silu(self.label_emb_0(y)))
        emb = emb.to(x.dtype)

        def res(name, h):
            return getattr(self, name)(h, emb, num_frames,
                                       image_only_indicator)

        def attn(name, h):
            site = getattr(self, name, None)
            if site is None:
                return h
            return site(h, context, num_frames,
                        image_only_indicator=image_only_indicator)

        h = self.conv_in(x)
        skips = [h]
        for level in range(len(c.channel_mult)):
            for i in range(c.num_res_blocks):
                h = attn(f"down_{level}_attn_{i}",
                         res(f"down_{level}_res_{i}", h))
                skips.append(h)
            if level != len(c.channel_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)
        h = res("mid_res_1", attn("mid_attn", res("mid_res_0", h)))
        for level in reversed(range(len(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = attn(f"up_{level}_attn_{i}", res(f"up_{level}_res_{i}", h))
                if level and i == c.num_res_blocks:
                    h = getattr(self, f"up_{level}_upsample")(h)
        return self.out_conv(self.out_norm(h))
