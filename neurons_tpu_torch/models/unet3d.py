"""AnimateDiff video UNet (UNet3D with temporal motion modules), folded NCHW.

Counterpart of neurons_tpu/models/unet3d.py: an SD-1.5 UNet inflated to
video. Activations live as [(B F), C, H, W] throughout, so the inflated
convolutions and GroupNorms are the per-frame 2-D ones; only attention
reshapes:

  * spatial (`Transformer3D`): tokens [(B F), H*W, C] per frame, the text
    context repeated per frame; through ops.attention.dot_product_attention
    (the flash kernel on the card at 1024 and 256 tokens, the plain version
    below 128 tokens and for the 77-token cross-attention);
  * temporal (`MotionModule`): the [(B F), H*W, C] tokens attend across F
    per pixel through ops.temporal_attention (csrc/temporal_attn_fwd.cu on
    the card), with the interleaved sin/cos positional encoding added per
    frame.

Heads: `ch // attention_head_dim if attention_head_dim > 8 else
attention_head_dim` (8 at every level at full width); motion modules use
`motion_num_attention_heads`. eps: 1e-6 for the motion-module and
Transformer3D GroupNorms, 1e-5 for the res blocks, conv_norm_out and every
LayerNorm. The JAX package's MHAttention and GEGLU_FF are
models/unet2d.py's CrossAttention and GEGLUFeedForward here (the same
parameter names; GEGLU uses exact GELU).

Both norm/conv pairs of every ResnetBlock3D (SparseCtrl's included) go
through ops.fused_conv.norm_silu_conv: the fused CUDA kernel with
NEURONS_TPU_FUSED_GNCONV=1, as the JAX res block routes them.

`UNet3DModel.forward` carries the JAX UNet3D's hooks for the fast
samplers: the encoder cache (`cached` / `return_cache`: the down path's
features before the mid block, for encoder reuse), and the attention
residuals by site name: cross (`capture_xattn` / `xattn_cached`, TGATE
and PAB), spatial self (`capture_sattn` / `sattn_cached`) and temporal
(`capture_tattn` / `tattn_cached`, PAB). A cached residual replaces its
pre-norm attention branch; a motion module's feed-forward still runs. The
motion modules' `Temporal_Cross` attention is never given a context in the
JAX package, so every attention block here is temporal self-attention.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import UNet3DConfig
from neurons_tpu_torch.models.unet2d import (CrossAttention,
                                             GEGLUFeedForward,
                                             timestep_embedding)
from neurons_tpu_torch.ops.fused_conv import norm_silu_conv
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU
from neurons_tpu_torch.ops.temporal_attention import temporal_attention

def temporal_pos_encoding(max_len: int, dim: int,
                          device=None) -> torch.Tensor:
    """Interleaved sin/cos, f32 [max_len, dim]: pe[:, 0::2] = sin,
    pe[:, 1::2] = cos."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div[: dim // 2])
    return pe


def spatial_heads(cfg: UNet3DConfig, ch: int) -> int:
    """Transformer3D heads at `ch` channels (the reference's rule)."""
    a = cfg.attention_head_dim
    return ch // a if a > 8 else a


class TemporalMHA(nn.Module):
    """Temporal self-attention in the folded [(B F), D, C] layout: the
    projections feed the temporal-attention op in place."""

    def __init__(self, dim: int, heads: int, n_frames: int):
        super().__init__()
        self.heads, self.n_frames = heads, n_frames
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, t):
        hd = t.shape[-1] // self.heads
        out = temporal_attention(self.to_q(t), self.to_k(t), self.to_v(t),
                                 self.n_frames, self.heads, hd ** -0.5)
        return self.to_out(out)


class MotionModule(nn.Module):
    """VanillaTemporalModule: GroupNorm -> proj_in -> blocks of [LayerNorm
    -> temporal attention -> residual] and [LayerNorm -> GEGLU FF ->
    residual] -> proj_out -> residual. Input [(B F), C, H, W]."""

    def __init__(self, channels: int, n_frames: int, heads: int = 8,
                 num_blocks: int = 1,
                 attention_block_types: Sequence[str] = ("Temporal_Self",
                                                         "Temporal_Self"),
                 max_seq_len: int = 32, groups: int = 32):
        super().__init__()
        c = channels
        self.n_frames, self.num_blocks = n_frames, num_blocks
        self.n_attn = len(attention_block_types)
        self.norm = GroupNorm(min(groups, c), c, 1e-6)
        self.proj_in = nn.Linear(c, c)
        for blk in range(num_blocks):
            for ai in range(self.n_attn):
                name = f"block_{blk}_attn_{ai}"
                self.add_module(f"{name}_norm", nn.LayerNorm(c, eps=1e-5))
                self.add_module(name, TemporalMHA(c, heads, n_frames))
            self.add_module(f"block_{blk}_ff_norm", nn.LayerNorm(c, eps=1e-5))
            self.add_module(f"block_{blk}_ff", GEGLUFeedForward(c))
        self.proj_out = nn.Linear(c, c)
        # computed in f32, cast with the module (the activation dtype)
        self.register_buffer("pe", temporal_pos_encoding(max_seq_len, c),
                             persistent=False)

    def init_buffers(self) -> None:
        """Recompute `pe` where it lives (a module built on the meta device
        and materialised with `to_empty` holds uninitialised buffers)."""
        self.pe = temporal_pos_encoding(*self.pe.shape, device=self.pe.device
                                        ).to(self.pe.dtype)

    def forward(self, x, tattn_cached=None, capture_tattn: bool = False):
        """out, or (out, residuals stacked over the attention blocks,
        [n_attn, (B F), H*W, C]) with `capture_tattn`. `tattn_cached`
        (that stack) replaces each attention block's residual."""
        bf, c, hh, ww = x.shape
        f, d = self.n_frames, hh * ww
        tokens = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        pe = self.pe[:f].to(x.dtype)[None, :, None, :]
        captured, t_idx = [], 0
        for blk in range(self.num_blocks):
            for ai in range(self.n_attn):
                name = f"block_{blk}_attn_{ai}"
                if tattn_cached is not None:
                    tattn = tattn_cached[t_idx]
                else:
                    t = getattr(self, f"{name}_norm")(tokens)
                    # pe[frame] added in the folded layout
                    t = (t.reshape(bf // f, f, d, c) + pe).reshape(bf, d, c)
                    tattn = getattr(self, name)(t)
                if capture_tattn:
                    captured.append(tattn)
                t_idx += 1
                tokens = tattn + tokens
            t = getattr(self, f"block_{blk}_ff_norm")(tokens)
            tokens = getattr(self, f"block_{blk}_ff")(t) + tokens
        out = self.proj_out(tokens)
        out = out.transpose(1, 2).reshape(bf, c, hh, ww) + x
        return (out, torch.stack(captured)) if capture_tattn else out


class ResnetBlock3D(nn.Module):
    """Per-frame resnet: GN+SiLU -> conv1 -> + time embedding -> GN+SiLU ->
    conv2, plus a 1x1 conv shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNormSiLU(min(groups, in_channels), in_channels, 1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(emb_dim, out_channels)
        self.norm2 = GroupNormSiLU(min(groups, out_channels), out_channels,
                                   1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, emb):
        h = norm_silu_conv(self.norm1, self.conv1, x)
        h = h + self.time_emb_proj(F.silu(emb))[:, :, None, None]
        h = norm_silu_conv(self.norm2, self.conv2, h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Transformer3D(nn.Module):
    """Per-frame spatial transformer: GN -> proj_in -> depth x [self-attn,
    text cross-attn, GEGLU FF] -> proj_out -> residual. The context
    [B, 77, ctx] is shared by the frames of its clip; its K/V projections
    are formed once per clip and repeated per frame (the same rows as
    projecting the repeated context)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 n_frames: int, depth: int = 1, groups: int = 32):
        super().__init__()
        c = channels
        self.n_frames, self.depth = n_frames, depth
        self.norm = GroupNorm(min(groups, c), c, 1e-6)
        self.proj_in = nn.Linear(c, c)
        for i in range(depth):
            self.add_module(f"block_{i}_norm1", nn.LayerNorm(c, eps=1e-5))
            self.add_module(f"block_{i}_attn1",
                            CrossAttention(c, heads, c // heads))
            self.add_module(f"block_{i}_norm2", nn.LayerNorm(c, eps=1e-5))
            self.add_module(f"block_{i}_attn2", CrossAttention(
                c, heads, c // heads, context_dim))
            self.add_module(f"block_{i}_norm3", nn.LayerNorm(c, eps=1e-5))
            self.add_module(f"block_{i}_ff", GEGLUFeedForward(c))
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, context, xattn_cached=None, capture: bool = False,
                sattn_cached=None, capture_sattn: bool = False):
        """out, or (out, xattn, sattn) for what is captured, each stacked
        over depth, [depth, (B F), H*W, C]. A cached residual replaces its
        branch (the context is unused under `xattn_cached`)."""
        bf, c, hh, ww = x.shape
        tokens = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        captured, captured_s = [], []
        for i in range(self.depth):
            blk = f"block_{i}"
            if sattn_cached is not None:
                sattn = sattn_cached[i]
            else:
                t = getattr(self, f"{blk}_norm1")(tokens)
                sattn = getattr(self, f"{blk}_attn1")(t)
            captured_s.append(sattn)
            tokens = sattn + tokens
            if xattn_cached is not None:
                xattn = xattn_cached[i]
            else:
                attn2 = getattr(self, f"{blk}_attn2")
                kv = tuple(lin(context).repeat_interleave(self.n_frames,
                                                          dim=0)
                           for lin in (attn2.to_k, attn2.to_v))
                t = getattr(self, f"{blk}_norm2")(tokens)
                xattn = attn2(t, kv=kv)
            captured.append(xattn)
            tokens = xattn + tokens
            t = getattr(self, f"{blk}_norm3")(tokens)
            tokens = getattr(self, f"{blk}_ff")(t) + tokens
        out = self.proj_out(tokens)
        out = out.transpose(1, 2).reshape(bf, c, hh, ww) + x
        extras = tuple(torch.stack(c) for c, on in
                       ((captured, capture), (captured_s, capture_sattn))
                       if on)
        return (out,) + extras if extras else out


def video_cross_attn_sites(cfg: UNet3DConfig):
    """[(site_name, depth)] of every Transformer3D of `UNet3DModel` in call
    order."""
    sites = []
    for i, btype in enumerate(cfg.down_block_types):
        if btype.startswith("CrossAttn"):
            sites += [(f"down_{i}_attn_{j}", 1)
                      for j in range(cfg.layers_per_block)]
    sites.append(("mid_attn", 1))
    for i, btype in enumerate(cfg.up_block_types):
        if btype.startswith("CrossAttn"):
            sites += [(f"up_{i}_attn_{j}", 1)
                      for j in range(cfg.layers_per_block + 1)]
    return sites


def video_motion_sites(cfg: UNet3DConfig) -> List[str]:
    """Names of every MotionModule of `UNet3DModel` in call order (only at
    `motion_module_resolutions`)."""
    sites = []
    res = 1
    for i in range(len(cfg.down_block_types)):
        for j in range(cfg.layers_per_block):
            if cfg.use_motion_module and res in cfg.motion_module_resolutions:
                sites.append(f"down_{i}_motion_{j}")
        if i != len(cfg.down_block_types) - 1:
            res *= 2
    for i in range(len(cfg.up_block_types)):
        for j in range(cfg.layers_per_block + 1):
            if cfg.use_motion_module and res in cfg.motion_module_resolutions:
                sites.append(f"up_{i}_motion_{j}")
        if i != len(cfg.up_block_types) - 1:
            res //= 2
    return sites


class AttnHooks:
    """One forward's attention hooks: the cached residuals by site name and
    kind ("x" cross, "s" spatial self, "t" temporal), which kinds to
    capture, and the captures by kind and site name."""

    KINDS = ("x", "s", "t")

    def __init__(self, cached=None, capture=()):
        self.cached = cached or {}
        self.capture = set(capture)
        self.out = {k: {} for k in self.capture}

    def attn(self, site: "Transformer3D", name: str, h, context):
        def cached(kind):
            c = self.cached.get(kind)
            return None if c is None else c[name]
        out = site(h, context, xattn_cached=cached("x"),
                   capture="x" in self.capture, sattn_cached=cached("s"),
                   capture_sattn="s" in self.capture)
        if not ({"x", "s"} & self.capture):
            return out
        h, *rest = out
        for kind in ("x", "s"):
            if kind in self.capture:
                self.out[kind][name] = rest.pop(0)
        return h

    def motion(self, module: "MotionModule", name: str, h):
        c = self.cached.get("t")
        out = module(h, tattn_cached=None if c is None else c[name],
                     capture_tattn="t" in self.capture)
        if "t" not in self.capture:
            return out
        h, self.out["t"][name] = out
        return h


NO_HOOKS = AttnHooks()


def fold(x: torch.Tensor) -> torch.Tensor:
    """[B, C, F, H, W] -> [(B F), C, H, W]."""
    b, c, f, h, w = x.shape
    return x.transpose(1, 2).reshape(b * f, c, h, w)


def unfold(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[(B F), C, H, W] -> [B, C, F, H, W]."""
    bf, c, h, w = x.shape
    return x.reshape(bf // n_frames, n_frames, c, h, w).transpose(1, 2)


class VideoEncoderMixin:
    """The time embedding, attention sites and down path UNet3DModel and
    SparseControlNetModel share (same submodule names). Needs `cfg` and
    `n_frames` set before the `_build_*` methods run."""

    def _build_time_embedding(self):
        c = self.cfg
        ted = c.block_out_channels[0] * 4
        self.time_emb_1 = nn.Linear(c.block_out_channels[0], ted)
        self.time_emb_2 = nn.Linear(ted, ted)
        self.conv_in = nn.Conv2d(c.in_channels, c.block_out_channels[0], 3,
                                 padding=1)

    def _add_sites(self, where: str, j: int, ch: int, cross: bool,
                   motion_types):
        """`{where}_attn_{j}` (a Transformer3D) when `cross`, and
        `{where}_motion_{j}` (a MotionModule with `motion_types`
        attentions) unless `motion_types` is None."""
        c, f, g = self.cfg, self.n_frames, self.cfg.norm_num_groups
        if cross:
            self.add_module(f"{where}_attn_{j}", Transformer3D(
                ch, spatial_heads(c, ch), c.cross_attention_dim, f,
                groups=g))
        if motion_types is not None:
            self.add_module(f"{where}_motion_{j}", MotionModule(
                ch, f, heads=c.motion_num_attention_heads,
                num_blocks=c.motion_num_transformer_block,
                attention_block_types=motion_types,
                max_seq_len=c.motion_max_seq_length, groups=g))

    def _run_sites(self, where: str, j: int, h, context,
                   hooks: AttnHooks = NO_HOOKS):
        attn = getattr(self, f"{where}_attn_{j}", None)
        if attn is not None:
            h = hooks.attn(attn, f"{where}_attn_{j}", h, context)
        motion = getattr(self, f"{where}_motion_{j}", None)
        if motion is not None:
            h = hooks.motion(motion, f"{where}_motion_{j}", h)
        return h

    def _motion_types(self, res: int, types, gate: bool):
        """The motion module's attention types at resolution `res`, or None
        where there is none (`gate`: only at motion_module_resolutions)."""
        c = self.cfg
        if not c.use_motion_module or (
                gate and res not in c.motion_module_resolutions):
            return None
        return types

    def _build_down(self, motion_types, gate_motion: bool):
        """Down blocks and mid block; returns the channels of each skip."""
        c = self.cfg
        g, ted = c.norm_num_groups, c.block_out_channels[0] * 4
        ch = c.block_out_channels[0]
        skips, res = [ch], 1
        for i, btype in enumerate(c.down_block_types):
            out = c.block_out_channels[i]
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_res_{j}",
                                ResnetBlock3D(ch, out, ted, g))
                ch = out
                self._add_sites(f"down_{i}", j, ch,
                                btype.startswith("CrossAttn"),
                                self._motion_types(res, motion_types,
                                                   gate_motion))
                skips.append(ch)
            if i != len(c.down_block_types) - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
                res *= 2
        self.mid_res_0 = ResnetBlock3D(ch, ch, ted, g)
        self.mid_attn = Transformer3D(ch, spatial_heads(c, ch),
                                      c.cross_attention_dim, self.n_frames,
                                      groups=g)
        self.mid_res_1 = ResnetBlock3D(ch, ch, ted, g)
        return skips

    def _time_embedding(self, timesteps):
        c = self.cfg
        temb = timestep_embedding(timesteps, c.block_out_channels[0])
        temb = self.time_emb_2(F.silu(self.time_emb_1(
            temb.to(self.conv_in.weight.dtype))))
        return temb.repeat_interleave(self.n_frames, dim=0)

    def _down(self, h, temb, context, hooks: AttnHooks = NO_HOOKS):
        """Down blocks; returns (h, skips), the features before the mid
        block."""
        c = self.cfg
        skips = [h]
        for i in range(len(c.down_block_types)):
            for j in range(c.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                h = self._run_sites(f"down_{i}", j, h, context, hooks)
                skips.append(h)
            if i != len(c.down_block_types) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        return h, skips

    def _mid(self, h, temb, context, hooks: AttnHooks = NO_HOOKS):
        h = self.mid_res_0(h, temb)
        h = hooks.attn(self.mid_attn, "mid_attn", h, context)
        return self.mid_res_1(h, temb)


class UNet3DModel(VideoEncoderMixin, nn.Module):
    """sample [B, C, F, H, W], timesteps [B], encoder_hidden_states
    [B, 77, ctx], optional SparseCtrl residuals in the folded layout
    ([(B F), C, H, W] each) -> eps [B, C_out, F, H, W]."""

    def __init__(self, cfg: UNet3DConfig, n_frames: int = 16, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        self.n_frames = n_frames
        g, ted = c.norm_num_groups, c.block_out_channels[0] * 4
        types = c.motion_attention_block_types
        with torch.device(resolve_device(device)):
            self._build_time_embedding()
            skips = self._build_down(types, gate_motion=True)
            ch = c.block_out_channels[-1]
            res = 2 ** (len(c.down_block_types) - 1)
            rev = list(reversed(c.block_out_channels))
            for i, btype in enumerate(c.up_block_types):
                for j in range(c.layers_per_block + 1):
                    self.add_module(f"up_{i}_res_{j}", ResnetBlock3D(
                        ch + skips.pop(), rev[i], ted, g))
                    ch = rev[i]
                    self._add_sites(f"up_{i}", j, ch,
                                    btype.startswith("CrossAttn"),
                                    self._motion_types(res, types, True))
                if i != len(c.up_block_types) - 1:
                    self.add_module(f"up_{i}_upsample",
                                    nn.Conv2d(ch, ch, 3, padding=1))
                    res //= 2
            self.conv_norm_out = GroupNorm(min(g, ch), ch, 1e-5)
            self.conv_out = nn.Conv2d(ch, c.out_channels, 3, padding=1)
        self.to(dtype)

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_residuals=None, mid_block_residual=None,
                cached=None, return_cache: bool = False,
                xattn_cached=None, capture_xattn: bool = False,
                sattn_cached=None, capture_sattn: bool = False,
                tattn_cached=None, capture_tattn: bool = False):
        """eps, or (eps, *extras) with the extras asked for in the order
        encoder cache `(h, skips)`, {site: xattn}, {site: sattn},
        {site: tattn}. `cached` skips conv_in and the down blocks; the
        SparseCtrl residuals are added to the (cached or fresh) skips."""
        c = self.cfg
        kinds = AttnHooks.KINDS
        hooks = AttnHooks(
            dict(zip(kinds, (xattn_cached, sattn_cached, tattn_cached))),
            [k for k, on in zip(kinds, (capture_xattn, capture_sattn,
                                        capture_tattn)) if on])
        temb = self._time_embedding(timesteps)
        if cached is None:
            h, skips = self._down(self.conv_in(fold(sample)), temb,
                                  encoder_hidden_states, hooks)
        else:
            h, skips = cached[0], list(cached[1])
        cache = (h, tuple(skips))
        h = self._mid(h, temb, encoder_hidden_states, hooks)
        if mid_block_residual is not None:
            h = h + mid_block_residual
        if down_block_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_block_residuals)]
        for i in range(len(c.up_block_types)):
            for j in range(c.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                h = self._run_sites(f"up_{i}", j, h, encoder_hidden_states,
                                    hooks)
            if i != len(c.up_block_types) - 1:
                # jax.image.resize "nearest" samples at half-pixel centres
                h = F.interpolate(h, scale_factor=2, mode="nearest-exact")
                h = getattr(self, f"up_{i}_upsample")(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        out = unfold(h, self.n_frames)
        extras = (cache,) * return_cache + tuple(
            hooks.out[k] for k in kinds if k in hooks.capture)
        return (out,) + extras if extras else out
