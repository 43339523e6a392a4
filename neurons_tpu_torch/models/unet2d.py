"""SD-unCLIP denoising UNet (OpenAI-style UNetModel), NCHW.

Counterpart of neurons_tpu/models/unet2d.py: model_channels 320,
channel_mult (1, 2, 4), 2 res blocks a level, spatial transformers of
depth (-, 2, 10) at downsample factors 2 and 4, 1664-d CLIP cross-attention
context, and a 1024-d adm vector added to the timestep embedding. Every
attention site goes through ops.attention.dot_product_attention (the
flash kernel on the card). The timestep embedding is cat(cos, sin); GEGLU
uses exact GELU; the LayerNorms use eps 1e-5, the transformer GroupNorm
1e-6 and the res-block GroupNorms 1e-5.

Only the exact path is ported: the TGATE, PAB, DeepCache and
encoder-reuse hooks of the JAX UNet are later work (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import UNet2DConfig
from neurons_tpu_torch.ops.attention import dot_product_attention
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """OpenAI convention cat(cos, sin), f32. t: [B]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def cross_attn_sites(cfg: UNet2DConfig):
    """[(site_name, transformer_depth)] in call order."""
    sites = []
    ds = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            if ds in cfg.attention_resolutions:
                sites.append((f"down_{level}_attn_{i}",
                              cfg.transformer_depth[level]))
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
    sites.append(("mid_attn", cfg.transformer_depth[-1]))
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            if ds in cfg.attention_resolutions:
                sites.append((f"up_{level}_attn_{i}",
                              cfg.transformer_depth[level]))
            if level and i == cfg.num_res_blocks:
                ds //= 2
    return sites


def precompute_context_kv(unet: "UNetModel", context: torch.Tensor
                          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every cross-attention site's K/V projection of `context`, hoisted out
    of the sampling loop (exact: the context is the same at every step).
    Returns {site: (k, v)}, each [depth, B, Tk, inner]."""
    out = {}
    for name, depth in cross_attn_sites(unet.cfg):
        site = getattr(unet, name)
        blocks = [getattr(site, f"block_{j}").attn2 for j in range(depth)]
        out[name] = (torch.stack([F.linear(context, a.to_k.weight)
                                  for a in blocks]),
                     torch.stack([F.linear(context, a.to_v.weight)
                                  for a in blocks]))
    return out


class ResBlock(nn.Module):
    """GN -> SiLU -> conv; + time embedding; GN -> SiLU -> conv; skip."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 groups: int = 32):
        super().__init__()
        self.in_norm = GroupNormSiLU(groups, in_channels, 1e-5)
        self.in_conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = GroupNormSiLU(groups, out_channels, 1e-5)
        self.out_conv = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.skip_conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(self.out_norm(h))
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention, cross when a context is given. `kv`: optional
    precomputed (k, v) projections of the context, each [B, Tk, inner]."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, kv=None):
        ctx = x if context is None else context
        q = self.to_q(x)
        k, v = kv if kv is not None else (self.to_k(ctx), self.to_v(ctx))
        b, tq, _ = q.shape

        def split(y):
            return y.reshape(b, y.shape[1], self.heads,
                             self.dim_head).transpose(1, 2)

        out = dot_product_attention(split(q), split(k), split(v))
        return self.to_out(out.transpose(1, 2).reshape(b, tq, -1))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj_in = nn.Linear(dim, inner * 2)
        self.proj_out = nn.Linear(inner, dim)

    def forward(self, x):
        val, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(val * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> FF, each pre-norm residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, kv=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context, kv=kv) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GN -> linear proj_in -> depth x BasicTransformerBlock -> proj_out ->
    residual."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, groups: int = 32):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                channels, heads, dim_head, context_dim))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, ctx_kv=None):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for i in range(self.depth):
            kv = None if ctx_kv is None else (ctx_kv[0][i], ctx_kv[1][i])
            t = getattr(self, f"block_{i}")(t, context, kv=kv)
        t = self.proj_out(t)
        return t.transpose(1, 2).reshape(b, c, h, w) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class UpsampleConv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetModel(nn.Module):
    """x [B, 4, H, W], timesteps [B], context [B, T, context_dim],
    y [B, adm_in_channels] -> eps [B, 4, H, W]."""

    def __init__(self, cfg: UNet2DConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        mc = c.model_channels
        ted = mc * 4
        self.groups = groups = 32 if mc % 32 == 0 else mc
        nhc = c.num_head_channels

        def site(ch, depth):
            return SpatialTransformer(ch, ch // nhc, nhc, depth,
                                      c.context_dim, groups)

        with torch.device(resolve_device(device)):
            self.time_embed_0 = nn.Linear(mc, ted)
            self.time_embed_2 = nn.Linear(ted, ted)
            self.label_emb_0 = nn.Linear(c.adm_in_channels, ted)
            self.label_emb_2 = nn.Linear(ted, ted)
            self.conv_in = nn.Conv2d(c.in_channels, mc, 3, padding=1)
            ch, skips, ds = mc, [mc], 1
            for level, mult in enumerate(c.channel_mult):
                out = mc * mult
                for i in range(c.num_res_blocks):
                    self.add_module(f"down_{level}_res_{i}",
                                    ResBlock(ch, out, ted, groups))
                    ch = out
                    if ds in c.attention_resolutions:
                        self.add_module(f"down_{level}_attn_{i}",
                                        site(ch, c.transformer_depth[level]))
                    skips.append(ch)
                if level != len(c.channel_mult) - 1:
                    self.add_module(f"down_{level}_downsample",
                                    Downsample2D(ch))
                    skips.append(ch)
                    ds *= 2
            self.mid_res_0 = ResBlock(ch, ch, ted, groups)
            self.mid_attn = site(ch, c.transformer_depth[-1])
            self.mid_res_1 = ResBlock(ch, ch, ted, groups)
            for level, mult in reversed(list(enumerate(c.channel_mult))):
                out = mc * mult
                for i in range(c.num_res_blocks + 1):
                    self.add_module(f"up_{level}_res_{i}",
                                    ResBlock(ch + skips.pop(), out, ted,
                                             groups))
                    ch = out
                    if ds in c.attention_resolutions:
                        self.add_module(f"up_{level}_attn_{i}",
                                        site(ch, c.transformer_depth[level]))
                    if level and i == c.num_res_blocks:
                        self.add_module(f"up_{level}_upsample",
                                        UpsampleConv(ch))
                        ds //= 2
            self.out_norm = GroupNormSiLU(groups, mc, 1e-5)
            self.out_conv = nn.Conv2d(mc, c.out_channels, 3, padding=1)
        self.to(dtype)

    def forward(self, x, timesteps, context, y=None, ctx_kv=None):
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        emb = self.time_embed_0(timestep_embedding(timesteps,
                                                   c.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if y is not None:
            emb = emb + self.label_emb_2(F.silu(self.label_emb_0(y)))

        def attn(name, h):
            site = getattr(self, name, None)
            if site is None:
                return h
            return site(h, context,
                        ctx_kv=None if ctx_kv is None else ctx_kv[name])

        h = self.conv_in(x)
        skips = [h]
        for level in range(len(c.channel_mult)):
            for i in range(c.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                h = attn(f"down_{level}_attn_{i}", h)
                skips.append(h)
            if level != len(c.channel_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)
        h = self.mid_res_0(h, emb)
        h = attn("mid_attn", h)
        h = self.mid_res_1(h, emb)
        for level in reversed(range(len(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{level}_res_{i}")(h, emb)
                h = attn(f"up_{level}_attn_{i}", h)
                if level and i == c.num_res_blocks:
                    h = getattr(self, f"up_{level}_upsample")(h)
        return self.out_conv(self.out_norm(h))
