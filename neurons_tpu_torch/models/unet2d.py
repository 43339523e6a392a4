"""SD-unCLIP denoising UNet (OpenAI-style UNetModel), NCHW.

Counterpart of neurons_tpu/models/unet2d.py: model_channels 320,
channel_mult (1, 2, 4), 2 res blocks a level, spatial transformers of
depth (-, 2, 10) at downsample factors 2 and 4, 1664-d CLIP cross-attention
context, and a 1024-d adm vector added to the timestep embedding. Every
attention site goes through ops.attention.dot_product_attention (the
flash kernel on the card). The timestep embedding is cat(cos, sin); GEGLU
uses exact GELU; the LayerNorms use eps 1e-5, the transformer GroupNorm
1e-6 and the res-block GroupNorms 1e-5.

Every GN -> SiLU -> 3x3 conv pair (both of each ResBlock, and the output
head) goes through ops.fused_conv.norm_silu_conv: the fused CUDA kernel
with NEURONS_TPU_FUSED_GNCONV=1, as the JAX ResBlock routes it.

`UNetModel.forward` carries the JAX UNet's hooks for the fast samplers:
the encoder cache (`cached` / `return_cache`, encoder reuse), DeepCache
(`deep_cached` / `return_deep_cache`), and the cross- and self-attention
residuals by site name (`capture_xattn` / `xattn_cached` for TGATE and PAB,
`capture_sattn` / `sattn_cached` for PAB). A cached residual replaces its
whole pre-norm branch (norm2 + attn2, or norm1 + attn1); captures come back
stacked over a site's depth, [depth, B, T, C].
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
from neurons_tpu_torch.ops.fused_conv import norm_silu_conv
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
        h = norm_silu_conv(self.in_norm, self.in_conv, x)
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = norm_silu_conv(self.out_norm, self.out_conv, h)
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
    """self-attn -> cross-attn(context) -> FF, each pre-norm residual.

    `xattn_cached` replaces the cross-attention residual (norm2 + attn2 is
    skipped) and `sattn_cached` the self-attention one (norm1 + attn1);
    `capture` / `capture_sattn` also return that residual, cached or not,
    in the order (x, xattn, sattn)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, kv=None, xattn_cached=None,
                capture: bool = False, sattn_cached=None,
                capture_sattn: bool = False):
        sattn = (sattn_cached if sattn_cached is not None
                 else self.attn1(self.norm1(x)))
        x = sattn + x
        xattn = (xattn_cached if xattn_cached is not None
                 else self.attn2(self.norm2(x), context, kv=kv))
        x = xattn + x
        x = self.ff(self.norm3(x)) + x
        extras = (xattn,) * capture + (sattn,) * capture_sattn
        return (x,) + extras if extras else x


class SpatialTransformer(nn.Module):
    """GN -> linear proj_in -> depth x BasicTransformerBlock -> proj_out ->
    residual. The hooks' caches and captures are stacked over depth."""

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

    def forward(self, x, context, ctx_kv=None, xattn_cached=None,
                capture: bool = False, sattn_cached=None,
                capture_sattn: bool = False):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        captured, captured_s = [], []
        for i in range(self.depth):
            out = getattr(self, f"block_{i}")(
                t, context,
                kv=None if ctx_kv is None else (ctx_kv[0][i], ctx_kv[1][i]),
                xattn_cached=None if xattn_cached is None else xattn_cached[i],
                capture=capture,
                sattn_cached=None if sattn_cached is None else sattn_cached[i],
                capture_sattn=capture_sattn)
            if capture or capture_sattn:
                t, *rest = out
                if capture:
                    captured.append(rest.pop(0))
                if capture_sattn:
                    captured_s.append(rest.pop(0))
            else:
                t = out
        t = self.proj_out(t)
        out = t.transpose(1, 2).reshape(b, c, h, w) + x
        extras = tuple(torch.stack(c) for c, on in
                       ((captured, capture), (captured_s, capture_sattn))
                       if on)
        return (out,) + extras if extras else out


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
    y [B, adm_in_channels] -> eps [B, 4, H, W]. The label embedding of `y`
    exists only where adm_in_channels > 0, as the JAX UNet creates it only
    when called with a `y` (SD 2.1 has none)."""

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
            if c.adm_in_channels > 0:  # the adm vector `y` (unCLIP, SDXL)
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

    def forward(self, x, timesteps, context, y=None, ctx_kv=None,
                cached=None, return_cache: bool = False,
                xattn_cached=None, capture_xattn: bool = False,
                sattn_cached=None, capture_sattn: bool = False,
                deep_cached=None, return_deep_cache: bool = False):
        """eps, or (eps, *extras) with the extras asked for in the order
        encoder cache `(h, skips)`, DeepCache feature, {site: xattn},
        {site: sattn}.

        `cached` skips the encoder (conv_in and the down blocks) and runs
        the mid block and decoder on the cached features. `deep_cached`
        (DeepCache, arXiv 2312.00858) is the feature entering `up_0_res_0`
        on an earlier full step: such a step runs only conv_in, the level-0
        down and up blocks and the head."""
        c = self.cfg
        dtype = self.conv_in.weight.dtype
        emb = self.time_embed_0(timestep_embedding(timesteps,
                                                   c.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if y is not None:
            emb = emb + self.label_emb_2(F.silu(self.label_emb_0(y)))
        xattn_out, sattn_out = {}, {}

        def attn(name, h):
            site = getattr(self, name, None)
            if site is None:
                return h
            out = site(
                h, context, ctx_kv=None if ctx_kv is None else ctx_kv[name],
                xattn_cached=None if xattn_cached is None
                else xattn_cached[name],
                capture=capture_xattn,
                sattn_cached=None if sattn_cached is None
                else sattn_cached[name],
                capture_sattn=capture_sattn)
            if not (capture_xattn or capture_sattn):
                return out
            h, *rest = out
            if capture_xattn:
                xattn_out[name] = rest.pop(0)
            if capture_sattn:
                sattn_out[name] = rest.pop(0)
            return h

        deep_only = deep_cached is not None
        levels = range(1 if deep_only else len(c.channel_mult))
        if cached is None:
            h = self.conv_in(x)
            skips = [h]
            for level in levels:
                for i in range(c.num_res_blocks):
                    h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                    h = attn(f"down_{level}_attn_{i}", h)
                    skips.append(h)
                if level != len(c.channel_mult) - 1 and not deep_only:
                    h = getattr(self, f"down_{level}_downsample")(h)
                    skips.append(h)
        else:
            h, skips = cached[0], list(cached[1])
        cache = (h, tuple(skips))
        if not deep_only:
            h = self.mid_res_0(h, emb)
            h = attn("mid_attn", h)
            h = self.mid_res_1(h, emb)
        deep_out = None
        for level in reversed(levels):
            for i in range(c.num_res_blocks + 1):
                if level == 0 and i == 0:
                    if deep_only:
                        h = deep_cached
                    deep_out = h
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{level}_res_{i}")(h, emb)
                h = attn(f"up_{level}_attn_{i}", h)
                if level and i == c.num_res_blocks:
                    h = getattr(self, f"up_{level}_upsample")(h)
        out = norm_silu_conv(self.out_norm, self.out_conv, h)
        extras = ((cache,) * return_cache + (deep_out,) * return_deep_cache
                  + (xattn_out,) * capture_xattn
                  + (sattn_out,) * capture_sattn)
        return (out,) + extras if extras else out
