"""Diffusion-prior network: brain tokens -> denoised CLIP image tokens.

Counterpart of neurons_tpu/models/prior.py (the dalle2-style prior):

  PriorNetwork      — token sequence [brain(N) | time(1) | image(N)] with
                      `pos_emb` learned queries and null-embed CFG masking
  PriorTransformer  — pre-norm blocks of multi-query attention (one K/V
                      head plus a learned null K/V token) with rotary
                      embedding on the first min(32, dim_head) dims and a
                      T5-style relative-position bias, SwiGLU feed-forward,
                      stable output norm and a final projection

Attention carries the additive relative-position bias and multi-query
k/v: at inference it takes the plain path of ops/attention.py, as the JAX
package routes its inference call to XLA; under autograd (stage-2
training) it takes the biased flash kernels. q is pre-scaled and attention
runs with scale=1.0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch.config import PriorConfig
from neurons_tpu_torch.ops.attention import dot_product_attention


class GainLayerNorm(nn.Module):
    """Gain-only LayerNorm (no bias); `stable` divides by the row's amax
    first, with no gradient through the amax (the JAX package stops it)."""

    def __init__(self, dim: int, stable: bool = False, eps: float = 1e-5):
        super().__init__()
        self.stable = stable
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        if self.stable:
            x = x / x.detach().abs().amax(dim=-1, keepdim=True).clamp(
                min=self.eps)
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.g


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim], cat(sin, cos), f32."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeMLP(nn.Module):
    """Linear -> SiLU -> Linear -> SiLU -> Linear, hidden = 2 * dim_out."""

    def __init__(self, dim_in: int, dim_out: int, expansion: float = 2.0):
        super().__init__()
        hidden = int(expansion * dim_out)
        self.Dense_0 = nn.Linear(dim_in, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, dim_out)

    def forward(self, x):
        x = F.silu(self.Dense_0(x))
        x = F.silu(self.Dense_1(x))
        return self.Dense_2(x)


def _rel_pos_bucket(rel_pos: torch.Tensor, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    n = torch.clamp(-rel_pos, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int64)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return torch.where(is_small, n, val_large)


def rel_pos_bias_from_table(table: torch.Tensor, qlen: int, klen: int,
                            num_buckets: int = 32,
                            max_distance: int = 128) -> torch.Tensor:
    """[num_buckets, H] table -> [H, qlen, klen] bias."""
    q_pos = torch.arange(qlen, device=table.device)[:, None]
    k_pos = torch.arange(klen, device=table.device)[None, :]
    buckets = _rel_pos_bucket(k_pos - q_pos, num_buckets, max_distance)
    return table[buckets].permute(2, 0, 1)


class RelPosBias(nn.Module):
    """T5-style relative-position bias, causal bucketing."""

    def __init__(self, heads: int, num_buckets: int = 32,
                 max_distance: int = 128):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.rel_bias = nn.Parameter(torch.empty(num_buckets, heads).normal_())

    def forward(self, qlen: int, klen: int) -> torch.Tensor:
        return rel_pos_bias_from_table(self.rel_bias, qlen, klen,
                                       self.num_buckets, self.max_distance)


def prior_attn_bias(prior_net: "PriorNetwork") -> torch.Tensor:
    """The step-invariant relative-position bias of a PriorNetwork, f32
    [H, 2N+1, 2N+2] (keys gain the null token), to hoist out of the
    sampling loop."""
    n = 2 * prior_net.cfg.num_tokens + 1
    table = prior_net.transformer.rel_pos_bias.rel_bias.float()
    return rel_pos_bias_from_table(table, n, n + 1)


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rotary(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on the first pos.shape[-1] dims of t; cos/sin of the
    f32 angles applied in t's dtype."""
    rot_dim = pos.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    cos = torch.cos(pos).to(t.dtype)
    sin = torch.sin(pos).to(t.dtype)
    t_rot = t_rot * cos + _rotate_half(t_rot) * sin
    return torch.cat([t_rot, t_pass], dim=-1)


def rotary_freqs(seq_len: int, dim: int, device=None) -> torch.Tensor:
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


class MultiQueryAttention(nn.Module):
    """Multi-head Q, single-head K/V, learned null K/V token, rotary,
    additive relative-position bias, optional causal mask."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 causal: bool = False, rotary_dim: int = 32):
        super().__init__()
        self.dim_head, self.heads = dim_head, heads
        self.causal = causal
        self.rotary_dim = rotary_dim
        inner = dim_head * heads
        self.norm = GainLayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, dim_head * 2, bias=False)
        self.null_kv = nn.Parameter(torch.empty(2, dim_head).normal_())
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.out_norm = GainLayerNorm(dim)

    def forward(self, x, attn_bias: Optional[torch.Tensor] = None):
        b, n, _ = x.shape
        dh = self.dim_head
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, self.heads, dh).transpose(1, 2)
        k, v = self.to_kv(x).chunk(2, dim=-1)          # [b, n, dh]
        q = q * dh ** -0.5

        rot = rotary_freqs(n, min(self.rotary_dim, dh), device=x.device)
        q = apply_rotary(rot[None, None], q)
        k = apply_rotary(rot[None], k)

        k = torch.cat([self.null_kv[0].expand(b, 1, dh), k], dim=1)
        v = torch.cat([self.null_kv[1].expand(b, 1, dh), v], dim=1)
        mask = None
        if self.causal:  # the null token (key 0) is always visible
            i = torch.arange(n, device=x.device)[:, None]
            j = torch.arange(n + 1, device=x.device)[None, :]
            mask = (j <= i + 1)[None, None]
        out = dot_product_attention(q, k[:, None], v[:, None], bias=attn_bias,
                                    mask=mask, scale=1.0)
        out = out.transpose(1, 2).reshape(b, n, self.heads * dh)
        return self.out_norm(self.to_out(out))


class SwiGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.norm = GainLayerNorm(dim)
        self.proj_in = nn.Linear(dim, inner * 2, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x):
        val, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        return self.proj_out(val * F.silu(gate))


class PriorTransformer(nn.Module):
    """depth x (attention, feed-forward) residual blocks sharing one
    relative-position bias, stable output norm, final projection."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        c = self.cfg = cfg
        self.rel_pos_bias = RelPosBias(heads=c.heads)
        for i in range(c.depth):
            self.add_module(f"attn_{i}", MultiQueryAttention(
                c.dim, dim_head=c.dim_head, heads=c.heads, causal=c.causal))
            self.add_module(f"ff_{i}", SwiGLUFeedForward(c.dim, c.ff_mult))
        self.norm_out = GainLayerNorm(c.dim, stable=True)
        self.project_out = nn.Linear(c.dim, c.dim, bias=False)

    def forward(self, x, attn_bias: Optional[torch.Tensor] = None):
        n = x.shape[1]
        if attn_bias is None:
            attn_bias = self.rel_pos_bias(n, n + 1)
        # one copy with unit key stride for the layers' attention, instead of
        # one in each flash launch (the table's gather is a [H, Tq, Tk] view
        # whose key stride is H)
        attn_bias = attn_bias.contiguous()
        for i in range(self.cfg.depth):
            x = getattr(self, f"attn_{i}")(x, attn_bias=attn_bias) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return self.project_out(self.norm_out(x))


class PriorNetwork(nn.Module):
    """Denoiser over CLIP image tokens conditioned on brain tokens; the
    prediction is read from the last N positions. CFG drops brain/image
    conditioning to learned null embeddings: all rows at probability 1,
    none at 0, and at a fractional probability the rows whose keep mask is
    False (masks [B] passed in, or drawn from `generator`: a row keeps its
    condition where a uniform draw is >= the probability)."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        c = self.cfg = cfg
        self.null_brain_embeds = nn.Parameter(
            torch.empty(c.num_tokens, c.dim).normal_())
        self.null_image_embed = nn.Parameter(
            torch.empty(c.num_tokens, c.dim).normal_())
        self.time_mlp = TimeMLP(c.dim, c.dim)
        self.learned_query = nn.Parameter(
            torch.empty(c.num_tokens, c.dim).normal_(std=c.dim ** -0.5))
        self.transformer = PriorTransformer(c)

    def forward(self, image_embed: torch.Tensor, times: torch.Tensor,
                brain_embed: torch.Tensor,
                brain_cond_drop_prob: float = 0.0,
                image_cond_drop_prob: float = 0.0,
                attn_bias: Optional[torch.Tensor] = None,
                brain_keep: Optional[torch.Tensor] = None,
                image_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        b, n, d = image_embed.shape
        if n != c.num_tokens or d != c.dim:
            raise ValueError(f"image_embed {tuple(image_embed.shape)} is not "
                             f"[B, {c.num_tokens}, {c.dim}]")

        def drop(x, null, prob, keep):
            if prob == 0.0:
                return x
            if prob == 1.0:
                return null[None].expand(b, n, d)
            if keep is None:
                if generator is None:
                    raise ValueError("a fractional cond drop needs keep "
                                     "masks or a generator")
                keep = torch.rand((b,), generator=generator,
                                  device=x.device) >= prob
            return torch.where(keep.reshape(b, 1, 1), x, null[None])

        # the brain mask is drawn first, as the JAX package splits its key
        brain_embed = drop(brain_embed, self.null_brain_embeds,
                           brain_cond_drop_prob, brain_keep)
        image_embed = drop(image_embed, self.null_image_embed,
                           image_cond_drop_prob, image_keep)

        dtype = self.learned_query.dtype
        time_embed = self.time_mlp(
            sinusoidal_pos_emb(times, c.dim).to(dtype))[:, None]
        time_embed = time_embed.to(image_embed.dtype)
        image_embed = image_embed + self.learned_query[None]
        tokens = torch.cat([brain_embed, time_embed, image_embed], dim=1)
        tokens = self.transformer(tokens, attn_bias=attn_bias)
        return tokens[:, -c.num_tokens:]
