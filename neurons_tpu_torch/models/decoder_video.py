"""Text-driven decoupler decoder: seg / blurry-recon heads over a
temporal-attention VAE-style upsampling decoder.

Counterpart of neurons_tpu/models/decoder_video.py, channels-first (NCHW)
throughout:

  TextDrivenDecoder — text<->vision cross attention (q from vision tokens,
    k/v from the batch of pooled text embeddings, the reference's quirk),
    1x1-conv maps projector 1280 -> 64, DecoderVideo upsampler
    16x16 -> 64x64, then seg (-> 1) or recon (-> 4 VAE-latent) conv heads.
  DecoderVideo — conv_in -> mid block -> attention up-blocks -> GN+SiLU.
    Every attention site runs spatial attention, then temporal attention
    over frames, blended as w * spatial + (1 - w) * temporal.

The spatial AttnBlock runs one head over up to 4096 tokens (d=32 at the
last up block) through the dispatcher, so it takes the flash kernels on
the card (under autograd, the forward with lse and the backward); the
temporal rows (a few frames) take the plain path.

Stage 2 runs the temporal attention over all B*F rows of its batch as one
sequence (`time` = B*F). Data-parallel, a rank holds B*F / N of them and
its caller passes a `RowSplit` (`split=`, `time` then this rank's rows):
each site gathers the sequence's rows from every rank, attends over all of
them and keeps its own.

Training dropout (stage 2): 0.1 on the text-attention weights and on the
attention output, 0.3 after the maps projector, as the JAX package's
TextDrivenDecoder. The keep masks are drawn by `draw_decoder_dropout` and
passed in, so that a checkpointed call recomputes with the same masks (a
recompute restores the global RNG state, not a user generator's).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch.ops.attention import dot_product_attention
from neurons_tpu_torch.ops.fused_norm import GroupNorm, GroupNormSiLU


class RowSplit(NamedTuple):
    """A temporal sequence whose rows lie on several ranks, in rank order:
    `gather(t)` is every rank's rows of `t` along axis 0 (differentiable;
    each rank's rows get the gradient of every rank's use of them), and
    `rows` is this rank's slice of the gathered rows."""

    gather: Callable[[torch.Tensor], torch.Tensor]
    rows: slice


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3 -> GN -> SiLU -> conv3x3, 1x1 shortcut when
    the channels change."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNormSiLU(groups, in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNormSiLU(groups, out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """GroupNorm, then single-head q/k/v attention over a token axis,
    residual. Input [N, T, C]."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, tokens):
        n, t, c = tokens.shape
        h = self.group_norm(tokens.transpose(1, 2)).transpose(1, 2)
        q = self.to_q(h)[:, None]
        k = self.to_k(h)[:, None]
        v = self.to_v(h)[:, None]
        out = dot_product_attention(q, k, v)[:, 0]
        return self.to_out(out) + tokens


class Upsample2D(nn.Module):
    """Nearest 2x upsample + conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _SpatialTemporalAttn(nn.Module):
    """Spatial attention + temporal attention blend. Input [(b t), C, H, W]."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.attn = AttnBlock(channels, groups)
        self.temp_attn = AttnBlock(channels, groups)
        self.blend_weight = nn.Parameter(torch.ones(1))

    def forward(self, x, time: int, split: Optional[RowSplit] = None):
        bt, c, hh, ww = x.shape
        hw = hh * ww
        spatial = self.attn(x.flatten(2).transpose(1, 2))      # [bt, hw, c]
        rows = spatial
        if split is not None:  # one sequence over every rank's rows
            if time != bt:
                raise ValueError(f"a sequence split over ranks holds all of "
                                 f"each rank's {bt} rows, not {time}")
            rows = split.gather(spatial)
            time = rows.shape[0]
        n = rows.shape[0]
        b = n // time
        # (b t) (h w) c -> (b h w) t c
        tmp = rows.reshape(b, time, hw, c).transpose(1, 2)
        tmp = self.temp_attn(tmp.reshape(b * hw, time, c))
        tmp = tmp.reshape(b, hw, time, c).transpose(1, 2).reshape(n, hw, c)
        if split is not None:
            tmp = tmp[split.rows]
        w = self.blend_weight
        out = w * spatial + (1 - w) * tmp
        return out.transpose(1, 2).reshape(bt, c, hh, ww)


class MidBlockVideo(nn.Module):
    """resnet, then per layer [spatial/temporal attention -> resnet]."""

    def __init__(self, channels: int, num_layers: int = 1, groups: int = 32):
        super().__init__()
        self.num_layers = num_layers
        self.resnet_0 = ResnetBlock2D(channels, channels, groups)
        for i in range(num_layers):
            self.add_module(f"st_attn_{i}",
                            _SpatialTemporalAttn(channels, groups))
            self.add_module(f"resnet_{i + 1}",
                            ResnetBlock2D(channels, channels, groups))

    def forward(self, x, time: int, split: Optional[RowSplit] = None):
        x = self.resnet_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"st_attn_{i}")(x, time, split)
            x = getattr(self, f"resnet_{i + 1}")(x)
        return x


class AttnUpBlockVideo(nn.Module):
    """per layer [resnet -> spatial/temporal attention], then an optional
    2x upsample."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool, groups: int = 32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", ResnetBlock2D(
                in_channels if i == 0 else out_channels, out_channels, groups))
            self.add_module(f"st_attn_{i}",
                            _SpatialTemporalAttn(out_channels, groups))
        if add_upsample:
            self.upsample = Upsample2D(out_channels)

    def forward(self, x, time: int, split: Optional[RowSplit] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x)
            x = getattr(self, f"st_attn_{i}")(x, time, split)
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return x


class DecoderVideo(nn.Module):
    """Input [(b t), Cin, H, W] -> [(b t), block_out_channels[0],
    H * 2^(n-1), W * 2^(n-1)]."""

    def __init__(self, in_channels: int,
                 block_out_channels: Sequence[int] = (32, 64, 128),
                 layers_per_block: int = 1, norm_num_groups: int = 32):
        super().__init__()
        ch = list(block_out_channels)
        self.n_up = len(ch)
        self.conv_in = nn.Conv2d(in_channels, ch[-1], 3, padding=1)
        self.mid_block = MidBlockVideo(ch[-1], groups=norm_num_groups)
        prev = ch[-1]
        for i, out_c in enumerate(reversed(ch)):
            self.add_module(f"up_block_{i}", AttnUpBlockVideo(
                prev, out_c, layers_per_block + 1,
                add_upsample=i != len(ch) - 1, groups=norm_num_groups))
            prev = out_c
        self.conv_norm_out = GroupNormSiLU(norm_num_groups, ch[0], 1e-6)

    def forward(self, x, time: int = 1, split: Optional[RowSplit] = None):
        x = self.mid_block(self.conv_in(x), time, split)
        for i in range(self.n_up):
            x = getattr(self, f"up_block_{i}")(x, time, split)
        return self.conv_norm_out(x)


ATTENTION_DROPOUT = 0.1
MAPS_DROPOUT = 0.3


class DecoderDropout(NamedTuple):
    """Keep masks (bool) of the TextDrivenDecoder's dropout sites: `attn` on
    the text-attention weights [B', N, B] (rate 0.1; unused without text),
    `out` on the attention output [B', N, Ct] (0.1) and `maps` after the
    maps projector [B', 64, h, w] (0.3)."""

    attn: torch.Tensor
    out: torch.Tensor
    maps: torch.Tensor


def draw_decoder_dropout(n_rows: int, n_tokens: int, n_texts: int,
                         txt_dim: int, generator: torch.Generator,
                         device) -> DecoderDropout:
    """Keep masks for `n_rows` (= B * F) rows of `n_tokens` vision tokens
    attending over `n_texts` texts: each element kept with probability
    1 - rate."""
    hw = math.isqrt(n_tokens)

    def keep(shape, rate):
        return torch.rand(shape, generator=generator, device=device) < 1 - rate

    return DecoderDropout(
        keep((n_rows, n_tokens, n_texts), ATTENTION_DROPOUT),
        keep((n_rows, n_tokens, txt_dim), ATTENTION_DROPOUT),
        keep((n_rows, 64, hw, hw), MAPS_DROPOUT))


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's Dropout with a given mask: kept elements scaled by
    1 / (1 - rate), the rest zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TextDrivenDecoder(nn.Module):
    """`vision_feat` [B', N, Cv] (B' = batch * frames), `text_feat` [B, Ct]
    pooled text embeddings or None. Returns NCHW maps:
      is_seg=True  -> [B', 1, H, W] segmentation logits
      is_seg=False -> [B', 4, H, W] VAE-latent prediction
    """

    def __init__(self, clip_vision_emb_dim: int = 1664,
                 clip_txt_emb_dim: int = 1280,
                 decoder_block_out_channels: Tuple[int, ...] = (32, 64, 128),
                 decoder_layers_per_block: int = 1):
        super().__init__()
        cv, ct = clip_vision_emb_dim, clip_txt_emb_dim
        self.clip_vision_emb_dim = cv
        self.q = nn.Linear(cv, ct, bias=False)
        self.k = nn.Linear(ct, ct, bias=False)
        self.v = nn.Linear(ct, ct, bias=False)
        self.out = nn.Linear(ct, ct, bias=False)
        self.maps_0 = nn.Conv2d(ct, 512, 1, bias=False)
        self.maps_gn_0 = GroupNorm(1, 512, eps=1e-5)
        self.maps_1 = nn.Conv2d(512, 128, 1, bias=False)
        self.maps_gn_1 = GroupNorm(1, 128, eps=1e-5)
        self.maps_2 = nn.Conv2d(128, 64, 1)
        self.norm = GroupNorm(1, 64, eps=1e-5)
        chans = tuple(decoder_block_out_channels)
        self.video_decoder = DecoderVideo(
            64, chans, decoder_layers_per_block,
            norm_num_groups=min(32, min(chans)))
        self.seg_head = nn.Conv2d(chans[0], 1, 3, padding=1)
        self.recon_head = nn.Conv2d(chans[0], 4, 3, padding=1)

    def forward(self, vision_feat, text_feat: Optional[torch.Tensor] = None,
                time: int = 1, is_seg: bool = True,
                deterministic: bool = True,
                dropout_masks: Optional[DecoderDropout] = None,
                return_all: bool = False,
                split: Optional[RowSplit] = None):
        """`deterministic=False` applies the training dropout with the
        given `dropout_masks`; `return_all` gives (seg, recon) from one
        decode; `split`: the temporal sequence spans the ranks (`RowSplit`;
        `time` is this rank's rows)."""
        if not deterministic and dropout_masks is None:
            raise ValueError("training dropout needs its keep masks "
                             "(draw_decoder_dropout)")
        masks = None if deterministic else dropout_masks
        q = self.q(vision_feat)
        if text_feat is not None:
            # each vision token attends over the batch of texts; the scale
            # is the vision dim's, applied after the product
            k, v = self.k(text_feat), self.v(text_feat)
            attn = torch.einsum("bnc,tc->bnt", q, k).to(
                torch.promote_types(q.dtype, torch.float32))
            attn = torch.softmax(attn * self.clip_vision_emb_dim ** -0.5,
                                 dim=-1).to(q.dtype)
            if masks is not None:
                attn = dropout(attn, masks.attn, ATTENTION_DROPOUT)
            out = self.out(torch.einsum("bnt,tc->bnc", attn, v))
        else:
            out = self.out(q)
        if masks is not None:
            out = dropout(out, masks.out, ATTENTION_DROPOUT)
        bb, n, c = out.shape
        hw = math.isqrt(n)
        x = out.reshape(bb, hw, hw, c).permute(0, 3, 1, 2)
        x = F.relu(self.maps_gn_0(self.maps_0(x)))
        x = F.relu(self.maps_gn_1(self.maps_1(x)))
        x = self.maps_2(x)
        if masks is not None:
            x = dropout(x, masks.maps, MAPS_DROPOUT)
        x = self.norm(x)
        x = self.video_decoder(x, time, split)
        if return_all:
            return self.seg_head(x), self.recon_head(x)
        return self.seg_head(x) if is_seg else self.recon_head(x)
