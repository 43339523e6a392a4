"""Classifier ViTs for the stage-6 semantic metrics.

Counterpart of neurons_tpu/models/vit.py: the HF classifiers the reference
evaluates with, google/vit-base-patch16-224 (ImageNet-1k, the frame 2- and
50-way metrics) and MCG-NJU/videomae-base-finetuned-kinetics (Kinetics-400,
the video metrics). Both are pre-norm ViT encoders (LayerNorm eps 1e-12,
exact GELU); VideoMAE patchifies 2 x 16 x 16 tubelets with a Dense and
mean-pools its tokens before `ln_post`, the ViT takes its CLS token after
it. Attention goes through `ops.attention.dot_product_attention`: 197
tokens a frame for the ViT-B, 588 for VideoMAE over 6 frames, so the flash
forward runs on a CUDA tensor. Weights import from the HF checkpoints via
interop/torch_import.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.ops.attention import dot_product_attention


class ViTConfig(NamedTuple):
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    num_classes: int = 1000
    tubelet_size: int = 1   # >1 -> VideoMAE-style 3-D patches
    mlp_ratio: float = 4.0
    num_frames: int = 1
    pool: str = "cls"       # cls | mean

    @staticmethod
    def vit_base_224() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def videomae_kinetics(num_frames: int = 16) -> "ViTConfig":
        return ViTConfig(num_classes=400, tubelet_size=2,
                         num_frames=num_frames, pool="mean")

    @staticmethod
    def tiny(num_classes: int = 10) -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, width=32, layers=2,
                         heads=4, num_classes=num_classes)

    def num_tokens(self) -> int:
        """Encoder tokens: patches (tubelets times patches for VideoMAE),
        plus the CLS token with the cls pool."""
        grid = (self.image_size // self.patch_size) ** 2
        if self.tubelet_size > 1:
            return (self.num_frames // self.tubelet_size) * grid
        return grid + (self.pool == "cls")


class _EncoderBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.heads = heads
        hidden = int(mlp_ratio * width)
        self.ln_1 = nn.LayerNorm(width, eps=1e-12)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.attn_out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-12)
        self.mlp_fc = nn.Linear(width, hidden)
        self.mlp_proj = nn.Linear(hidden, width)

    def forward(self, x):
        b, t, d = x.shape
        h = self.ln_1(x)

        def split(y):
            return y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)

        out = dot_product_attention(split(self.q(h)), split(self.k(h)),
                                    split(self.v(h)))
        x = x + self.attn_out(out.transpose(1, 2).reshape(b, t, d))
        h = F.gelu(self.mlp_fc(self.ln_2(x)))
        return x + self.mlp_proj(h)


class ViTClassifier(nn.Module):
    """Images [B, 3, H, W] (or videos [B, F, 3, H, W] when tubelet_size >
    1), ImageNet-normalised -> logits [B, num_classes]."""

    def __init__(self, cfg: ViTConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        with torch.device(resolve_device(device)):
            p = c.patch_size
            if c.tubelet_size > 1:
                self.patch_embed = nn.Linear(c.tubelet_size * p * p * 3,
                                             c.width)
            else:
                self.patch_embed = nn.Conv2d(3, c.width, p, stride=p)
            if c.pool == "cls":
                self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
            self.pos_embed = nn.Parameter(
                torch.empty(c.num_tokens(), c.width).normal_(std=0.02))
            for i in range(c.layers):
                self.add_module(f"block_{i}", _EncoderBlock(
                    c.width, c.heads, c.mlp_ratio))
            self.ln_post = nn.LayerNorm(c.width, eps=1e-12)
            self.head = nn.Linear(c.width, c.num_classes)
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.tubelet_size > 1:
            b, f, ch, hh, ww = x.shape
            ts, p = c.tubelet_size, c.patch_size
            # [B, F/ts, H/p, W/p, (ts p p ch)] tubelet tokens
            x = x.reshape(b, f // ts, ts, ch, hh // p, p, ww // p, p)
            x = x.permute(0, 1, 4, 6, 2, 5, 7, 3)
            tokens = self.patch_embed(x.reshape(
                b, (f // ts) * (hh // p) * (ww // p), ts * p * p * ch))
        else:
            tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        if c.pool == "cls":
            tokens = torch.cat([self.cls_token.expand(tokens.shape[0], -1,
                                                      -1), tokens], dim=1)
        tokens = tokens + self.pos_embed[None]
        for i in range(c.layers):
            tokens = getattr(self, f"block_{i}")(tokens)
        if c.pool == "cls":
            pooled = self.ln_post(tokens)[:, 0]
        else:  # VideoMAE's use_mean_pooling: the mean first, then fc_norm
            pooled = self.ln_post(tokens.mean(dim=1))
        return self.head(pooled)
