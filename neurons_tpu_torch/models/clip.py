"""CLIP towers: the causal text transformer (the stage-5 prompt encoder)
and the vision transformer (stage 6's CLIP-pcc embedder).

Counterpart of neurons_tpu/models/clip.py. Both stack pre-norm blocks
(ln_1 -> attention -> residual, ln_2 -> MLP -> residual), every LayerNorm
at eps 1e-5; OpenAI towers (SD-1.5's text tower, ViT-L/14, ViT-B/32) use
QuickGELU, open_clip's bigG exact GELU. The text tower embeds tokens and
learned positions and pools the EOT token through `text_projection`; its
causal mask sends attention to the plain path (77 tokens, masked), as the
JAX package sends it to XLA. The vision tower patchifies with a biasless
conv, prepends the class embedding, adds positions, runs ln_pre, the
blocks and ln_post, and returns (CLS @ proj, the patch tokens); its
attention is unmasked over 257 tokens at 224 px and patch 14, so the flash
forward runs on a CUDA tensor. `preprocess_images` is the bicubic resize
(antialiased, as jax.image.resize) and the CLIP normalisation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.ops.attention import dot_product_attention


# OpenAI CLIP normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionConfig(NamedTuple):
    image_size: int = 224
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_ratio: float = 4.9231  # bigG
    output_dim: int = 1280
    quick_gelu: bool = False  # OpenAI towers (L/14, B/32) use QuickGELU

    @staticmethod
    def bigG() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        return CLIPVisionConfig(patch_size=14, width=1024, layers=24,
                                heads=16, mlp_ratio=4.0, output_dim=768,
                                quick_gelu=True)

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig(patch_size=32, width=768, layers=12,
                                heads=12, mlp_ratio=4.0, output_dim=512,
                                quick_gelu=True)

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, width=32,
                                layers=2, heads=4, mlp_ratio=4.0,
                                output_dim=24)


class CLIPTextConfig(NamedTuple):
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1280
    layers: int = 32
    heads: int = 20
    output_dim: int = 1280
    quick_gelu: bool = False

    @staticmethod
    def bigG() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """SD-1.5's text encoder (OpenAI CLIP ViT-L/14: QuickGELU)."""
        return CLIPTextConfig(width=768, layers=12, heads=12,
                              output_dim=768, quick_gelu=True)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=128, context_length=16, width=32,
                              layers=2, heads=4, output_dim=24)


class _Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float,
                 causal: bool = False, quick_gelu: bool = False):
        super().__init__()
        self.heads, self.causal, self.quick_gelu = heads, causal, quick_gelu
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, int(width * mlp_ratio))
        self.mlp_proj = nn.Linear(int(width * mlp_ratio), width)

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)

        def split(y):
            return y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)

        mask = None
        if self.causal:
            mask = torch.ones((t, t), dtype=torch.bool,
                              device=x.device).tril()[None, None]
        out = dot_product_attention(split(q), split(k), split(v), mask=mask)
        x = x + self.out_proj(out.transpose(1, 2).reshape(b, t, d))
        h = self.mlp_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp_proj(h)


class CLIPTextTower(nn.Module):
    """tokens [B, T] int -> (last hidden [B, T, width], pooled
    [B, output_dim]); pooled is the EOT position (the largest token id)
    through `text_projection`."""

    def __init__(self, cfg: CLIPTextConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        with torch.device(resolve_device(device)):
            self.token_embedding = nn.Parameter(
                torch.empty(c.vocab_size, c.width).normal_(std=0.02))
            self.positional_embedding = nn.Parameter(
                torch.empty(c.context_length, c.width).normal_(std=0.01))
            for i in range(c.layers):
                self.add_module(f"resblock_{i}", _Block(
                    c.width, c.heads, 4.0, causal=True,
                    quick_gelu=c.quick_gelu))
            self.ln_final = nn.LayerNorm(c.width, eps=1e-5)
            self.text_projection = nn.Parameter(
                torch.empty(c.width, c.output_dim).normal_(
                    std=c.width ** -0.5))
        self.to(dtype)

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = tokens.shape
        x = self.token_embedding[tokens] + self.positional_embedding[:t][None]
        for i in range(self.cfg.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eot] @ self.text_projection
        return x, pooled


class CLIPVisionTower(nn.Module):
    """Images [B, 3, H, W], resized and CLIP-normalised -> (pooled
    [B, output_dim], the post-ln_post patch tokens [B, N, width])."""

    def __init__(self, cfg: CLIPVisionConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        grid = c.image_size // c.patch_size
        with torch.device(resolve_device(device)):
            self.patch_embed = nn.Conv2d(3, c.width, c.patch_size,
                                         stride=c.patch_size, bias=False)
            self.class_embedding = nn.Parameter(
                torch.empty(c.width).normal_(std=0.02))
            self.positional_embedding = nn.Parameter(
                torch.empty(1 + grid * grid, c.width).normal_(std=0.02))
            self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
            for i in range(c.layers):
                self.add_module(f"resblock_{i}", _Block(
                    c.width, c.heads, c.mlp_ratio, quick_gelu=c.quick_gelu))
            self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
            self.proj = nn.Parameter(torch.empty(c.width, c.output_dim)
                                     .normal_(std=c.width ** -0.5))
        self.to(dtype)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.patch_embed(images).flatten(2).transpose(1, 2)
        b, _, d = x.shape
        x = torch.cat([self.class_embedding.expand(b, 1, d), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding[None])
        for i in range(self.cfg.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_post(x)
        return x[:, 0] @ self.proj, x[:, 1:]


def preprocess_images(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Images [B, 3, H, W] in [0, 1] -> bicubic resize to size x size
    (antialiased, as jax.image.resize(..., "bicubic")) and CLIP
    normalisation."""
    x = F.interpolate(images, size=(size, size), mode="bicubic",
                      antialias=True, align_corners=False)
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)
