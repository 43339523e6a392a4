"""CLIP text tower (causal transformer), the stage-5 prompt encoder.

Counterpart of the text half of neurons_tpu/models/clip.py: token and
learned positional embeddings, pre-norm blocks (ln_1 -> causal attention ->
residual, ln_2 -> MLP -> residual), ln_final, and the pooled EOT token
through `text_projection`. SD-1.5's tower (`CLIPTextConfig.sd15()`, OpenAI
ViT-L/14 text) uses QuickGELU; other towers exact GELU. Every LayerNorm
uses eps 1e-5. The causal mask sends its attention to the plain path (77
tokens, masked), as the JAX package sends it to XLA. The vision tower is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.ops.attention import dot_product_attention


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
