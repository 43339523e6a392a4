"""GPT-2 language model + CLIP-prefix caption decoder.

Counterpart of neurons_tpu/models/gpt2.py: a projected CLIP-text vector is
prepended to the token embeddings as a one-token prefix; GPT-2 blocks
(ln_1 -> causal attention -> residual, ln_2 -> mlp(gelu_new) -> residual),
learned wpe, LM head tied to wte. Greedy decoding recomputes the fixed
1 + max_len window every step, as the JAX scan does; the causal mask sends
its attention to the plain path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from neurons_tpu_torch.ops.attention import dot_product_attention


class GPT2Config(NamedTuple):
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


def tiny_gpt2_config() -> GPT2Config:
    return GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                      n_head=4)


def gelu_new(x):
    """HF 'gelu_new' (tanh approximation), GPT-2's activation."""
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * torch.pow(x, 3.0))))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        d = cfg.n_embd
        self.n_head = cfg.n_head
        self.ln_1 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon)
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon)
        self.mlp_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = self.c_attn(self.ln_1(x)).chunk(3, dim=-1)

        def split(y):
            return y.reshape(b, t, self.n_head, d // self.n_head).transpose(1, 2)

        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        attn = dot_product_attention(split(q), split(k), split(v),
                                     mask=mask[None, None])
        x = x + self.c_proj(attn.transpose(1, 2).reshape(b, t, d))
        return x + self.mlp_proj(gelu_new(self.mlp_fc(self.ln_2(x))))


class _InnerLM(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.n_layer = cfg.n_layer
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd)
                                .normal_(std=0.01))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", GPT2Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, inputs_embeds, wte, head_position: Optional[int] = None):
        """head_position: when given, only that position goes through the
        vocab head -> [B, 1, V]."""
        t = inputs_embeds.shape[1]
        x = inputs_embeds + self.wpe[:t][None]
        for i in range(self.n_layer):
            x = getattr(self, f"h_{i}")(x)
        x = self.ln_f(x)
        if head_position is not None:
            x = x[:, head_position:head_position + 1]
        return x @ wte.T


class TextDecoder(nn.Module):
    """CLIP-prefix captioner: clip_project (prefix_size -> n_embd),
    prefix-concat, GPT-2 LM."""

    def __init__(self, cfg: GPT2Config, prefix_size: int = 1280):
        super().__init__()
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd)
                                .normal_(std=0.02))
        self.clip_project = nn.Linear(prefix_size, cfg.n_embd)
        self.lm = _InnerLM(cfg)

    def forward(self, clip_features, tokens):
        """-> logits [B, 1 + T, vocab] (the prefix position included)."""
        prefix = self.clip_project(clip_features)[:, None]
        x = torch.cat([prefix, self.wte[tokens]], dim=1)
        return self.lm(x, self.wte)

    def greedy_decode(self, clip_features, max_len: int = 60,
                      eot_token: int = 49407) -> torch.Tensor:
        """Argmax decoding from the CLIP prefix; positions after EOT are
        filled with EOT. Returns [B, max_len] int64 token ids."""
        b = clip_features.shape[0]
        prefix = self.clip_project(clip_features)[:, None]
        tokens = torch.zeros((b, max_len), dtype=torch.int64,
                             device=clip_features.device)
        done = torch.zeros((b,), dtype=torch.bool, device=clip_features.device)
        for i in range(max_len):
            x = torch.cat([prefix, self.wte[tokens]], dim=1)
            logits = self.lm(x, self.wte, head_position=i)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, eot_token), nxt)
            tokens[:, i] = nxt
            done = done | (nxt == eot_token)
        return tokens
