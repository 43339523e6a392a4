"""T5 v1.1 text encoder (sgm's FrozenT5Embedder / FrozenByT5Embedder).

Counterpart of neurons_tpu/models/t5.py: RMSNorm pre-norm with its
variance in f32, unscaled attention (T5 folds 1/sqrt(d) into its init)
with the bucketed relative-position bias of block 0 shared by every
block, gated GELU (tanh form) feed-forward, every linear bias-free. The
JAX package computes the attention with plain einsums, no Pallas kernel;
so does the port (matmuls).

The T5 SentencePiece tokenizer needs its .model file: callers pass ids.
ByT5 needs no file: `byt5_tokenize` (utf-8 byte + 3, eos 1, pad 0).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device


class T5Config(NamedTuple):
    vocab_size: int = 32128
    d_model: int = 4096  # t5-v1_1-xxl
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_v1_1_xxl() -> T5Config:
    return T5Config()


def byt5_base() -> T5Config:
    return T5Config(vocab_size=384, d_model=1536, d_kv=64, d_ff=3968,
                    num_layers=12, num_heads=12)


def byt5_tokenize(texts: List[str], max_length: int = 77) -> np.ndarray:
    """ByT5 byte tokenizer: id = utf-8 byte + 3, eos 1, pad 0 (HF
    ByT5Tokenizer; reference modules.py:303-341)."""
    out = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        ids = [b + 3 for b in t.encode("utf-8")][: max_length - 1] + [1]
        out[i, : len(ids)] = ids
    return out


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """HF T5's bidirectional bucketing: half the buckets for each sign,
    exact below max_exact, logarithmic beyond. The logarithm is taken in
    f32 in JAX's order, log(n / max_exact + 1e-9) / log(max_distance /
    max_exact) * (buckets - max_exact): f64, or another order, moves a
    bucket at the logarithmic boundaries."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    f32 = torch.float32
    log_ratio = torch.tensor(np.float32(math.log(max_distance / max_exact)),
                             dtype=f32)
    x = (torch.log(n.to(f32) / torch.tensor(max_exact, dtype=f32)
                   + torch.tensor(1e-9, dtype=f32)) / log_ratio
         * torch.tensor(num_buckets - max_exact, dtype=f32))
    large = torch.clamp(max_exact + x.to(torch.int32), max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), large)


class T5RMSNorm(nn.Module):
    flax_weight = "weight"  # the flax leaf's name (`jax_tree`)

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = c = cfg
        inner = c.num_heads * c.d_kv
        self.attn_norm = T5RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.q = nn.Linear(c.d_model, inner, bias=False)
        self.k = nn.Linear(c.d_model, inner, bias=False)
        self.v = nn.Linear(c.d_model, inner, bias=False)
        self.o = nn.Linear(inner, c.d_model, bias=False)
        self.ff_norm = T5RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x, bias):
        c = self.cfg
        b, t, _ = x.shape
        h = self.attn_norm(x)

        def split(y):
            return y.reshape(b, t, c.num_heads, c.d_kv).transpose(1, 2)

        q, k, v = split(self.q(h)), split(self.k(h)), split(self.v(h))
        # unscaled: the 1/sqrt(d) is folded into T5's init
        logits = torch.matmul(q, k.transpose(-1, -2)) + bias
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, -1)
        x = x + self.o(o)
        h = self.ff_norm(x)
        g = F.gelu(self.wi_0(h), approximate="tanh")
        return x + self.wo(g * self.wi_1(h))


class T5Encoder(nn.Module):
    """input_ids [B, T] -> the last hidden state [B, T, d_model] (the
    reference's `outputs.last_hidden_state`). `shared` and
    `relative_attention_bias` start N(0, 1) as flax's init draws them."""

    def __init__(self, cfg: T5Config, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        with torch.device(resolve_device(device)):
            self.shared = nn.Parameter(torch.randn(c.vocab_size, c.d_model))
            self.relative_attention_bias = nn.Parameter(torch.randn(
                c.relative_attention_num_buckets, c.num_heads))
            for i in range(c.num_layers):
                self.add_module(f"block_{i}", T5Block(c))
            self.final_norm = T5RMSNorm(c.d_model, c.layer_norm_epsilon)
        self.to(dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        ids = torch.as_tensor(input_ids, device=self.shared.device).long()
        x = self.shared[ids]
        t = ids.shape[-1]
        pos = torch.arange(t, device=ids.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], c.relative_attention_num_buckets,
            c.relative_attention_max_distance)
        bias = self.relative_attention_bias[buckets.long()]  # [T, T, H]
        bias = bias.permute(2, 0, 1)[None].to(x.dtype)       # [1, H, T, T]
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, bias)
        return self.final_norm(x)


def import_t5_encoder(state_dict, cfg):
    """Kept here as an alias; the importer lives in interop."""
    from neurons_tpu_torch.interop.torch_import import \
        import_t5_encoder as _f
    return _f(state_dict, cfg)
