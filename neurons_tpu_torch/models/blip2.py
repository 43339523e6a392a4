"""BLIP-2 (OPT) captioner, stage 4.

Counterpart of neurons_tpu/models/blip2.py, the inference path of HF
`Blip2ForConditionalGeneration` that captions the stage-3 keyframes
(Salesforce/blip2-opt-2.7b): the EVA-CLIP ViT-g vision tower (fused qkv,
pre-norm, LayerNorm eps 1e-6) -> the Q-Former (32 learned queries,
post-norm BERT blocks at eps 1e-12, cross-attention on every layer with
i % cross_attention_frequency == 0) -> a linear projection into OPT-2.7B's
embedding space -> greedy decoding (pre-norm OPT layers at eps 1e-5, ReLU
FFN). GELUs are exact, as the JAX modules pass approximate=False.

Attention goes through `ops.attention.dot_product_attention`: the vision
tower's 257 tokens (16 heads of 88) take the flash forward on a CUDA
tensor; the Q-Former's 32 queries and the OPT decoder's masked attention
take the plain path, as the JAX package routes them to XLA.

`generate` is the KV-cached greedy decode: one prefill forward over
[prefix ‖ BOS] fills per-layer [B, nq + max_len, D] caches, then a Python
loop of single-token steps writes its K/V into them in place and attends
over the whole cache with the unwritten slots masked out. The JAX scan's
last step only computes a token it drops; the loop leaves it out, which
changes no token. `generate_nocache` recomputes the whole [prefix ‖
tokens] forward each step and is the cached decode's oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class Blip2VisionConfig:
    hidden_size: int = 1408
    layers: int = 39
    heads: int = 16
    intermediate_size: int = 6144
    patch_size: int = 14
    image_size: int = 224


@dataclass(frozen=True)
class Blip2QFormerConfig:
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    num_query_tokens: int = 32


@dataclass(frozen=True)
class OPTConfig:
    hidden_size: int = 2560
    layers: int = 32
    heads: int = 32
    ffn_dim: int = 10240
    vocab_size: int = 50272
    max_position_embeddings: int = 2048
    bos_token_id: int = 2
    eos_token_id: int = 50118  # '\n', HF blip2's generation stop


@dataclass(frozen=True)
class Blip2Config:
    vision: Blip2VisionConfig = field(default_factory=Blip2VisionConfig)
    qformer: Blip2QFormerConfig = field(default_factory=Blip2QFormerConfig)
    opt: OPTConfig = field(default_factory=OPTConfig)

    @staticmethod
    def tiny() -> "Blip2Config":
        return Blip2Config(
            vision=Blip2VisionConfig(hidden_size=32, layers=2, heads=4,
                                     intermediate_size=64, patch_size=8,
                                     image_size=32),
            qformer=Blip2QFormerConfig(hidden_size=24, layers=2, heads=4,
                                       intermediate_size=48,
                                       num_query_tokens=4),
            # the real EOS 50118 lies outside a 100-token vocabulary
            opt=OPTConfig(hidden_size=40, layers=2, heads=4, ffn_dim=80,
                          vocab_size=100, max_position_embeddings=64,
                          eos_token_id=99))


def _mha(q, k, v, heads, mask=None):
    b, tq, d = q.shape
    hd = d // heads

    def split(y):
        return y.reshape(b, -1, heads, hd).transpose(1, 2)

    out = dot_product_attention(split(q), split(k), split(v), mask=mask)
    return out.transpose(1, 2).reshape(b, tq, d)


class Blip2VisionLayer(nn.Module):
    """HF Blip2EncoderLayer: pre-norm attention (fused qkv), pre-norm MLP."""

    def __init__(self, d: int, heads: int, intermediate: int):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-6)
        self.qkv = nn.Linear(d, 3 * d)
        self.projection = nn.Linear(d, d)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-6)
        self.fc1 = nn.Linear(d, intermediate)
        self.fc2 = nn.Linear(intermediate, d)

    def forward(self, x):
        q, k, v = self.qkv(self.layer_norm1(x)).chunk(3, dim=-1)
        x = x + self.projection(_mha(q, k, v, self.heads))
        return x + self.fc2(F.gelu(self.fc1(self.layer_norm2(x))))


class Blip2VisionModel(nn.Module):
    """Images [B, 3, H, W] (BLIP-normalised) -> tokens [B, N + 1, D]."""

    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.cfg = c = cfg
        d = c.hidden_size
        self.patch_embed = nn.Conv2d(3, d, c.patch_size, stride=c.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(torch.empty(
            (c.image_size // c.patch_size) ** 2 + 1, d).normal_(std=0.02))
        for i in range(c.layers):
            self.add_module(f"layer_{i}", Blip2VisionLayer(
                d, c.heads, c.intermediate_size))
        self.post_layernorm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x):
        tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        b, n, d = tokens.shape
        tokens = torch.cat([self.class_embedding.expand(b, 1, d), tokens], 1)
        tokens = tokens + self.position_embedding[None, :n + 1]
        for i in range(self.cfg.layers):
            tokens = getattr(self, f"layer_{i}")(tokens)
        return self.post_layernorm(tokens)


class QFormerAttention(nn.Module):
    """BERT-style post-norm attention: LN(dense(attn) + residual)."""

    def __init__(self, d: int, kv_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_dim, d)
        self.value = nn.Linear(kv_dim, d)
        self.out_dense = nn.Linear(d, d)
        self.out_ln = nn.LayerNorm(d, eps=1e-12)

    def forward(self, x, kv):
        h = self.out_dense(_mha(self.query(x), self.key(kv), self.value(kv),
                                self.heads))
        return self.out_ln(h + x)


class QFormerLayer(nn.Module):
    def __init__(self, d: int, heads: int, intermediate: int, has_cross: bool,
                 vision_dim: int):
        super().__init__()
        self.attention = QFormerAttention(d, d, heads)
        if has_cross:
            self.crossattention = QFormerAttention(d, vision_dim, heads)
        self.intermediate_query = nn.Linear(d, intermediate)
        self.output_query = nn.Linear(intermediate, d)
        self.output_ln = nn.LayerNorm(d, eps=1e-12)

    def forward(self, x, image_embeds):
        x = self.attention(x, x)
        if hasattr(self, "crossattention"):
            x = self.crossattention(x, image_embeds)
        h = self.output_query(F.gelu(self.intermediate_query(x)))
        return self.output_ln(h + x)


class Blip2QFormer(nn.Module):
    """Query tokens [B, Q, D] x image tokens -> query outputs [B, Q, D]
    (the caption path: no text input)."""

    def __init__(self, cfg: Blip2QFormerConfig, vision_dim: int):
        super().__init__()
        self.cfg = c = cfg
        d = c.hidden_size
        self.layernorm = nn.LayerNorm(d, eps=1e-12)
        for i in range(c.layers):
            self.add_module(f"layer_{i}", QFormerLayer(
                d, c.heads, c.intermediate_size,
                i % c.cross_attention_frequency == 0, vision_dim))

    def forward(self, query_tokens, image_embeds):
        x = self.layernorm(query_tokens)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, image_embeds)
        return x


class OPTDecoderLayer(nn.Module):
    """OPT-2.7b layer (do_layer_norm_before): pre-norm attention, pre-norm
    ReLU FFN. With `cache=(k_cache, v_cache)` ([B, T_total, D] each) and a
    write `index`, the chunk's K/V is written in place at [index, index +
    t) and attention runs over the whole cache; the caller's mask excludes
    the unwritten slots, which hold zeros."""

    def __init__(self, d: int, heads: int, ffn_dim: int):
        super().__init__()
        self.heads = heads
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d)

    def forward(self, x, mask, cache=None, index: Optional[int] = None):
        h = self.self_attn_layer_norm(x)
        q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        if cache is not None:
            ck, cv = cache
            ck[:, index:index + x.shape[1]] = k
            cv[:, index:index + x.shape[1]] = v
            k, v = ck, cv
        x = x + self.out_proj(_mha(q, k, v, self.heads, mask=mask))
        h = F.relu(self.fc1(self.final_layer_norm(x)))
        return x + self.fc2(h)


class OPTModel(nn.Module):
    """inputs_embeds [B, T, D] and an attention mask [B, T] -> the final
    hidden states [B, T, D]. Positions follow OPT: cumsum(mask) - 1,
    clipped at 0, offset 2."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = c = cfg
        d = c.hidden_size
        self.embed_positions = nn.Parameter(torch.empty(
            c.max_position_embeddings + 2, d).normal_(std=0.02))
        for i in range(c.layers):
            self.add_module(f"layer_{i}", OPTDecoderLayer(d, c.heads,
                                                          c.ffn_dim))
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, inputs_embeds, attn_mask,
                cache: Optional[List[Tuple[torch.Tensor,
                                           torch.Tensor]]] = None,
                index: Optional[int] = None):
        b, t, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if cache is None:
            positions = (torch.cumsum(attn_mask, dim=1) - 1).clamp(min=0)
            causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
            mask = causal[None, None] & attn_mask[:, None, None, :].bool()
        else:
            # every slot up to `index` holds a real token, so the slot is
            # the OPT position; keys past the chunk's causal frontier are
            # unwritten zeros and stay masked out
            t_cache = cache[0][0].shape[1]
            rows = index + torch.arange(t, device=dev)
            positions = rows[None].expand(b, t)
            mask = (torch.arange(t_cache, device=dev)[None, :]
                    <= rows[:, None])[None, None]
        x = inputs_embeds + self.embed_positions[positions + 2]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(
                x, mask, cache=None if cache is None else cache[i],
                index=index)
        return self.final_layer_norm(x)


class Blip2Captioner(nn.Module):
    """The stage-4 model. `forward` returns LM logits for teacher-forced
    tokens; `generate` greedy-decodes captions."""

    def __init__(self, cfg: Blip2Config, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device)
        if dev.type != "meta":
            dev = resolve_device(device)
        qc, oc = cfg.qformer, cfg.opt
        with dev:
            self.vision_model = Blip2VisionModel(cfg.vision)
            self.qformer = Blip2QFormer(qc, cfg.vision.hidden_size)
            self.query_tokens = nn.Parameter(torch.empty(
                1, qc.num_query_tokens, qc.hidden_size).normal_(std=0.02))
            self.language_projection = nn.Linear(qc.hidden_size,
                                                 oc.hidden_size)
            self.embed_tokens = nn.Parameter(torch.empty(
                oc.vocab_size, oc.hidden_size).normal_(std=0.02))
            self.lm = OPTModel(oc)
        self.to(dtype)

    def _prefix(self, images):
        image_embeds = self.vision_model(images)
        q = self.query_tokens.expand(images.shape[0], -1, -1)
        return self.language_projection(self.qformer(q, image_embeds))

    def forward(self, images, input_ids):
        """images [B, 3, H, W], input_ids [B, T] -> logits [B, Q + T, V]."""
        x = torch.cat([self._prefix(images), self.embed_tokens[input_ids]], 1)
        mask = torch.ones(x.shape[:2], dtype=torch.long, device=x.device)
        return self.lm(x, mask) @ self.embed_tokens.T

    def generate(self, images, max_len: int = 30) -> torch.Tensor:
        """Greedy caption ids [B, max_len]: BOS first, then the argmax
        tokens; once a row emits EOS, its later slots hold EOS."""
        c = self.cfg.opt
        prefix = self._prefix(images)
        b, nq, d = prefix.shape
        dev = prefix.device
        emb = self.embed_tokens
        cache = [(prefix.new_zeros((b, nq + max_len, d)),
                  prefix.new_zeros((b, nq + max_len, d)))
                 for _ in range(c.layers)]
        tokens = torch.full((b, max_len), c.eos_token_id, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = c.bos_token_id
        if max_len == 1:
            return tokens
        # the prefill predicts token slot 1
        x = torch.cat([prefix, emb[tokens[:, :1]]], 1)
        h = self.lm(x, None, cache=cache, index=0)
        nxt = (h[:, -1] @ emb.T).argmax(-1)
        done = nxt == c.eos_token_id
        tokens[:, 1] = nxt
        for i in range(1, max_len - 1):
            h = self.lm(emb[nxt][:, None], None, cache=cache, index=nq + i)
            nxt = (h[:, 0] @ emb.T).argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, c.eos_token_id), nxt)
            done = done | (nxt == c.eos_token_id)
            tokens[:, i + 1] = nxt
        return tokens

    def generate_nocache(self, images, max_len: int = 30) -> torch.Tensor:
        """The full-recompute greedy decode (the whole [prefix ‖ tokens]
        forward a step): the oracle of `generate`."""
        c = self.cfg.opt
        prefix = self._prefix(images)
        b, nq, _ = prefix.shape
        dev = prefix.device
        tokens = torch.full((b, max_len), c.eos_token_id, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = c.bos_token_id
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(max_len - 1):
            x = torch.cat([prefix, self.embed_tokens[tokens]], 1)
            mask = torch.cat([
                torch.ones((b, nq), dtype=torch.long, device=dev),
                (torch.arange(max_len, device=dev) <= i).long()[None]
                .expand(b, max_len)], 1)
            h = self.lm(x, mask)
            nxt = (h[:, nq + i] @ self.embed_tokens.T).argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, c.eos_token_id), nxt)
            done = done | (nxt == c.eos_token_id)
            tokens[:, i + 1] = nxt
        return tokens
