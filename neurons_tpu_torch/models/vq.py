"""Autoencoder latent regularizers and vector quantizers.

Counterpart of neurons_tpu/models/vq.py (the reference's sgm regularizer
zoo: DiagonalGaussianRegularizer, Identity and measure_perplexity,
GumbelQuantizer, VectorQuantizer, EMAVectorQuantizer and
VectorQuantizerWithInputProjection).

- The nearest-code search is one [N, n_e] product, z^2 + e^2 - 2 z e^T,
  then argmin (ties go to the lowest index, in both packages); the JAX
  package computes it outside any Pallas kernel.
- Straight-through estimators `.detach()` where JAX stops the gradient.
- The EMA codebook's `ema` collection is three registered buffers
  (`weight`, `cluster_size`, `embed_avg`), moved only by a call with
  `update=True`. In place of JAX's `axis_name`, an optional
  `torch.distributed` process group sums the two batch statistics before
  the EMA, as the JAX `psum` does.
- Draws (the KL posterior's noise, the remap's random slots, the Gumbel
  noise) are explicit tensors or a `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def measure_perplexity(indices: torch.Tensor, num_centroids: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook usage perplexity (reference regularizers/base.py:29-40)."""
    encodings = F.one_hot(indices.reshape(-1).long(), num_centroids).float()
    avg_probs = encodings.mean(dim=0)
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs
                                                            + 1e-10)))
    return perplexity, (avg_probs > 0).sum()


def identity_regularizer(z: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """reference regularizers/base.py:21-26."""
    return z, {}


def diagonal_gaussian_regularizer(z: torch.Tensor,
                                  noise: Optional[torch.Tensor] = None,
                                  sample: bool = True,
                                  generator: Optional[torch.Generator] = None
                                  ) -> Tuple[torch.Tensor, Dict]:
    """KL-to-N(0, 1) regularizer over encoder moments z [B, 2C, H, W]
    (reference regularizers/__init__.py:13-31). Samples the posterior from
    `noise` (or a draw of `generator`) when `sample`, else its mode; with
    neither it returns the mode, as JAX does without a key."""
    mean, logvar = z.chunk(2, dim=1)
    out = sample_posterior(mean, logvar, noise, generator) if sample else mean
    return out, {"kl_loss": kl_to_standard(mean, logvar)}


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, the logvar clipped to [-30, 20];
    the noise drawn from `generator` when not given; with neither, the
    mode (the mean)."""
    if noise is None and generator is None:
        return mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


def kl_to_standard(mean: torch.Tensor, logvar: torch.Tensor
                   ) -> torch.Tensor:
    """KL(N(mean, exp(logvar)) || N(0, 1)) summed over all but the batch
    axis, then averaged over the batch (logvar clipped to [-30, 20])."""
    lv = logvar.clamp(-30.0, 20.0)
    kl = 0.5 * torch.sum(mean ** 2 + torch.exp(lv) - 1.0 - lv,
                         dim=tuple(range(1, mean.dim())))
    return kl.sum() / kl.shape[0]


def remap_to_used(inds: torch.Tensor, used: torch.Tensor,
                  unknown_index="random",
                  generator: Optional[torch.Generator] = None,
                  re_embed: Optional[int] = None,
                  draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-codebook indices -> positions in the `used` subset (reference
    quantize.py:26-41). Unknown codes go to a random used slot
    (`unknown_index="random"`: `draws`, integers in [0, re_embed or
    len(used)) shaped like `inds`, or a draw of `generator`) or to a fixed
    index."""
    used = torch.as_tensor(used, device=inds.device)
    match = inds[..., None] == used
    new = match.long().argmax(dim=-1)
    unknown = ~match.any(dim=-1)
    if unknown_index == "random":
        if draws is None:
            if generator is None:
                raise ValueError("unknown_index='random' needs draws or a "
                                 "generator")
            draws = torch.randint(0, re_embed or used.shape[0], inds.shape,
                                  generator=generator, device=inds.device)
        return torch.where(unknown, draws.to(new.dtype), new)
    return torch.where(unknown, torch.full_like(new, unknown_index), new)


def unmap_to_all(inds: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """Inverse of remap_to_used (reference quantize.py:43-52); extra
    tokens (index >= len(used)) collapse to code 0."""
    used = torch.as_tensor(used, device=inds.device)
    inds = torch.where(inds >= used.shape[0], torch.zeros_like(inds), inds)
    return used[inds]


def _nearest_codes(z_flat: torch.Tensor, codebook: torch.Tensor
                   ) -> torch.Tensor:
    """argmin_j ||z - e_j||^2 through z^2 + e^2 - 2 z e^T (one product)."""
    d = (torch.sum(z_flat ** 2, dim=1, keepdim=True)
         + torch.sum(codebook ** 2, dim=1)
         - 2.0 * torch.matmul(z_flat, codebook.t()))
    return torch.argmin(d, dim=1)


class VectorQuantizer(nn.Module):
    """VQ-VAE bottleneck (reference quantize.py:172-320): nearest-code
    lookup, commitment loss beta ||z - sg[e]||^2 + ||sg[z] - e||^2,
    straight-through gradients. Rank-4 input is NCHW; rank <= 3 is
    quantized on its last axis. The codebook is `weight` [n_e, e_dim]
    (flax's `embedding`)."""

    flax_weight = "embedding"  # the flax leaf `jax_tree` names `weight`

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 sane_index_shape: bool = False,
                 log_perplexity: bool = False, loss_key: str = "loss/vq"):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.sane_index_shape = sane_index_shape
        self.log_perplexity = log_perplexity
        self.loss_key = loss_key
        lim = 1.0 / n_e
        self.weight = nn.Parameter(torch.empty(n_e, e_dim).uniform_(-lim,
                                                                    lim))

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        do_reshape = z.dim() == 4
        if do_reshape:
            z = z.permute(0, 2, 3, 1)  # NCHW -> NHWC
        idx = _nearest_codes(z.reshape(-1, self.e_dim), self.weight)
        z_q = self.weight[idx].reshape(z.shape)
        out: Dict = {}
        if self.log_perplexity:
            perp, usage = measure_perplexity(idx, self.n_e)
            out.update({"perplexity": perp, "cluster_usage": usage})
        out[self.loss_key] = (
            self.beta * torch.mean((z_q.detach() - z) ** 2)
            + torch.mean((z_q - z.detach()) ** 2))
        z_q = z + (z_q - z).detach()  # straight-through
        if do_reshape:
            z_q = z_q.permute(0, 3, 1, 2)
            if self.sane_index_shape:
                idx = idx.reshape(z_q.shape[0], z_q.shape[2], z_q.shape[3])
        elif self.sane_index_shape:
            idx = idx.reshape(z_q.shape[0], -1)
        out["min_encoding_indices"] = idx
        return z_q, out

    def get_codebook_entry(self, indices: torch.Tensor,
                           shape: Optional[Tuple[int, ...]] = None
                           ) -> torch.Tensor:
        z_q = self.weight[indices]
        if shape is not None:
            z_q = z_q.reshape(shape).permute(0, 3, 1, 2)
        return z_q


class VectorQuantizerWithInputProjection(nn.Module):
    """reference quantize.py:446-487: project into the codebook space,
    quantize, project out; spatial axes flatten to a token axis."""

    def __init__(self, input_dim: int, n_codes: int, codebook_dim: int,
                 beta: float = 1.0, output_dim: int = 0):
        super().__init__()
        self.output_dim = output_dim
        self.proj_in = nn.Linear(input_dim, codebook_dim)
        self.quant = VectorQuantizer(n_codes, codebook_dim, beta)
        if output_dim:
            self.proj_out = nn.Linear(codebook_dim, output_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        in_shape = z.shape
        rearr = z.dim() > 3 and self.output_dim
        if z.dim() > 3:  # b c ... -> b (...) c
            z = z.reshape(in_shape[0], in_shape[1], -1).transpose(1, 2)
        z_q, out = self.quant(self.proj_in(z))
        if self.output_dim:
            z_q = self.proj_out(z_q)
        if rearr:
            if len(in_shape) not in (4, 5):
                raise NotImplementedError(len(in_shape))
            z_q = z_q.transpose(1, 2).reshape((in_shape[0], -1)
                                              + tuple(in_shape[2:]))
        return z_q, out


class EMAVectorQuantizer(nn.Module):
    """reference quantize.py:323-443: a codebook kept by an EMA of the
    batch statistics instead of gradient descent. Its state is the buffers
    `weight`, `cluster_size` and `embed_avg`; a call with `update=True`
    moves them. Input NCHW. With `process_group`, the per-code counts and
    sums are summed over the group (all_reduce) before the EMA."""

    def __init__(self, n_embed: int, embedding_dim: int, beta: float,
                 decay: float = 0.99, eps: float = 1e-5,
                 loss_key: str = "loss/vq", process_group=None):
        super().__init__()
        self.n_embed, self.embedding_dim = n_embed, embedding_dim
        self.beta, self.decay, self.eps = beta, decay, eps
        self.loss_key = loss_key
        self.process_group = process_group
        weight = torch.randn(n_embed, embedding_dim)
        self.register_buffer("weight", weight)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", weight.clone())

    def forward(self, z: torch.Tensor, update: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        zt = z.permute(0, 2, 3, 1)  # NCHW -> NHWC
        zf = zt.reshape(-1, self.embedding_dim)
        idx = _nearest_codes(zf, self.weight)
        z_q = self.weight[idx].reshape(zt.shape)
        encodings = F.one_hot(idx, self.n_embed).to(z.dtype)
        avg_probs = encodings.mean(dim=0)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs
                                                                + 1e-10)))
        if update:
            self._ema_update(encodings, zf)
        loss = self.beta * torch.mean((z_q.detach() - zt) ** 2)
        z_q = (zt + (z_q - zt).detach()).permute(0, 3, 1, 2)
        return z_q, {self.loss_key: loss, "encodings": encodings,
                     "encoding_indices": idx, "perplexity": perplexity}

    @torch.no_grad()
    def _ema_update(self, encodings: torch.Tensor, zf: torch.Tensor):
        enc_sum = encodings.sum(dim=0)
        embed_sum = torch.matmul(encodings.t(), zf.detach())
        if self.process_group is not None:
            import torch.distributed as dist
            dist.all_reduce(enc_sum, group=self.process_group)
            dist.all_reduce(embed_sum, group=self.process_group)
        d = self.decay
        self.cluster_size.copy_(d * self.cluster_size + (1 - d) * enc_sum)
        self.embed_avg.copy_(d * self.embed_avg + (1 - d) * embed_sum)
        n = self.cluster_size.sum()
        smoothed = ((self.cluster_size + self.eps)
                    / (n + self.n_embed * self.eps) * n)
        self.weight.copy_(self.embed_avg / smoothed[:, None])


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer (reference quantize.py:64-169): 1x1-conv
    logits over codes, a Gumbel-softmax sample (hard straight-through in
    eval), a KL-to-uniform regularizer. Input NCHW; `gumbel` is the noise,
    [B, H, W, n_embed] (None: zeros, the deterministic path)."""

    def __init__(self, num_hiddens: int, embedding_dim: int, n_embed: int,
                 straight_through: bool = True, kl_weight: float = 5e-4,
                 temp_init: float = 1.0, loss_key: str = "loss/vq"):
        super().__init__()
        self.n_embed = n_embed
        self.straight_through = straight_through
        self.kl_weight, self.temp_init = kl_weight, temp_init
        self.loss_key = loss_key
        self.proj = nn.Conv2d(num_hiddens, n_embed, 1)
        self.embed = nn.Parameter(torch.randn(n_embed, embedding_dim))

    def forward(self, z: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                temp: Optional[float] = None, training: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        hard = self.straight_through if training else True
        tau = self.temp_init if temp is None else temp
        logits = self.proj(z).permute(0, 2, 3, 1)  # NHWC
        if gumbel is None:
            gumbel = torch.zeros_like(logits)
        y = torch.softmax((logits + gumbel) / tau, dim=-1)
        if hard:
            y_hard = F.one_hot(y.argmax(dim=-1), self.n_embed).to(y.dtype)
            y = y + (y_hard - y).detach()
        z_q = torch.matmul(y, self.embed).permute(0, 3, 1, 2)
        qy = torch.softmax(logits, dim=-1)
        diff = self.kl_weight * torch.mean(
            torch.sum(qy * torch.log(qy * self.n_embed + 1e-10), dim=-1))
        return z_q, {self.loss_key: diff, "indices": y.argmax(dim=-1)}
