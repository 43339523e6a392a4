"""Loss terms and retrieval metrics of stages 1 and 2, plain PyTorch.

Counterpart of neurons_tpu/training/losses.py: BiMixCo voxel mixup
(`mixco`) and bidirectional InfoNCE with its soft targets (`mixco_nce`),
SoftCLIP, Dice on sigmoid logits, multi-label BCE, token cross-entropy
with ignore index and label smoothing, L1, the cosine-annealed
temperature, L2 normalisation, the retrieval metrics of the stage-1 eval
and the NaN guard. Every reduction is a mean over all elements, as in the
JAX package. Random draws are explicit: `mixco` takes them as tensors
(`MixcoState`) or from a torch.Generator. The two losses that are ratios
of sums over the batch (Dice and the token cross-entropy) take `across`, a
sum over the process group's ranks (`parallel.distributed.
sum_across_ranks`), to sum over the global batch from this rank's rows.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F


class MixcoState(NamedTuple):
    """Mixup bookkeeping produced by `mixco`, consumed by `mixco_nce`."""

    perm: torch.Tensor    # [B] int64 permutation
    betas: torch.Tensor   # [B] mixing coefficients (1 where not mixed)
    select: torch.Tensor  # [B] bool, which rows were mixed


def draw_mixco(b: int, generator: torch.Generator, beta: float = 0.15,
               s_thresh: float = 0.5) -> MixcoState:
    """Raw mixup draws on the generator's device: a permutation, Beta(beta,
    beta) coefficients (drawn in float64 as a ratio of gammas, cast to f32)
    and the rows to mix (uniform <= s_thresh)."""
    device = generator.device
    perm = torch.randperm(b, generator=generator, device=device)
    alpha = torch.full((2, b), beta, dtype=torch.float64, device=device)
    g = torch._standard_gamma(alpha, generator=generator)
    betas = (g[0] / (g[0] + g[1])).float()
    select = torch.rand((b,), generator=generator, device=device) <= s_thresh
    return MixcoState(perm, betas, select)


def mixco(voxels: torch.Tensor,
          draws: Union[MixcoState, torch.Generator], beta: float = 0.15,
          s_thresh: float = 0.5) -> Tuple[torch.Tensor, MixcoState]:
    """BiMixCo voxel mixup: each selected row i becomes
    beta_i * v_i + (1 - beta_i) * v_perm(i); unselected rows keep
    beta_i = 1. `draws` holds the raw draws (`draw_mixco`) or is a
    generator to draw them from. Returns the mixed voxels and the state
    with the effective betas."""
    if isinstance(draws, torch.Generator):
        draws = draw_mixco(voxels.shape[0], draws, beta, s_thresh)
    perm, select = draws.perm.to(voxels.device), draws.select.to(voxels.device)
    betas = torch.where(select, draws.betas.to(voxels.device),
                        1.0).to(voxels.dtype)
    bshape = (-1,) + (1,) * (voxels.dim() - 1)
    mixed = (voxels * betas.reshape(bshape)
             + voxels[perm] * (1 - betas).reshape(bshape))
    return mixed, MixcoState(perm, betas, select)


def _mix_probs(state: MixcoState) -> torch.Tensor:
    """Soft target matrix: probs[i, i] = beta_i, probs[i, perm[i]] =
    1 - beta_i. Where perm[i] == i the second write overwrites the
    diagonal with 1 - beta_i, as the reference's scatter does."""
    b = state.betas.shape[0]
    probs = torch.diag(state.betas)
    probs[torch.arange(b, device=probs.device), state.perm] = 1.0 - state.betas
    return probs


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def mixco_nce(preds: torch.Tensor, targs: torch.Tensor, temp: float = 0.1,
              state: Optional[MixcoState] = None,
              bidirectional: bool = True) -> torch.Tensor:
    """Bidirectional InfoNCE, rows expected L2-normalised: against the
    mixup soft targets of `state`, or with the diagonal as targets."""
    brain_clip = (preds @ targs.T) / temp
    if state is not None:
        probs = _mix_probs(state)
        loss = -(F.log_softmax(brain_clip, dim=-1) * probs).sum(-1).mean()
        if bidirectional:
            loss2 = -(F.log_softmax(brain_clip.T, dim=-1)
                      * probs.T).sum(-1).mean()
            loss = (loss + loss2) / 2
        return loss
    labels = torch.arange(brain_clip.shape[0], device=preds.device)
    loss = _xent(brain_clip, labels)
    if bidirectional:
        loss = (loss + _xent(brain_clip.T, labels)) / 2
    return loss


def soft_clip_loss(preds: torch.Tensor, targs: torch.Tensor,
                   temp=0.125) -> torch.Tensor:
    """CLIP-teacher-softened bidirectional contrastive loss; rows should be
    L2-normalised. `temp` may be a float or a 0-d tensor."""
    clip_clip = (targs @ targs.T) / temp
    brain_clip = (preds @ targs.T) / temp
    soft = torch.softmax(clip_clip, dim=-1)
    loss1 = -(F.log_softmax(brain_clip, dim=-1) * soft).sum(-1).mean()
    loss2 = -(F.log_softmax(brain_clip.T, dim=-1) * soft).sum(-1).mean()
    return (loss1 + loss2) / 2


#: a sum over the process group's ranks (`distributed.sum_across_ranks`)
Across = Optional[Callable[[torch.Tensor], torch.Tensor]]


def dice_loss(pred_logits: torch.Tensor, mask: torch.Tensor,
              smooth: float = 1e-7, across: Across = None) -> torch.Tensor:
    """Dice loss on sigmoid logits, over the whole batch (with `across`,
    the global batch)."""
    p = torch.sigmoid(pred_logits)
    intersection = torch.sum(p * mask)
    union = torch.sum(p) + torch.sum(mask)
    if across is not None:
        intersection, union = across(torch.stack([intersection, union]))
    return 1.0 - (2.0 * intersection + smooth) / (union + smooth)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-label BCE on logits, mean over all elements."""
    return -(labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits)).mean()


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 0,
                         label_smoothing: float = 0.1,
                         across: Across = None) -> torch.Tensor:
    """Token cross-entropy with an ignored label and label smoothing:
    (1 - eps) * nll + eps * mean over classes of -logp, averaged over the
    tokens that are not ignored (with `across`, those of the global
    batch)."""
    n_classes = logits.shape[-1]
    logits = logits.reshape(-1, n_classes)
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(-1))
    total = torch.where(valid, per_tok, torch.zeros_like(per_tok)).sum()
    count = valid.sum()
    if across is not None:
        total, count = across(total), across(count)
    return total / count.clamp(min=1)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def cosine_anneal(start: float, end: float, steps: int) -> torch.Tensor:
    """Temperature schedule: `steps` values from `start` to `end` along half
    a cosine, f32."""
    if steps <= 1:
        return torch.tensor([start], dtype=torch.float32)
    t = torch.arange(steps, dtype=torch.float64)
    return (end + (start - end) / 2
            * (1 + torch.cos(math.pi * t / (steps - 1)))).float()


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


def batchwise_cosine_similarity(z: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarities, transposed as the reference returns
    them (sim[j, i] = cos(z_i, b_j))."""
    z = z.reshape(z.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    zn = torch.linalg.vector_norm(z, dim=1, keepdim=True)
    bn = torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return ((z @ b.T) / (zn @ bn.T)).T


def topk_accuracy(similarities: torch.Tensor, labels: torch.Tensor,
                  k: int = 5) -> torch.Tensor:
    """The per-rank hit fractions summed over the top-k ranks, as the JAX
    package (and the reference) count them. Ranks come from a stable
    ascending argsort read from the end, as jnp.argsort orders them: of
    tied similarities the later column ranks first."""
    k = min(k, similarities.shape[0])
    order = torch.argsort(similarities, dim=1, stable=True)
    hits = torch.zeros((), device=similarities.device)
    for i in range(k):
        hits = hits + (order[:, -(i + 1)] == labels).float().mean()
    return hits


def check_loss(loss: torch.Tensor, name: str = "loss") -> torch.Tensor:
    """NaN guard: prints when `loss` is not finite and returns it
    unchanged (a host sync)."""
    if not bool(torch.isfinite(loss).all()):
        print(f"!! non-finite {name}: {loss}")
    return loss


def count_params(params) -> int:
    """Total parameter count of a module or of a {name: tensor} dict."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return sum(p.numel() for p in params.values())
