"""Stage-2 loss terms, plain PyTorch.

Counterpart of neurons_tpu/training/losses.py (the functions stage 2
calls): bidirectional InfoNCE without mixup (`mixco_nce`; the mixup
itself belongs to stage 1), SoftCLIP, Dice on sigmoid logits, multi-label
BCE, token cross-entropy with ignore index and label smoothing, L1, the
cosine-annealed temperature and L2 normalisation. Every reduction is a
mean over all elements, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def mixco_nce(preds: torch.Tensor, targs: torch.Tensor, temp: float = 0.1,
              bidirectional: bool = True) -> torch.Tensor:
    """Bidirectional InfoNCE with the diagonal as targets; rows are expected
    L2-normalised."""
    brain_clip = (preds @ targs.T) / temp
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


def dice_loss(pred_logits: torch.Tensor, mask: torch.Tensor,
              smooth: float = 1e-7) -> torch.Tensor:
    """Dice loss on sigmoid logits, over the whole batch."""
    p = torch.sigmoid(pred_logits)
    intersection = torch.sum(p * mask)
    union = torch.sum(p) + torch.sum(mask)
    return 1.0 - (2.0 * intersection + smooth) / (union + smooth)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-label BCE on logits, mean over all elements."""
    return -(labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits)).mean()


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 0,
                         label_smoothing: float = 0.1) -> torch.Tensor:
    """Token cross-entropy with an ignored label and label smoothing:
    (1 - eps) * nll + eps * mean over classes of -logp, averaged over the
    tokens that are not ignored."""
    n_classes = logits.shape[-1]
    logits = logits.reshape(-1, n_classes)
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(-1))
    denom = valid.sum().clamp(min=1)
    return torch.where(valid, per_tok, torch.zeros_like(per_tok)).sum() / denom


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
