"""Stage-6 metric suite: the reference's metric protocols.

Counterpart of neurons_tpu/evaluation/metrics.py. The classifier networks
are injected callables (the port's ViT / VideoMAE / CLIP with imported
weights, or any other):

  n_way_top_k_acc     the correct class and n_way - 1 random distractors,
                      top-k over the subset, `num_trials` resamples; the GT
                      label set is the GT classifier's top 3;
  SSIM                rgb2gray, Gaussian weights sigma 1.5 (truncate 3.5,
                      11 x 11), population covariance, data range 1.0
                      (skimage's definition), edge padding as
                      scipy.ndimage's mode='nearest';
  PSNR                data range 255;
  CLIP-pcc            the mean off-diagonal cosine of a clip's frame
                      embeddings;
  remove_overlap      the scene dedup.

SSIM and PSNR run on the card in f32, 256 frames a batch;
the n-way protocol is numpy on the host, verbatim, with its own
`default_rng(seed)`.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neurons_tpu_torch import resolve_device

# ITU-R BT.601 luma weights (skimage's rgb2gray)
_RGB2GRAY = (0.2125, 0.7154, 0.0721)


def rgb2gray(img: torch.Tensor) -> torch.Tensor:
    """img [..., H, W, 3] in [0, 255] -> gray [..., H, W] in [0, 1]."""
    w = torch.tensor(_RGB2GRAY, dtype=img.dtype, device=img.device)
    return (img / 255.0) @ w


def _gaussian_kernel1d(sigma: float = 1.5, truncate: float = 3.5
                       ) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d_nearest(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable filtering of img [..., H, W] with edge padding (scipy's
    mode='nearest'), the taps summed in order along H, then along W."""
    r = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, h, w)
    p = F.pad(x, (0, 0, r, r), mode="replicate")
    out = torch.zeros_like(x)
    for i, ki in enumerate(k.tolist()):
        out = out + np.float32(ki) * p[:, :, i:i + h]
    p = F.pad(out, (r, r, 0, 0), mode="replicate")
    out2 = torch.zeros_like(x)
    for i, ki in enumerate(k.tolist()):
        out2 = out2 + np.float32(ki) * p[:, :, :, i:i + w]
    return out2.reshape(*lead, h, w)


def ssim_gray(img1: torch.Tensor, img2: torch.Tensor, sigma: float = 1.5,
              data_range: float = 1.0, truncate: float = 3.5
              ) -> torch.Tensor:
    """Gaussian-weighted SSIM of single-channel images [..., H, W] (the
    mean over the valid interior), one value per leading index."""
    k = _gaussian_kernel1d(sigma, truncate)
    pad = (len(k) - 1) // 2

    def f(x):
        return _filter2d_nearest(x, k)

    ux, uy = f(img1), f(img2)
    uxx, uyy, uxy = f(img1 * img1), f(img2 * img2), f(img1 * img2)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s[..., pad:-pad, pad:-pad].mean(dim=(-2, -1))


_CHUNK = 256  # frames a batch on the device


def _per_frame(fn, pred: np.ndarray, gt: np.ndarray, device) -> np.ndarray:
    """fn(pred, gt) over f32 channel-last frames on `device`, in chunks of
    `_CHUNK` frames; the per-frame scores as float64."""
    dev = resolve_device(device)
    pred, gt = _channel_last(pred), _channel_last(gt)
    out = []
    for s in range(0, len(pred), _CHUNK):
        a, b = (torch.as_tensor(np.asarray(x[s:s + _CHUNK], np.float32),
                                device=dev) for x in (pred, gt))
        out.append(fn(a, b).cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def ssim_score(pred: np.ndarray, gt: np.ndarray, device="cuda"
               ) -> Tuple[float, float]:
    """Per-frame rgb2gray SSIM, (mean, std). pred/gt [N, H, W, 3] (or
    [N, 3, H, W]) in 0-255."""
    scores = _per_frame(lambda a, b: ssim_gray(rgb2gray(a), rgb2gray(b)),
                        pred, gt, device)
    return float(np.mean(scores)), float(np.std(scores))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """PSNR over the last three axes, one value per leading index."""
    mse = torch.mean(torch.square(img1.float() - img2.float()),
                     dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def psnr_score(pred: np.ndarray, gt: np.ndarray, device="cuda"
               ) -> Tuple[float, float]:
    """Per-frame PSNR (data range 255), (mean, std)."""
    scores = _per_frame(psnr, pred, gt, device)
    return float(np.mean(scores)), float(np.std(scores))


def mse_score(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    scores = [float(np.mean((p / 255.0 - g / 255.0) ** 2))
              for p, g in zip(pred, gt)]
    return float(np.mean(scores)), float(np.std(scores))


def _channel_last(img: np.ndarray) -> np.ndarray:
    if img.shape[-1] == 3:
        return img
    if img.ndim == 3:
        return np.transpose(img, (1, 2, 0))
    if img.ndim == 4:
        return np.transpose(img, (0, 2, 3, 1))
    raise ValueError(f"bad image rank {img.ndim}")


def n_way_top_k_acc(pred: np.ndarray, class_ids, n_way: int,
                    num_trials: int = 100, top_k: int = 1,
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[float, float]:
    """For each trial draw n_way - 1 distractor classes; correct if any GT
    class ranks in the top_k of [gt ++ distractors]."""
    rng = rng or np.random.default_rng(0)
    if isinstance(class_ids, (int, np.integer)):
        class_ids = [int(class_ids)]
    class_ids = [int(c) for c in np.asarray(class_ids).reshape(-1)]
    pick_range = np.setdiff1d(np.arange(len(pred)), class_ids)
    corrects = 0
    for _ in range(num_trials):
        idxs = rng.choice(pick_range, n_way - 1, replace=False)
        for gt_id in class_ids:
            subset = np.concatenate([[pred[gt_id]], pred[idxs]])
            if 0 in np.argsort(subset)[-top_k:]:
                corrects += 1
                break
    acc = corrects / num_trials
    return acc, math.sqrt(max(acc * (1 - acc) / num_trials, 0.0))


def classify_nway_metric(pred_probs_fn: Callable[[np.ndarray], np.ndarray],
                         gt_logits_fn: Callable[[np.ndarray], np.ndarray],
                         pred_items: Sequence[np.ndarray],
                         gt_items: Sequence[np.ndarray],
                         n_way: int = 50, num_trials: int = 100,
                         top_k: int = 1, gt_top: int = 3,
                         seed: int = 0) -> List[float]:
    """The image/video classification protocol: the GT label set is the GT
    item's top-`gt_top` classes; the accuracy is the n-way protocol on the
    prediction's class probabilities."""
    rng = np.random.default_rng(seed)
    accs = []
    for pred, gt in zip(pred_items, gt_items):
        gt_ids = np.argsort(gt_logits_fn(gt).reshape(-1))[-gt_top:]
        probs = pred_probs_fn(pred).reshape(-1)
        acc, _ = n_way_top_k_acc(probs, gt_ids, n_way, num_trials, top_k,
                                 rng)
        accs.append(acc)
    return accs


def clip_pcc(embed_fn: Callable[[np.ndarray], np.ndarray],
             videos: Sequence[np.ndarray]) -> Tuple[float, float]:
    """Per clip, the mean pairwise off-diagonal cosine of its frame
    embeddings; (mean, std) over clips."""
    scores = []
    for frames in videos:
        feats = np.asarray(embed_fn(frames))
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        sim = feats @ feats.T
        np.fill_diagonal(sim, 0.0)
        n = len(frames)
        scores.append(sim.sum() / (n * (n - 1)))
    return float(np.mean(scores)), float(np.std(scores))


def clip_similarity(embed_fn: Callable[[np.ndarray], np.ndarray],
                    pred: Sequence[np.ndarray], gt: Sequence[np.ndarray]
                    ) -> float:
    """The mean pred/gt CLIP cosine."""
    scores = []
    for p, g in zip(pred, gt):
        fp = np.asarray(embed_fn(p[None]))[0]
        fg = np.asarray(embed_fn(g[None]))[0]
        scores.append(float(fp @ fg /
                            (np.linalg.norm(fp) * np.linalg.norm(fg))))
    return float(np.mean(scores))


def remove_overlap(pred_videos: np.ndarray, gt_videos: np.ndarray,
                   scene_seg_list: Sequence[str],
                   get_scene_seg: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop boundary clips ('-' in the segment tag); with `get_scene_seg`
    keep one clip a scene."""
    pred_list, gt_list, seen = [], [], {}
    for pred, gt, seg in zip(pred_videos, gt_videos, scene_seg_list):
        if "-" in seg:
            continue
        if get_scene_seg:
            if seg in seen:
                continue
            seen[seg] = True
        pred_list.append(pred)
        gt_list.append(gt)
    return np.stack(pred_list), np.stack(gt_list)
