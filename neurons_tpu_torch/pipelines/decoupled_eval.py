"""Stage e: the decoupler's outputs scored on their own (the reference's
gen_decoupled_outputs.py).

Counterpart of neurons_tpu/pipelines/decoupled_eval.py: encode -> the
100-step prior -> motion -> heads, then the key-object segmentation Dice
against the ground-truth masks and the thresholded multi-label accuracy,
precision and recall of the classifier; the predicted masks, class
logits, caption ids and blurry latents come back with the scores. The
prior's noise comes from `generator` or from explicit `noise`, as in
every sampler of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.diffusion import prior as prior_lib
from neurons_tpu_torch.pipelines.keyframe import _check_device, _dtype
from neurons_tpu_torch.training.losses import dice_loss, l2norm


class DecoupledOutputs(NamedTuple):
    seg_masks: torch.Tensor       # [(B F), 1, h, w] logits
    cls_logits: torch.Tensor      # [B, n_classes]
    captions: torch.Tensor        # [B, max_len]
    blurry_latents: torch.Tensor  # [(B F), 4, h, w]
    dice: Optional[torch.Tensor] = None
    cls_accuracy: Optional[torch.Tensor] = None
    cls_precision: Optional[torch.Tensor] = None
    cls_recall: Optional[torch.Tensor] = None


@torch.inference_mode()
def generate_decoupled_outputs(
    decoupler: nn.Module, voxel: torch.Tensor,
    class_text_embeds: torch.Tensor, n_frames: int,
    prior_steps: int = 100, caption_len: int = 60,
    gt_masks: Optional[torch.Tensor] = None,
    gt_cls: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[prior_lib.PriorNoise] = None,
    device="cuda",
) -> DecoupledOutputs:
    """voxel [B, 1, n_voxels] through a NeuronsDecoupler on `device`. With
    `gt_masks` [B, >=F, H, W] the seg logits' Dice (the masks resized to
    the logits' grid by nearest sampling at pixel centres); with `gt_cls`
    [B, n_classes] the accuracy, precision and recall of sigmoid > 0.5."""
    dev = resolve_device(device)
    _check_device(dev, decoupler=decoupler)
    ddt = _dtype(decoupler)

    def run(fn, *args, **kw):
        args = [a.to(ddt) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return tuple(o.float() for o in out)
        return out.float() if out.is_floating_point() else out

    voxel = voxel.to(dev)
    b = voxel.shape[0]
    _, clip_vision, _ = decoupler.encode(voxel.to(ddt))
    clip_vision = clip_vision.float()

    diffusion = prior_lib.PriorDiffusion.create(prior_steps, device=dev)

    def prior_net(image_embed, times, brain_embed, **kw):
        return run(decoupler.prior_apply, image_embed, times, brain_embed,
                   **kw)

    prior_out = prior_lib.p_sample_loop(
        diffusion, prior_net, tuple(clip_vision.shape), clip_vision,
        generator=generator, noise=noise)
    motion = run(decoupler.motion, prior_out)
    pooled_text = run(decoupler.project_text, motion.mean(dim=1))
    cls_logits = run(decoupler.classify, motion.mean(dim=1).mean(dim=1))
    best_text = class_text_embeds.to(dev)[cls_logits.argmax(dim=-1)]

    flat = motion.reshape(b * n_frames, motion.shape[2], motion.shape[3])
    seg, rec = run(decoupler.seg_decode, flat, best_text, b * n_frames,
                   return_all=True)
    captions = decoupler.caption_greedy(l2norm(pooled_text).to(ddt),
                                        caption_len)

    dice = acc = prec = recall = None
    if gt_masks is not None:
        hw = seg.shape[-2:]
        gm = gt_masks.to(dev, torch.float32)[:, :n_frames]
        gm = F.interpolate(gm, size=hw, mode="nearest-exact")
        gm = gm.reshape(b * n_frames, 1, *hw)
        dice = 1.0 - dice_loss(seg, gm)
    if gt_cls is not None:
        pred = (torch.sigmoid(cls_logits) > 0.5).float()
        gt = gt_cls.to(dev, torch.float32)
        tp = (pred * gt).sum()
        acc = (pred == gt).float().mean()
        prec = tp / pred.sum().clamp(min=1.0)
        recall = tp / gt.sum().clamp(min=1.0)

    return DecoupledOutputs(seg_masks=seg, cls_logits=cls_logits,
                            captions=captions, blurry_latents=rec,
                            dice=dice, cls_accuracy=acc,
                            cls_precision=prec, cls_recall=recall)
