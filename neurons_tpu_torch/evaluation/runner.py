"""Stage-6 metric runner.

Counterpart of neurons_tpu/evaluation/runner.py. Reads the GT ‖ prediction
GIFs of `gen_videos_{mode}`, splits them along width and computes the
report: the video 2- and 50-way accuracies (VideoMAE), CLIP-pcc, and per
frame SSIM, PSNR and the 2- and 50-way accuracies (ViT-B). The classifier
networks are injected callables; without them only the pixel metrics run.
`build_metric_classifiers` assembles them from HF state dicts through the
port's importers, on the card unless told otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.evaluation import metrics as M
from neurons_tpu_torch.pipelines.e2e import resize_linear
from neurons_tpu_torch.pipelines.io import load_gif, split_gt_pred

IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
HALF_NORM = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))  # ViTImageProcessor's
CLIP_NORM = ((0.48145466, 0.4578275, 0.40821073),
             (0.26862954, 0.26130258, 0.27577711))
WEIGHT_FILES = (("vit", "vit_base.pt"), ("videomae", "videomae_kinetics.pt"),
                ("clip", "clip_vit_l.pt"))


@dataclass
class MetricClassifiers:
    """Injected networks of the semantic metrics."""

    img_probs_fn: Optional[Callable] = None    # frame -> [1000] softmax
    img_logits_fn: Optional[Callable] = None   # frame -> [1000] logits
    video_probs_fn: Optional[Callable] = None  # video -> [400] softmax
    video_logits_fn: Optional[Callable] = None
    clip_embed_fn: Optional[Callable] = None   # frames -> [F, D]


def prep_frames(frames_hwc: np.ndarray, size: int, mean, std,
                device) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> f32 [..., 3, size, size] on `device`: the
    processors' resize (bilinear, antialiased as jax.image.resize) and
    normalisation."""
    x = torch.as_tensor(np.asarray(frames_hwc), device=device)
    x = x.to(torch.float32).div(255.0).movedim(-1, -3)
    if x.shape[-2:] != (size, size):
        x = resize_linear(x, size)
    m = torch.tensor(mean, dtype=x.dtype, device=device).view(3, 1, 1)
    s = torch.tensor(std, dtype=x.dtype, device=device).view(3, 1, 1)
    return (x - m) / s


def build_metric_classifiers(weights_dir: str, num_frames: int = 6,
                             device="cuda") -> Optional[MetricClassifiers]:
    """The semantic metrics' networks from HF state dicts under
    weights_dir: `vit_base.pt` (google/vit-base-patch16-224),
    `videomae_kinetics.pt` (MCG-NJU/videomae-base-finetuned-kinetics) and
    `clip_vit_l.pt` (CLIP ViT-L/14); None (pixel metrics only) when none
    exists. `num_frames` sizes VideoMAE to the evaluated clips. Every fn
    takes raw uint8 HWC frames and returns numpy."""
    paths = {n: os.path.join(weights_dir, f) for n, f in WEIGHT_FILES}
    if not any(os.path.exists(p) for p in paths.values()):
        return None
    from neurons_tpu_torch.interop import torch_import as TI
    from neurons_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
    from neurons_tpu_torch.models.vit import ViTClassifier, ViTConfig

    dev = resolve_device(device)

    def _load(module, importer, path, *args):
        # source keys the importer does not read (a checkpoint's buffers,
        # another tower) are reported and left, as the JAX runner leaves them
        sd = torch.load(path, map_location="cpu")
        unused = TI.load_torch_checkpoint(module, importer,
                                          sd.get("state_dict", sd), *args,
                                          allow_unused=True)
        if unused:
            print(f"--- {os.path.basename(path)}: {len(unused)} unused "
                  f"keys ---")

    def _numpy(fn):
        def call(x):
            with torch.inference_mode():
                return fn(x).float().cpu().numpy()
        return call

    def _softmax(fn):
        return _numpy(lambda x: torch.softmax(fn(x), dim=-1))

    out = MetricClassifiers()
    if os.path.exists(paths["vit"]):
        cfg = ViTConfig.vit_base_224()
        vit = ViTClassifier(cfg, device=dev).eval()
        _load(vit, TI.import_hf_vit_classifier, paths["vit"], cfg.layers)

        def img_logits(frame_hwc):
            return vit(prep_frames(frame_hwc, 224, *HALF_NORM, dev)[None])[0]

        out.img_logits_fn = _numpy(img_logits)
        out.img_probs_fn = _softmax(img_logits)
    if os.path.exists(paths["videomae"]):
        cfg = ViTConfig.videomae_kinetics(num_frames=num_frames)
        mae = ViTClassifier(cfg, device=dev).eval()
        _load(mae, TI.import_videomae_classifier, paths["videomae"],
              cfg.layers, cfg.num_tokens())

        def vid_logits(frames_fhwc):
            return mae(prep_frames(frames_fhwc, 224, *IMAGENET_NORM,
                                   dev)[None])[0]

        out.video_logits_fn = _numpy(vid_logits)
        out.video_probs_fn = _softmax(vid_logits)
    if os.path.exists(paths["clip"]):
        cfg = CLIPVisionConfig.vit_l14()
        tower = CLIPVisionTower(cfg, device=dev).eval()
        _load(tower, TI.import_hf_clip_vision, paths["clip"], cfg.layers)
        out.clip_embed_fn = _numpy(lambda frames: tower(prep_frames(
            frames, cfg.image_size, *CLIP_NORM, dev))[0])
    return out


def load_gif_dir(data_path: str, workers: int = 8):
    """The directory's GIFs, read by a thread pool (the native decoder
    releases the GIL), split into (gts, preds) [N, F, H, W, 3] uint8."""
    from concurrent.futures import ThreadPoolExecutor

    names = [f for f in sorted(os.listdir(data_path)) if f.endswith(".gif")]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        gifs = list(pool.map(
            lambda f: load_gif(os.path.join(data_path, f)), names))
    gts, preds = [], []
    for gif in gifs:
        gt, pred = split_gt_pred(gif)
        gts.append(gt)
        preds.append(pred)
    return np.stack(gts), np.stack(preds)


def run_metrics(data_path: str,
                classifiers: Optional[MetricClassifiers] = None,
                num_trials: int = 100, top_k: int = 1,
                verbose: bool = True, device="cuda") -> Dict[str, float]:
    """The metric report of a GIF directory; SSIM and PSNR on `device`."""
    gt_list, pred_list = load_gif_dir(data_path)
    report: Dict[str, float] = {}
    c = classifiers or MetricClassifiers()

    if c.clip_embed_fn is not None:
        m, s = M.clip_pcc(c.clip_embed_fn, list(pred_list))
        report["clip_pcc"] = m
        report["clip_pcc_std"] = s

    if c.video_probs_fn is not None:
        for n_way in (2, 50):
            accs = M.classify_nway_metric(
                c.video_probs_fn, c.video_logits_fn or c.video_probs_fn,
                list(pred_list), list(gt_list), n_way=n_way,
                num_trials=num_trials, top_k=top_k)
            report[f"video_{n_way}way"] = float(np.mean(accs))

    n_frames = pred_list.shape[1]
    ssim_l, psnr_l = [], []
    frame_2way, frame_50way = [], []
    for i in range(n_frames):
        sm, _ = M.ssim_score(pred_list[:, i], gt_list[:, i], device=device)
        pm, _ = M.psnr_score(pred_list[:, i].astype(np.float32),
                             gt_list[:, i].astype(np.float32), device=device)
        ssim_l.append(sm)
        psnr_l.append(pm)
        if c.img_probs_fn is not None:
            for n_way, acc_list in ((2, frame_2way), (50, frame_50way)):
                accs = M.classify_nway_metric(
                    c.img_probs_fn, c.img_logits_fn or c.img_probs_fn,
                    list(pred_list[:, i]), list(gt_list[:, i]),
                    n_way=n_way, num_trials=num_trials, top_k=top_k)
                acc_list.append(float(np.mean(accs)))

    report["ssim"] = float(np.mean(ssim_l))
    report["psnr"] = float(np.mean(psnr_l))
    if frame_2way:
        report["frame_2way"] = float(np.mean(frame_2way))
        report["frame_50way"] = float(np.mean(frame_50way))

    if verbose:
        print("======== Video-based ========")
        for k in ("video_2way", "video_50way", "clip_pcc"):
            if k in report:
                print(f"  {k}: {report[k]:.4f}")
        print("======== Frame-based ========")
        for k in ("frame_2way", "frame_50way", "ssim", "psnr"):
            if k in report:
                print(f"  {k}: {report[k]:.4f}")
    return report
