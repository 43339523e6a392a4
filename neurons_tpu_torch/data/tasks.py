"""Offline task construction: key objects and caption embeddings.

Counterpart of neurons_tpu/data/tasks.py, host-side numpy run once ahead of
training. The key-object rule (the reference's find_key_obj.py): per
category, accumulate the inter-frame displacement of its mask centroid
(doubled for the PRIORITY animal/people categories); exclude the
BACKGROUND categories; prefer priority categories, else keep those under
50% of the frame; emit the top-k categories, the winner's per-frame masks,
and `key_objects_info_{mode}.json` with `key_objects_masks_{mode}` (.npz,
and the .pt that `cc2017.load_split` reads). `gen_caption_embeds` writes
the reference's `GT_{mode}_caption_qwen.pt` / `_emb.pt` pair. PIL is
imported only where PNG masks are parsed.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurons_tpu_torch.data.categories import (BACKGROUND_CATEGORIES,
                                               PRIORITY_CATEGORIES)


def load_masks_from_png(mask_dir: str, json_data: Dict) -> Dict:
    """Parse mask_{vid}_f{frame}_{label}.png files into
    {video: {frame: {label: {segmentation, category}}}}."""
    from PIL import Image

    masks: Dict[int, Dict[int, Dict[int, Dict]]] = {}
    for mask_file in os.listdir(mask_dir):
        m = re.match(r"mask_(\d+)_f(\d+)_(\d+).png", mask_file)
        if not m:
            continue
        video_id, frame_id, label = int(m.group(1)), int(m.group(2)), m.group(3)
        key = f"mask_{video_id}_f{frame_id}"
        if key not in json_data or label not in json_data[key]:
            continue
        arr = np.array(Image.open(os.path.join(mask_dir, mask_file)))
        masks.setdefault(video_id, {}).setdefault(frame_id, {})[int(label)] = {
            "segmentation": arr, "category": json_data[key][label]}
    return masks


def calculate_center(segmentation: np.ndarray) -> Optional[Tuple[float, float]]:
    ys, xs = np.where(segmentation > 0)
    if len(ys) == 0:
        return None
    return float(xs.mean()), float(ys.mean())


def select_key_objects_for_video(video_masks: Dict, top_k: int = 3
                                 ) -> List[str]:
    """The ranked key-object categories of one video."""
    object_changes: Dict[str, float] = defaultdict(float)
    object_sizes: Dict[str, float] = defaultdict(float)
    frame_ids = sorted(video_masks.keys())

    for i in range(1, len(frame_ids)):
        prev_masks = video_masks[frame_ids[i - 1]]
        curr_masks = video_masks[frame_ids[i]]
        for label, info in curr_masks.items():
            category = info["category"]
            if category in BACKGROUND_CATEGORIES:
                continue
            curr_center = calculate_center(info["segmentation"])
            if curr_center is None or label not in prev_masks:
                continue
            prev_center = calculate_center(prev_masks[label]["segmentation"])
            if prev_center is None:
                continue
            displacement = float(np.hypot(curr_center[0] - prev_center[0],
                                          curr_center[1] - prev_center[1]))
            if category in PRIORITY_CATEGORIES:
                displacement *= 2  # the reference's priority boost
            object_changes[category] += displacement
            seg = info["segmentation"]
            object_sizes[category] = float((seg > 0).sum()) / seg.size

    ranked = sorted(object_changes.items(), key=lambda x: x[1], reverse=True)
    priority = [c for c, _ in ranked if c in PRIORITY_CATEGORIES]
    if priority:
        return priority[:top_k]
    filtered = [c for c, _ in ranked if object_sizes[c] < 0.5]
    if not filtered:
        filtered = [c for c, _ in ranked]
    return filtered[:top_k]


def select_key_objects_for_all_videos(masks: Dict, num_videos: int,
                                      n_frames: int = 6, hw: int = 224,
                                      top_k: int = 1
                                      ) -> Tuple[Dict, np.ndarray]:
    """Per video, the winning category and its per-frame masks
    ([N, F, H, W], zeros where absent)."""
    video_key_objects: Dict[int, Dict[str, str]] = {}
    all_masks = np.zeros((num_videos, n_frames, hw, hw), np.float32)

    for video_id, video_masks in masks.items():
        key_objects = select_key_objects_for_video(video_masks, top_k)
        category = key_objects[0] if key_objects else "None"
        if key_objects:
            for frame_id in range(n_frames):
                for label, info in video_masks.get(frame_id, {}).items():
                    if info["category"] == category:
                        all_masks[video_id, frame_id] = info["segmentation"]
        video_key_objects[video_id] = {"category": category}
    return video_key_objects, all_masks


def build_key_object_files(mask_dir: str, masks_json_path: str,
                           out_dir: str, mode: str,
                           num_videos: int = 4320, n_frames: int = 6,
                           hw: int = 224) -> None:
    """Writes key_objects_info_{mode}.json, key_objects_masks_{mode}.npz and
    key_objects_masks_{mode}.pt (the tensor `cc2017.load_split` reads)."""
    with open(masks_json_path) as f:
        json_data = json.load(f)
    masks = load_masks_from_png(mask_dir, json_data)
    key_objects, all_masks = select_key_objects_for_all_videos(
        masks, num_videos, n_frames=n_frames, hw=hw)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"key_objects_info_{mode}.json"),
              "w") as f:
        json.dump({str(k): v for k, v in
                   sorted(key_objects.items())}, f, indent=4)
    np.savez(os.path.join(out_dir, f"key_objects_masks_{mode}.npz"),
             masks=all_masks)
    torch.save(torch.from_numpy(all_masks),
               os.path.join(out_dir, f"key_objects_masks_{mode}.pt"))


def gen_caption_embeds(captions: Sequence[str],
                       embed_fn: Callable[[Sequence[str]], torch.Tensor],
                       out_dir: str, mode: str,
                       batch_size: int = 64) -> np.ndarray:
    """Embed captions with a batched text embedder (the CLIP-bigG pooled
    1280-d embedding in the reference) and write the reference's artifacts:
    `GT_{mode}_caption_qwen.pt` (the captions as a numpy string array, as
    the reference's np.hstack saves them) and `GT_{mode}_caption_qwen_emb.pt`
    (an f32 tensor). `embed_fn` returns a tensor or an array."""
    embs = []
    with torch.inference_mode():
        for start in range(0, len(captions), batch_size):
            out = embed_fn(captions[start:start + batch_size])
            embs.append(out.float().cpu().numpy() if torch.is_tensor(out)
                        else np.asarray(out))
    all_embs = np.concatenate(embs, axis=0)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(np.asarray(list(captions)),
               os.path.join(out_dir, f"GT_{mode}_caption_qwen.pt"))
    torch.save(torch.from_numpy(np.asarray(all_embs, np.float32)),
               os.path.join(out_dir, f"GT_{mode}_caption_qwen_emb.pt"))
    return all_embs
