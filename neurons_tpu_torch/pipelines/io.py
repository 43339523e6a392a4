"""Artifact IO: the EXP/exp_{exp}/subj_{subj}/ contract and GIF writing.

Counterpart of neurons_tpu/pipelines/io.py, byte for byte the same on-disk
dialect, so a directory written by either package loads in the other:

  stage 3 writes  frames_generated{_enhance}/
      video_subj0{subj}_all_recons.pt     [N, 3, 256, 256] float
      video_subj0{subj}_all_gts.pt        [N, 3, H, W] float
      pred_test_caption_self.pt           numpy object array of str
      recon_videos.pt                     [N, 6, 3, 224, 224] float
  stage 4 writes  pred_test_caption.pt    numpy object array of str
  stage 5 writes  gen_videos_{mode}/{org_idx}-{prompt}.gif, each frame the
                  ground truth beside the prediction along width, which
                  stage 6 splits in half.

Legacy .npz stage-3 artifacts stay readable. GIFs go through the native
codec (neurons_tpu_torch/native_io.py) and, where it is missing or cannot
read a file, through imageio, imported only on that branch.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from neurons_tpu_torch import native_io


def exp_dir(root: str, exp: str, subj: int) -> str:
    return os.path.join(root, f"exp_{exp}", f"subj_{subj}")


def stage3_dir(root: str, exp: str, subj: int, enhance: bool) -> str:
    tag = "frames_generated_enhance" if enhance else "frames_generated"
    return os.path.join(exp_dir(root, exp, subj), tag)


def video_dir(root: str, exp: str, subj: int, mode: str) -> str:
    return os.path.join(exp_dir(root, exp, subj), f"gen_videos_{mode}")


def _torch_save(arr, path: str) -> None:
    torch.save(torch.from_numpy(np.array(arr, order="C")), path)


def _torch_load(path: str) -> np.ndarray:
    # the caption artifacts are pickled numpy object arrays of str (the
    # reference's np.hstack of python strings), which the weights-only
    # unpickler refuses; these are files of the artifact directory, which
    # this program or the reference's scripts wrote
    t = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t)


def save_stage3_artifacts(path: str, subj: int, *, all_recons: np.ndarray,
                          all_gts: np.ndarray, captions: Sequence[str],
                          blurry_videos: np.ndarray) -> None:
    """Write the four stage-3 .pt artifacts under their names, and a .txt
    caption sidecar for reading by eye."""
    os.makedirs(path, exist_ok=True)
    stem = f"video_subj0{subj}"
    _torch_save(np.asarray(all_recons, np.float32),
                os.path.join(path, f"{stem}_all_recons.pt"))
    _torch_save(np.asarray(all_gts, np.float32),
                os.path.join(path, f"{stem}_all_gts.pt"))
    _torch_save(np.asarray(blurry_videos, np.float32),
                os.path.join(path, "recon_videos.pt"))
    torch.save(np.asarray(list(captions), dtype=object),
               os.path.join(path, "pred_test_caption_self.pt"))
    with open(os.path.join(path, "pred_test_caption_self.txt"), "w") as f:
        f.write("\n".join(captions))


def save_caption_artifact(path: str, captions: Sequence[str]) -> None:
    """Stage 4's output, pred_test_caption.pt (an object array of str)."""
    os.makedirs(path, exist_ok=True)
    torch.save(np.asarray(list(captions), dtype=object),
               os.path.join(path, "pred_test_caption.pt"))
    with open(os.path.join(path, "pred_test_caption.txt"), "w") as f:
        f.write("\n".join(captions))


def load_captions(path: str, mode: str = "auto") -> List[str]:
    """Stage-3/4 captions. mode: 'self' = stage 3's GPT-2 captions, 'blip'
    = stage 4's BLIP-2 captions, 'auto' = blip if present, else self."""
    order = {"self": ["pred_test_caption_self"],
             "blip": ["pred_test_caption"],
             "auto": ["pred_test_caption", "pred_test_caption_self"]}[mode]
    for stem in order:
        pt = os.path.join(path, stem + ".pt")
        if os.path.exists(pt):
            return [str(c) for c in _torch_load(pt).tolist()]
        txt = os.path.join(path, stem + ".txt")
        if os.path.exists(txt):
            with open(txt) as f:
                return f.read().splitlines()
    return []


def load_stage3_artifacts(path: str, subj: int,
                          caption_mode: str = "auto") -> Dict:
    """A stage-3 artifact directory, either package's or the reference's;
    falls back to the legacy .npz layout. blurry_videos comes back as
    [N, 6, 3, H, W] (the flat [N*6, 3, H, W] layout is reshaped)."""
    stem = f"video_subj0{subj}"
    recons_pt = os.path.join(path, f"{stem}_all_recons.pt")
    if os.path.exists(recons_pt):
        all_recons = _torch_load(recons_pt)
        gts_pt = os.path.join(path, f"{stem}_all_gts.pt")
        all_gts = _torch_load(gts_pt) if os.path.exists(gts_pt) else None
        blurry = _torch_load(os.path.join(path, "recon_videos.pt"))
    else:
        recons = np.load(os.path.join(path, f"subj{subj:02d}_all_recons.npz"))
        all_recons, all_gts = recons["all_recons"], recons["all_gts"]
        blurry = np.load(os.path.join(path, "recon_videos.npz"))["videos"]
    if blurry.ndim == 4:
        blurry = blurry.reshape(-1, 6, *blurry.shape[1:])
    return {"all_recons": all_recons, "all_gts": all_gts,
            "blurry_videos": blurry,
            "captions": load_captions(path, caption_mode)}


def gif_artifact_name(org_idx: int, prompt: str) -> str:
    """'{org_idx}-{prompt}.gif', '/' dropped from the prompt and its spaces
    dash-joined, empty tokens of runs of spaces included."""
    return f"{int(org_idx)}-" + \
        "-".join(str(prompt).replace("/", "").split(" ")) + ".gif"


def save_video_grid(videos: np.ndarray, path: str, fps: int = 8,
                    rescale: bool = False) -> None:
    """Videos [N, F, 3, H, W] or [N, 3, F, H, W] in [0, 1] (rescale=True
    maps [-1, 1] to [0, 1]) side by side along width, one GIF frame each."""
    v = np.asarray(videos)
    if v.shape[1] == 3:  # [N, 3, F, H, W]
        v = v.transpose(0, 2, 1, 3, 4)
    if rescale:
        v = (v + 1.0) / 2.0
    v = np.clip(v, 0, 1)
    frames = []
    for f in range(v.shape[1]):
        row = np.concatenate(list(v[:, f]), axis=-1)
        frames.append((row.transpose(1, 2, 0) * 255).astype(np.uint8))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = native_io.encode_gif(np.stack(frames), delay_ms=int(1000 / fps))
    if data is not None:
        with open(path, "wb") as fh:
            fh.write(data)
        return
    import imageio

    # imageio >= 2.28 reads a GIF's `duration` in ms, older ones in seconds
    ver = tuple(int(x) for x in imageio.__version__.split(".")[:2])
    duration = 1000 / fps if ver >= (2, 28) else 1 / fps
    imageio.mimsave(path, frames, duration=duration, loop=0)


def load_gif(path: str) -> np.ndarray:
    """-> [F, H, W, 3] uint8: the native decoder, imageio for what it
    cannot read (interlaced GIFs and the like)."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames = native_io.decode_gif(data)
    if frames is not None:
        return frames
    import imageio

    frames = imageio.mimread(path)
    return np.stack([np.asarray(f)[..., :3] for f in frames])


def split_gt_pred(gif_frames: np.ndarray):
    """Each GIF frame is the ground truth beside the prediction along
    width: (gt, pred), the two halves."""
    gt, pred = np.split(gif_frames, 2, axis=2)
    return gt, pred
