"""CC2017 (Wen et al.) dataset as host-side numpy arrays, and its batch
iterator.

Counterpart of neurons_tpu/data/cc2017.py (numpy only): the split's field
contract, random splits for tests and benches (`synthetic_split`, and
`structured_synthetic_split`, whose targets are learnable), and shuffled
fixed-size batches carrying each sample's dataset index (precomputed-table
lookups address rows by it), and the loader of the released tensors
(`load_split`, with the caption tokens and the multi-hot class labels).

Train tensors (lengths as the released dataset):
  voxel         [4320, 2, n_voxels]   two fMRI repeats
  images        [4320, 6, 3, 224, 224]
  text_emb      [4320, 1280]          caption CLIP-bigG embedding
  clip_tokens   [4320, 60]            padded CLIP BPE tokens (pad=0)
  cls_label     [4320, 51]            multi-hot concept labels
  key_obj_masks [4320, 6, 224, 224]   binary key-object masks
  key_obj_cls   [4320]                key-object category id
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

MAX_TOKENS = 60
N_FRAMES = 6
IMG_SIZE = 224


@dataclass
class CC2017Split:
    voxel: np.ndarray
    images: np.ndarray
    text_emb: np.ndarray
    clip_tokens: Optional[np.ndarray] = None
    cls_label: Optional[np.ndarray] = None
    key_obj_masks: Optional[np.ndarray] = None
    key_obj_cls: Optional[np.ndarray] = None
    clip_image_target: Optional[np.ndarray] = None  # [N, F, 256, 1664] cache

    def __len__(self) -> int:
        return self.voxel.shape[0]

    @property
    def n_voxels(self) -> int:
        return self.voxel.shape[-1]


def load_split(root_dir: str, subj: int, train: bool) -> CC2017Split:
    """Load the released CC2017 tensors of one subject and split. torch
    reads the .pt files (weights only); everything becomes numpy. The
    test split's voxels are the mean over the repeats; its key-object
    masks (`masks/key_objects_masks_qwen_test.pt`, which stage e scores
    against) are optional, the train split's are not."""
    import torch

    tag = "train" if train else "test"

    def _load(name):
        return torch.load(os.path.join(root_dir, name), map_location="cpu",
                          weights_only=True)

    voxel = _load(f"subj0{subj}_{tag}_fmri.pt").float().numpy()
    if not train:
        voxel = voxel.mean(axis=1, keepdims=True)
    images = _load(f"GT_{tag}_3fps.pt").numpy()
    text_emb = _load(f"GT_{tag}_caption_emb.pt").float().numpy()

    with open(os.path.join(root_dir, "qwen_annotation",
                           f"qwen_{tag}_caption_tag_category_id.json")) as f:
        cls_json = json.load(f)
    cls_label = np.stack([_multi_hot(c["category_id"]) for c in cls_json])

    kw = {}
    if train:
        mask_name, info_name = ("key_objects_masks_train.pt",
                                "key_objects_info_train.json")
    else:
        mask_name, info_name = ("key_objects_masks_qwen_test.pt",
                                "key_objects_info_qwen_test.json")
    mask_path = os.path.join(root_dir, "masks", mask_name)
    if train or os.path.exists(mask_path):
        masks = _load(os.path.join("masks", mask_name))
        masks = (masks.numpy() > 0).astype(np.float32)
        with open(os.path.join(root_dir, "masks", info_name)) as f:
            info = json.load(f)
        from neurons_tpu_torch.data.categories import CLS_DICT
        name_to_id = {v: k for k, v in CLS_DICT.items()}
        key_cls = np.array([name_to_id.get(info[str(i)]["category"], 0)
                            for i in range(len(info))], np.int32)
        kw = dict(key_obj_masks=masks, key_obj_cls=key_cls)

    tokens = tokenize_captions(root_dir, tag)
    return CC2017Split(voxel=voxel, images=images, text_emb=text_emb,
                       clip_tokens=tokens, cls_label=cls_label, **kw)


def tokenize_captions(root_dir: str, tag: str) -> Optional[np.ndarray]:
    """CLIP-BPE tokens of the raw captions `GT_{tag}_caption.pt`, cut or
    zero-padded to 60; None when the file is absent. The captions are a
    pickled list or array of strings, read as the JAX package reads them
    (`weights_only=False`)."""
    path = os.path.join(root_dir, f"GT_{tag}_caption.pt")
    if not os.path.exists(path):
        return None
    import torch
    caps = torch.load(path, map_location="cpu", weights_only=False)
    from neurons_tpu_torch.data.clip_tokenizer import tokenize
    toks = tokenize(list(np.asarray(caps).reshape(-1)), context_length=77)
    out = np.zeros((len(toks), MAX_TOKENS), np.int64)
    for i, t in enumerate(toks):
        t = t[:MAX_TOKENS]
        out[i, :len(t)] = t
    return out


def _multi_hot(ids, n_classes: int = 51) -> np.ndarray:
    v = np.zeros((n_classes,), np.float32)
    ids = np.atleast_1d(np.asarray(ids)).astype(int)
    v[ids[(ids >= 0) & (ids < n_classes)]] = 1.0
    return v


def synthetic_split(n: int = 16, n_voxels: int = 120, n_frames: int = N_FRAMES,
                    img: int = 32, txt_dim: int = 24, n_classes: int = 7,
                    repeats: int = 2, seed: int = 0, train: bool = True
                    ) -> CC2017Split:
    """Random data with the exact field contract (the JAX package's draws
    from the same seed)."""
    g = np.random.default_rng(seed)
    return CC2017Split(
        voxel=g.normal(size=(n, repeats if train else 1, n_voxels)).astype(np.float32),
        images=g.uniform(size=(n, n_frames, 3, img, img)).astype(np.float32),
        text_emb=g.normal(size=(n, txt_dim)).astype(np.float32),
        clip_tokens=g.integers(1, 100, size=(n, MAX_TOKENS)).astype(np.int64),
        cls_label=(g.uniform(size=(n, n_classes)) < 0.2).astype(np.float32),
        key_obj_masks=(g.uniform(size=(n, n_frames, img, img)) < 0.3
                       ).astype(np.float32) if train else None,
        key_obj_cls=g.integers(0, n_classes, size=(n,)).astype(np.int32)
        if train else None,
    )


def structured_synthetic_split(n: int, n_voxels: int, *, seq: int = 16,
                               emb: int = 32, txt_dim: int = 24,
                               n_frames: int = N_FRAMES, img: int = 32,
                               n_classes: int = 51, latent_dim: int = 32,
                               vae_hw: int = 8, repeats: int = 2,
                               gen_seed: int = 7, seed: int = 0,
                               train: bool = True):
    """Learnable synthetic data for convergence runs: every modality is a
    fixed linear readout of a shared per-clip latent, so stage-1 retrieval
    and the stage-2 losses genuinely improve with training (unlike
    `synthetic_split`, whose targets are uncorrelated noise). The readout
    matrices are drawn from `gen_seed` and shared between train and test
    splits; the per-clip latents from `seed`.

    Returns (split, clip_targets [n, n_frames, seq, emb],
    aux dict with 'vae_latents' [n, n_frames, 4, vae_hw, vae_hw] and
    'class_text_embeds' [n_classes, txt_dim])."""
    gg = np.random.default_rng(gen_seed)
    k = latent_dim
    A = (gg.normal(size=(k, n_voxels)) / np.sqrt(k)).astype(np.float32)
    B = (gg.normal(size=(k, seq * emb)) / np.sqrt(k)).astype(np.float32)
    C = (gg.normal(size=(k, txt_dim)) / np.sqrt(k)).astype(np.float32)
    D = (gg.normal(size=(k, n_frames * 4 * vae_hw * vae_hw)) / np.sqrt(k)
         ).astype(np.float32)
    class_table = gg.normal(size=(n_classes, txt_dim)).astype(np.float32)

    g = np.random.default_rng(seed)
    z = g.normal(size=(n, k)).astype(np.float32)
    n_rep = repeats if train else 1
    voxel = (z @ A)[:, None] + 0.1 * g.normal(
        size=(n, n_rep, n_voxels)).astype(np.float32)
    base = (z @ B).reshape(n, 1, seq, emb)
    # per-frame jitter: frames share the clip's semantic content
    clip_targets = (base + 0.05 * g.normal(
        size=(n, n_frames, seq, emb))).astype(np.float32)
    split = CC2017Split(
        voxel=voxel.astype(np.float32),
        images=g.uniform(size=(n, n_frames, 3, img, img)).astype(np.float32),
        text_emb=(z @ C).astype(np.float32),
        clip_tokens=g.integers(1, 100, size=(n, MAX_TOKENS)).astype(np.int64),
        cls_label=(g.uniform(size=(n, n_classes)) < 0.2).astype(np.float32),
        key_obj_masks=(g.uniform(size=(n, n_frames, img, img)) < 0.3
                       ).astype(np.float32) if train else None,
        key_obj_cls=g.integers(0, n_classes, size=(n,)).astype(np.int32)
        if train else None,
    )
    aux = {"vae_latents": (z @ D).reshape(n, n_frames, 4, vae_hw, vae_hw),
           "class_text_embeds": class_table}
    return split, clip_targets, aux


def batches(split: CC2017Split, batch_size: int, seed: int = 0,
            shuffle: bool = True, drop_last: bool = True
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batch dicts of numpy arrays, each with the samples' dataset
    indices under "index"; with drop_last the trailing partial batch is
    dropped, so every batch has one shape."""
    n = len(split)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_last else n
    fields = {f.name: getattr(split, f.name)
              for f in dataclasses.fields(split)
              if getattr(split, f.name) is not None}
    for start in range(0, stop, batch_size):
        sel = idx[start:start + batch_size]
        out = {k: v[sel] for k, v in fields.items()}
        out["index"] = sel
        yield out
