"""Brain-decoding models: voxel -> CLIP-bigG image-token embeddings.

Counterpart of neurons_tpu/models/brain.py (inference path; dropout is
the identity there and is left out here):

  RidgeRegression      — per-subject voxel adapter
  BrainBackbone        — MLP-Mixer + token-grid projector
  CLIPProj             — pooled 1664 -> 1280 text-space
  MotionProj           — static -> per-frame embeddings
  MultiLabelClassifier — 51-way concept classifier

Flax's `nn.LayerNorm()` defaults to eps 1e-6 (torch's to 1e-5), and the
GELUs are exact (erf), as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch.config import BrainModelConfig

FLAX_LN_EPS = 1e-6


class RidgeRegression(nn.Module):
    """One Linear per subject; x [B, seq_len, n_voxels] ->
    [B, seq_len, out_features]."""

    def __init__(self, input_sizes: Sequence[int], out_features: int = 4096):
        super().__init__()
        for i, n in enumerate(input_sizes):
            self.add_module(f"subj{i}", nn.Linear(n, out_features))

    def forward(self, x: torch.Tensor, subj_idx: int = 0) -> torch.Tensor:
        return getattr(self, f"subj{subj_idx}")(x)


class _MixerMLP(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class _Projector(nn.Module):
    """3x (LayerNorm -> GELU -> Linear) token projector."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int):
        super().__init__()
        dims = [in_dim, hidden, hidden, out_dim]
        for i in range(3):
            self.add_module(f"LayerNorm_{i}",
                            nn.LayerNorm(dims[i], eps=FLAX_LN_EPS))
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(3):
            x = F.gelu(getattr(self, f"LayerNorm_{i}")(x))
            x = getattr(self, f"Dense_{i}")(x)
        return x


class BrainBackbone(nn.Module):
    """MLP-Mixer over (seq, hidden) + projection to the CLIP token grid.
    Returns (voxels_embed, clip_vision_embed), both
    [B, clip_seq_dim, clip_emb_dim]."""

    def __init__(self, cfg: BrainModelConfig):
        super().__init__()
        self.cfg = c = cfg
        for i in range(c.n_blocks):
            self.add_module(f"mix1_ln_{i}",
                            nn.LayerNorm(c.hidden_dim, eps=FLAX_LN_EPS))
            self.add_module(f"mix1_mlp_{i}",
                            _MixerMLP(c.hidden_dim, c.hidden_dim))
            self.add_module(f"mix2_ln_{i}",
                            nn.LayerNorm(c.seq_len, eps=FLAX_LN_EPS))
            self.add_module(f"mix2_mlp_{i}", _MixerMLP(c.seq_len, c.seq_len))
        self.backbone_linear = nn.Linear(c.seq_len * c.hidden_dim, c.out_dim)
        self.clip_proj = _Projector(c.clip_emb_dim, c.clip_emb_dim,
                                    c.clip_emb_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        residual1 = x
        residual2 = x.transpose(1, 2)
        for i in range(c.n_blocks):
            h = getattr(self, f"mix1_mlp_{i}")(getattr(self, f"mix1_ln_{i}")(x))
            x = h + residual1
            residual1 = x
            x = x.transpose(1, 2)
            h = getattr(self, f"mix2_mlp_{i}")(getattr(self, f"mix2_ln_{i}")(x))
            x = h + residual2
            residual2 = x
            x = x.transpose(1, 2)
        x = x.reshape(x.shape[0], -1)
        voxels_embed = self.backbone_linear(x).reshape(
            -1, c.clip_seq_dim, c.clip_emb_dim)
        return voxels_embed, self.clip_proj(voxels_embed)


class CLIPProj(nn.Module):
    """Mean-pool tokens, then project 1664 -> 1280 CLIP-text space."""

    def __init__(self, in_dim: int = 1664, out_dim: int = 1280):
        super().__init__()
        self.proj = nn.Parameter(torch.empty(in_dim, out_dim).normal_())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1) @ self.proj


class MotionProj(nn.Module):
    """Lift [B, N, C] to per-frame [B, F, N, C]: Linear(C -> C*F), the last
    dim split channel-major into (C, F)."""

    def __init__(self, n_frames: int = 6, clip_size: int = 1664):
        super().__init__()
        self.n_frames = n_frames
        self.motion_proj = nn.Linear(clip_size, clip_size * n_frames)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        m = self.motion_proj(x).reshape(b, n, c, self.n_frames)
        return m.permute(0, 3, 1, 2)


class MultiLabelClassifier(nn.Module):
    """Concept classifier on the pooled motion embedding."""

    def __init__(self, in_dim: int = 1664, in_channel_text: int = 1280,
                 class_num: int = 51):
        super().__init__()
        self.vision_proj_channel = nn.Linear(in_dim, in_channel_text)
        self.classifier = nn.Linear(in_channel_text, class_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.vision_proj_channel(x))
