"""Typed configuration for the PyTorch port (stage-3 subset).

The port's own copy of the JAX package's dataclasses
(neurons_tpu/config.py:63-321), with the same names and defaults, so a
configuration written for one package reads the same in the other. Only
the configurations stage 3 needs are here; GPT-2's lives in
models/gpt2.py, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Voxel counts per CC2017 subject.
SUBJECT_VOXELS = {1: 13447, 2: 14828, 3: 9114}

# CLIP ViT-bigG-14 dims.
CLIP_SEQ_DIM = 256
CLIP_EMB_DIM = 1664
CLIP_TXT_EMB_DIM = 1280


@dataclass(frozen=True)
class BrainModelConfig:
    """Voxel->CLIP brain encoder."""

    hidden_dim: int = 4096
    n_blocks: int = 4
    seq_len: int = 1
    dropout: float = 0.15
    clip_seq_dim: int = CLIP_SEQ_DIM
    clip_emb_dim: int = CLIP_EMB_DIM
    clip_txt_emb_dim: int = CLIP_TXT_EMB_DIM
    subjects: Tuple[int, ...] = (1,)

    @property
    def voxel_counts(self) -> Tuple[int, ...]:
        return tuple(SUBJECT_VOXELS[s] for s in self.subjects)

    @property
    def out_dim(self) -> int:
        return self.clip_emb_dim * self.clip_seq_dim


@dataclass(frozen=True)
class PriorConfig:
    """Diffusion prior over CLIP image tokens."""

    dim: int = CLIP_EMB_DIM
    depth: int = 6
    dim_head: int = 52
    heads: int = CLIP_EMB_DIM // 52  # 32
    num_tokens: int = CLIP_SEQ_DIM
    timesteps: int = 100
    cond_drop_prob: float = 0.2
    ff_mult: int = 4
    learned_query_mode: str = "pos_emb"
    causal: bool = False


@dataclass(frozen=True)
class DecouplerConfig:
    """Decoupler heads and the DecoderVideo upsampler."""

    n_frames: int = 6
    num_classes: int = 51
    clip_emb_dim: int = CLIP_EMB_DIM
    clip_txt_emb_dim: int = CLIP_TXT_EMB_DIM
    decoder_in_channels: int = 64
    decoder_block_out_channels: Tuple[int, ...] = (32, 64, 128)
    decoder_layers_per_block: int = 1


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (the SD first stage)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 256


@dataclass(frozen=True)
class UNet2DConfig:
    """SD-unCLIP denoising UNet: attention at downsample factors 4 and 2,
    a 1024-d adm vector added to the timestep embedding."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    transformer_depth: Tuple[int, ...] = (1, 2, 10)
    num_head_channels: int = 64
    context_dim: int = CLIP_EMB_DIM
    adm_in_channels: int = 1024
    use_linear_in_transformer: bool = True
    scale_factor: float = 0.13025


@dataclass(frozen=True)
class SamplerConfig:
    """Sampler shapes (38-step CFG-5 unCLIP, 100-step prior)."""

    unclip_steps: int = 38
    unclip_cfg_scale: float = 5.0
    offset_noise_level: float = 0.04
    prior_steps: int = 100
    video_steps: int = 25
    video_cfg_scale: float = 8.5
    low_strength: float = 0.3
    n_video_frames: int = 16


@dataclass(frozen=True)
class PipelineConfig:
    """The stage-3 configurations bundled."""

    brain: BrainModelConfig = field(default_factory=BrainModelConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    decoupler: DecouplerConfig = field(default_factory=DecouplerConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    unet2d: UNet2DConfig = field(default_factory=UNet2DConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)


def replace(cfg, **kwargs):
    """Functional update for any config dataclass."""
    return dataclasses.replace(cfg, **kwargs)


def tiny_pipeline_config() -> PipelineConfig:
    """A miniature config for CPU tests: same topology, tiny dims (the
    same values as the JAX package's tiny_pipeline_config)."""
    return PipelineConfig(
        brain=BrainModelConfig(hidden_dim=64, n_blocks=2, clip_seq_dim=16,
                               clip_emb_dim=32, clip_txt_emb_dim=24),
        prior=PriorConfig(dim=32, depth=2, dim_head=8, heads=4, num_tokens=16,
                          timesteps=10),
        decoupler=DecouplerConfig(n_frames=2, num_classes=7, clip_emb_dim=32,
                                  clip_txt_emb_dim=24,
                                  decoder_in_channels=8,
                                  decoder_block_out_channels=(8, 8, 8)),
        vae=VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                      norm_num_groups=4, sample_size=32),
        unet2d=UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                            num_res_blocks=1, transformer_depth=(1, 1),
                            num_head_channels=4, context_dim=32,
                            adm_in_channels=16, attention_resolutions=(2,)),
        sampler=SamplerConfig(unclip_steps=3, prior_steps=4, video_steps=3,
                              n_video_frames=4),
    )
