"""Typed configuration for the PyTorch port (stages 2, 3 and 5, SVD).

The port's own copy of the JAX package's dataclasses
(neurons_tpu/config.py:63-321), with the same names and defaults, so a
configuration written for one package reads the same in the other. Only
the configurations stages 2, 3 and 5 and the SVD stack need are here;
GPT-2's lives in models/gpt2.py and the CLIP text tower's in
models/clip.py, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
class TrainConfig:
    """Stage-1/2 trainer shape."""

    subj: int = 1
    batch_size: int = 10
    num_epochs: int = 150
    max_lr: float = 3e-4
    mixup_pct: float = 0.33
    prior_scale: float = 30.0
    lr_scheduler_type: str = "cycle"  # cycle | linear | cosine
    neurons_decoupler: bool = False
    n_frames: int = 6
    seed: int = 42
    num_train_samples: int = 4320
    num_test_samples: int = 1200
    mixco_temp: float = 0.006
    nce_temp: float = 0.1
    soft_temp_start: float = 0.004
    soft_temp_end: float = 0.0075
    weight_decay: float = 0.0
    ckpt_saving: bool = True
    grad_clip: float = 0.0  # 0 disables
    # bf16 module forwards with f32 master weights, gradients and losses
    bf16_autocast: bool = True


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
class UNet3DConfig:
    """AnimateDiff video UNet (SD-1.5 UNet inflated to video, with a
    temporal motion module after every spatial transformer)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    cross_attention_dim: int = 768  # SD-1.5 CLIP text
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_num_attention_heads: int = 8
    motion_num_transformer_block: int = 1
    motion_max_seq_length: int = 32
    motion_attention_block_types: Tuple[str, ...] = ("Temporal_Self",
                                                     "Temporal_Self")
    motion_zero_initialize: bool = True
    use_inflated_groupnorm: bool = True


@dataclass(frozen=True)
class VideoUNetConfig:
    """The SVD spatiotemporal UNet (img2vid): every spatial transformer is
    paired with a temporal mix stack and every res block with a temporal
    (3,1,1)-conv res stack, blended by a learned-with-images alpha."""

    in_channels: int = 8  # latent ++ conditioning frame concat
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    num_head_channels: int = 64
    context_dim: int = 1024  # CLIP-H image embedding
    adm_in_channels: int = 768  # fps / motion bucket / cond aug embeddings
    time_context_dim: int = 0  # 0 -> use_spatial_context
    video_kernel_size: Tuple[int, int, int] = (3, 1, 1)
    merge_strategy: str = "learned_with_images"
    merge_factor: float = 0.5
    extra_ff_mix_layer: bool = True
    use_spatial_context: bool = True
    disable_temporal_crossattention: bool = False
    max_ddpm_temb_period: int = 10000


@dataclass(frozen=True)
class VideoDecoderConfig:
    """The SVD temporal VAE decoder: the SD VAE decoder with a temporal res
    stack on every resnet block, a 3-D time-mix conv after conv_out, and
    (time_mode 'all' or 'attn-only') temporal attention at the mid block."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    video_kernel_size: Tuple[int, int, int] = (3, 3, 3)
    alpha: float = 0.0
    merge_strategy: str = "learned"
    time_mode: str = "conv-only"  # all | conv-only | attn-only


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
    """The stage-2, stage-3 and stage-5 configurations bundled."""

    brain: BrainModelConfig = field(default_factory=BrainModelConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    decoupler: DecouplerConfig = field(default_factory=DecouplerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    unet2d: UNet2DConfig = field(default_factory=UNet2DConfig)
    unet3d: UNet3DConfig = field(default_factory=UNet3DConfig)
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
        train=TrainConfig(batch_size=4, num_epochs=2, num_train_samples=16,
                          num_test_samples=8),
        vae=VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                      norm_num_groups=4, sample_size=32),
        unet2d=UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                            num_res_blocks=1, transformer_depth=(1, 1),
                            num_head_channels=4, context_dim=32,
                            adm_in_channels=16, attention_resolutions=(2,)),
        unet3d=UNet3DConfig(block_out_channels=(8, 16, 16, 16),
                            layers_per_block=1, cross_attention_dim=16,
                            attention_head_dim=4, norm_num_groups=4,
                            motion_num_attention_heads=2),
        sampler=SamplerConfig(unclip_steps=3, prior_steps=4, video_steps=3,
                              n_video_frames=4),
    )


# The named fast presets of the JAX package's CLI (--fast), the measured
# TGATE x PAB frontier: the stage-specific tgate / tgate_pab expansions
# for stage 3 ("recon") and stage 5 ("video").
FAST_PRESETS = {
    # sub-5% stage-3 deviation, the validated quality bar
    "quality": {"recon": dict(tgate=33, tgate_pab=2),
                "video": dict(tgate=10, tgate_pab=2)},
    "balanced": {"recon": dict(tgate=20, tgate_pab=2),
                 "video": dict(tgate=10, tgate_pab=2)},
    "max": {"recon": dict(tgate=10, tgate_pab=2),
            "video": dict(tgate=10, tgate_pab=2)},
}


def fast_options(preset: Optional[str]) -> Tuple[Dict, Dict]:
    """A preset name -> (stage 3's `unclip_sample` options, stage 5's
    `reconstruct_video` keywords); None gives the exact samplers."""
    if preset is None:
        return {}, {}
    p = FAST_PRESETS[preset]
    return ({"tgate_step": p["recon"]["tgate"],
             "tgate_pab": p["recon"]["tgate_pab"]},
            {"tgate_step": p["video"]["tgate"],
             "tgate_pab": p["video"]["tgate_pab"]})
