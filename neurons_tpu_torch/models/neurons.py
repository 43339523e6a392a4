"""The `Neurons` ensemble: one module bundling every stage-2/3 piece.

Counterpart of neurons_tpu/models/neurons.py, with the submodule names of
the flax tree (`core`, `prior_net`, `motion_proj`, `classifier`,
`text_seg_dec`, `text_dec`) so `interop.from_jax.load_jax_params` fills it
from a NeuronsDecoupler parameter tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import (BrainModelConfig, DecouplerConfig,
                                      PriorConfig)
from neurons_tpu_torch.models.brain import (BrainBackbone, CLIPProj,
                                            MixerDropout, MotionProj,
                                            MultiLabelClassifier,
                                            RidgeRegression)
from neurons_tpu_torch.models.decoder_video import (DecoderDropout,
                                                    TextDrivenDecoder)
from neurons_tpu_torch.models.gpt2 import GPT2Config, TextDecoder
from neurons_tpu_torch.models.prior import PriorNetwork


class NeuronsCore(nn.Module):
    """ridge -> backbone -> clipproj."""

    def __init__(self, cfg: BrainModelConfig):
        super().__init__()
        self.ridge = RidgeRegression(cfg.voxel_counts, cfg.hidden_dim)
        self.backbone = BrainBackbone(cfg)
        self.clipproj = CLIPProj(cfg.clip_emb_dim, cfg.clip_txt_emb_dim)

    def forward(self, voxel: torch.Tensor, subj_idx: int = 0,
                deterministic: bool = True,
                dropout_masks: Optional[MixerDropout] = None):
        """-> (voxels_embed, clip_vision_embeds, clip_text_embeds).
        `deterministic=False` applies the training dropout with the given
        `dropout_masks` (`draw_mixer_dropout`)."""
        if not deterministic and dropout_masks is None:
            raise ValueError("training dropout needs its keep masks "
                             "(draw_mixer_dropout)")
        voxels_embed, clip_vision = self.backbone(
            self.ridge(voxel, subj_idx),
            None if deterministic else dropout_masks)
        return voxels_embed, clip_vision, self.clipproj(clip_vision)


class NeuronsDecoupler(nn.Module):
    """Frozen core + prior + decoupler heads + GPT-2 captioner."""

    def __init__(self, brain_cfg: BrainModelConfig, prior_cfg: PriorConfig,
                 dec_cfg: DecouplerConfig, gpt2_cfg: GPT2Config = GPT2Config(),
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.core = NeuronsCore(brain_cfg)
            self.prior_net = PriorNetwork(prior_cfg)
            self.motion_proj = MotionProj(dec_cfg.n_frames,
                                          dec_cfg.clip_emb_dim)
            self.classifier = MultiLabelClassifier(
                dec_cfg.clip_emb_dim, dec_cfg.clip_txt_emb_dim,
                dec_cfg.num_classes)
            self.text_seg_dec = TextDrivenDecoder(
                dec_cfg.clip_emb_dim, dec_cfg.clip_txt_emb_dim,
                dec_cfg.decoder_block_out_channels,
                dec_cfg.decoder_layers_per_block)
            self.text_dec = TextDecoder(gpt2_cfg,
                                        prefix_size=dec_cfg.clip_txt_emb_dim)
        self.to(dtype)

    def encode(self, voxel, subj_idx: int = 0):
        return self.core(voxel, subj_idx)

    def prior_apply(self, image_embed, times, brain_embed,
                    brain_cond_drop_prob: float = 0.0,
                    image_cond_drop_prob: float = 0.0,
                    attn_bias: Optional[torch.Tensor] = None, **keep):
        """`keep`: the prior's `brain_keep`, `image_keep` or `generator`
        for a fractional cond drop."""
        return self.prior_net(image_embed, times, brain_embed,
                              brain_cond_drop_prob=brain_cond_drop_prob,
                              image_cond_drop_prob=image_cond_drop_prob,
                              attn_bias=attn_bias, **keep)

    def motion(self, prior_out):
        return self.motion_proj(prior_out)

    def classify(self, pooled_motion):
        return self.classifier(pooled_motion)

    def project_text(self, tokens):
        return self.core.clipproj(tokens)

    def seg_decode(self, vision_tokens, text_embed, time: int,
                   is_seg: bool = True, deterministic: bool = True,
                   dropout_masks: Optional[DecoderDropout] = None,
                   return_all: bool = False):
        return self.text_seg_dec(vision_tokens, text_embed, time=time,
                                 is_seg=is_seg, deterministic=deterministic,
                                 dropout_masks=dropout_masks,
                                 return_all=return_all)

    def caption_logits(self, clip_features, tokens):
        return self.text_dec(clip_features, tokens)

    def caption_greedy(self, clip_features, max_len: int = 60,
                       eot_token: int = 49407):
        return self.text_dec.greedy_decode(clip_features, max_len, eot_token)
