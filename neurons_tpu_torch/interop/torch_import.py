"""HF PyTorch checkpoints -> the port's modules, through the flax tree.

Counterpart of the importers of neurons_tpu/interop/torch_import.py that
stages 1-6 call, copied so that each returns the same nested numpy tree and
the same list of unused source keys as its JAX twin:

  * HF CLIPVisionModel(WithProjection)        -> models.clip.CLIPVisionTower
  * HF ViTForImageClassification              -> models.vit.ViTClassifier
  * HF VideoMAEForVideoClassification         -> models.vit.ViTClassifier
  * HF Blip2ForConditionalGeneration (OPT)    -> models.blip2.Blip2Captioner
  * HF GPT-2                                  -> models.gpt2.TextDecoder
  * HF CLIPTextModel (SD-1.5's text encoder)  -> models.clip.CLIPTextTower
  * open_clip bigG vision and text towers     -> models.clip (precompute)
  * diffusers / LDM AutoencoderKL             -> models.vae.AutoencoderKL
  * LDM/sgm UNet (the unclip6 checkpoint)     -> models.unet2d.UNetModel
  * sgm SVD VideoUNet and temporal decoder    -> models.video_unet,
                                                 models.temporal_ae
  * diffusers SD-1.5 UNet + AnimateDiff
    motion modules                            -> models.unet3d.UNet3DModel
  * AnimateDiff SparseCtrl                    -> models.sparse_controlnet
  * the reference's NEURONS ensemble, stage-1
    core, MindEye2 backbone, coco clipproj    -> models.neurons
plus the helpers of the loaders (`strip_prefix`, `ldm_apply_ema`,
`filter_motion_module`, `merge_lora`).

`interop/from_jax.py:load_jax_params` then fills the port module from the
tree; `load_torch_checkpoint` does both steps. Conventions: torch Linear
weight [out, in] -> flax kernel [in, out]; Conv2d [out, in, kh, kw] ->
[kh, kw, in, out]; Conv3d [out, in, kt, kh, kw] -> [kt, kh, kw, in, out].
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from neurons_tpu_torch.interop.from_jax import load_jax_params


def t2j(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def linear(sd: Dict, key: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": t2j(sd[f"{key}.weight"]).T}
    if bias and f"{key}.bias" in sd:
        out["bias"] = t2j(sd[f"{key}.bias"])
    return out


def conv(sd: Dict, key: str, bias: bool = True) -> Dict[str, np.ndarray]:
    w = t2j(sd[f"{key}.weight"])
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if bias and f"{key}.bias" in sd:
        out["bias"] = t2j(sd[f"{key}.bias"])
    return out


def norm(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    return {"scale": t2j(sd[f"{key}.weight"]), "bias": t2j(sd[f"{key}.bias"])}


class _Tracker:
    """Wraps a state dict and records consumed keys."""

    def __init__(self, sd: Dict):
        self.sd = {k: v for k, v in sd.items()}
        self.used = set()

    def __contains__(self, k):
        return k in self.sd

    def __getitem__(self, k):
        self.used.add(k)
        return self.sd[k]

    def keys(self):
        return self.sd.keys()

    def unused(self) -> List[str]:
        return sorted(set(self.sd) - self.used)


def load_torch_checkpoint(module: nn.Module, importer: Callable,
                          state_dict: Dict, *args,
                          allow_unused: bool = False) -> List[str]:
    """`importer(state_dict, *args)` then `load_jax_params(module, tree)`.
    Raises on source keys the importer left unused unless `allow_unused`;
    returns them."""
    params, unused = importer(state_dict, *args)
    if unused and not allow_unused:
        raise ValueError(f"{importer.__name__}: {len(unused)} unused source "
                         f"keys {unused[:8]}")
    load_jax_params(module, params)
    return unused


# ---------------------------------------------------------------------------
# HF CLIP vision -> models.clip.CLIPVisionTower
# ---------------------------------------------------------------------------

def import_hf_clip_vision(state_dict: Dict, layers: int
                          ) -> Tuple[Dict, List[str]]:
    """HF CLIPVisionModel(WithProjection) -> CLIPVisionTower params."""
    sd = _Tracker({k.replace("vision_model.", ""): v
                   for k, v in state_dict.items()})
    params: Dict[str, Any] = {
        "patch_embed": {"kernel": t2j(
            sd["embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": t2j(sd["embeddings.class_embedding"]),
        "positional_embedding": t2j(
            sd["embeddings.position_embedding.weight"]),
        "ln_pre": norm(sd, "pre_layrnorm") if "pre_layrnorm.weight" in sd
        else norm(sd, "pre_layernorm"),
        "ln_post": norm(sd, "post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        params["proj"] = t2j(sd["visual_projection.weight"]).T
    for i in range(layers):
        p = f"encoder.layers.{i}"
        qw = t2j(sd[f"{p}.self_attn.q_proj.weight"])
        kw = t2j(sd[f"{p}.self_attn.k_proj.weight"])
        vw = t2j(sd[f"{p}.self_attn.v_proj.weight"])
        qb = t2j(sd[f"{p}.self_attn.q_proj.bias"])
        kb = t2j(sd[f"{p}.self_attn.k_proj.bias"])
        vb = t2j(sd[f"{p}.self_attn.v_proj.bias"])
        params[f"resblock_{i}"] = {
            "ln_1": norm(sd, f"{p}.layer_norm1"),
            "in_proj": {"kernel": np.concatenate([qw, kw, vw], 0).T,
                        "bias": np.concatenate([qb, kb, vb], 0)},
            "out_proj": linear(sd, f"{p}.self_attn.out_proj"),
            "ln_2": norm(sd, f"{p}.layer_norm2"),
            "mlp_fc": linear(sd, f"{p}.mlp.fc1"),
            "mlp_proj": linear(sd, f"{p}.mlp.fc2"),
        }
    return params, sd.unused()


# ---------------------------------------------------------------------------
# HF metric classifiers (google/vit-base, MCG-NJU/videomae) -> models.vit
# ---------------------------------------------------------------------------

def _hf_vit_block(sd, p: str) -> Dict[str, Any]:
    blk = {
        "ln_1": norm(sd, f"{p}.layernorm_before"),
        "q": linear(sd, f"{p}.attention.attention.query"),
        "k": linear(sd, f"{p}.attention.attention.key"),
        "v": linear(sd, f"{p}.attention.attention.value"),
        "attn_out": linear(sd, f"{p}.attention.output.dense"),
        "ln_2": norm(sd, f"{p}.layernorm_after"),
        "mlp_fc": linear(sd, f"{p}.intermediate.dense"),
        "mlp_proj": linear(sd, f"{p}.output.dense"),
    }
    # VideoMAE: biasless q/k/v linears and separate q_bias/v_bias (k zero)
    if f"{p}.attention.attention.q_bias" in sd:
        d = blk["q"]["kernel"].shape[1]
        blk["q"]["bias"] = t2j(sd[f"{p}.attention.attention.q_bias"])
        blk["k"]["bias"] = np.zeros((d,), np.float32)
        blk["v"]["bias"] = t2j(sd[f"{p}.attention.attention.v_bias"])
    return blk


def import_hf_vit_classifier(state_dict: Dict, layers: int
                             ) -> Tuple[Dict, List[str]]:
    """HF ViTForImageClassification (the frame metric's
    google/vit-base-patch16-224) -> ViTClassifier params."""
    sd = _Tracker({k: v for k, v in state_dict.items()
                   if "position_ids" not in k})
    p: Dict[str, Any] = {
        "patch_embed": conv(sd, "vit.embeddings.patch_embeddings.projection"),
        "cls_token": t2j(sd["vit.embeddings.cls_token"]),
        "pos_embed": t2j(sd["vit.embeddings.position_embeddings"])[0],
        "ln_post": norm(sd, "vit.layernorm"),
        "head": linear(sd, "classifier"),
    }
    for i in range(layers):
        p[f"block_{i}"] = _hf_vit_block(sd, f"vit.encoder.layer.{i}")
    return p, sd.unused()


def _sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """VideoMAE's fixed sinusoidal positions (computed, not stored)."""
    pos = np.arange(n_position)[:, None]
    div = np.power(10000.0, 2 * (np.arange(d_hid) // 2) / d_hid)[None]
    table = pos / div
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


def import_videomae_classifier(state_dict: Dict, layers: int,
                               num_tokens: int) -> Tuple[Dict, List[str]]:
    """HF VideoMAEForVideoClassification (the video metric's
    MCG-NJU/videomae-base-finetuned-kinetics) -> ViTClassifier params: the
    tubelet Dense is the reshaped Conv3d, the sinusoidal positions are
    recomputed."""
    sd = _Tracker(dict(state_dict))
    w = t2j(sd["videomae.embeddings.patch_embeddings.projection.weight"])
    d = w.shape[0]
    # [d, ch, ts, ph, pw] -> Dense kernel [(ts ph pw ch), d]
    kernel = w.transpose(2, 3, 4, 1, 0).reshape(-1, d)
    p: Dict[str, Any] = {
        "patch_embed": {
            "kernel": kernel,
            "bias": t2j(
                sd["videomae.embeddings.patch_embeddings.projection.bias"])},
        "pos_embed": _sinusoid_table(num_tokens, d),
        "ln_post": norm(sd, "fc_norm"),
        "head": linear(sd, "classifier"),
    }
    for i in range(layers):
        p[f"block_{i}"] = _hf_vit_block(sd, f"videomae.encoder.layer.{i}")
    return p, sd.unused()


# ---------------------------------------------------------------------------
# HF BLIP-2 (Salesforce/blip2-opt-*) -> models.blip2.Blip2Captioner
# ---------------------------------------------------------------------------

def import_blip2(state_dict: Dict, cfg) -> Tuple[Dict, List[str]]:
    """HF Blip2ForConditionalGeneration state dict -> Blip2Captioner params
    (the lm_head is weight-tied to embed_tokens and dropped)."""
    sd = _Tracker({k: v for k, v in state_dict.items()
                   if not k.startswith("language_model.lm_head")})
    p: Dict[str, Any] = {
        "query_tokens": t2j(sd["query_tokens"]),
        "language_projection": linear(sd, "language_projection"),
        "embed_tokens": t2j(
            sd["language_model.model.decoder.embed_tokens.weight"]),
    }

    v: Dict[str, Any] = {
        "patch_embed": conv(sd, "vision_model.embeddings.patch_embedding"),
        "class_embedding": t2j(
            sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "position_embedding": t2j(
            sd["vision_model.embeddings.position_embedding"])[0],
        "post_layernorm": norm(sd, "vision_model.post_layernorm"),
    }
    for i in range(cfg.vision.layers):
        q = f"vision_model.encoder.layers.{i}"
        v[f"layer_{i}"] = {
            "layer_norm1": norm(sd, f"{q}.layer_norm1"),
            "qkv": linear(sd, f"{q}.self_attn.qkv"),
            "projection": linear(sd, f"{q}.self_attn.projection"),
            "layer_norm2": norm(sd, f"{q}.layer_norm2"),
            "fc1": linear(sd, f"{q}.mlp.fc1"),
            "fc2": linear(sd, f"{q}.mlp.fc2"),
        }
    p["vision_model"] = v

    def qf_attn(prefix):
        return {"query": linear(sd, f"{prefix}.attention.query"),
                "key": linear(sd, f"{prefix}.attention.key"),
                "value": linear(sd, f"{prefix}.attention.value"),
                "out_dense": linear(sd, f"{prefix}.output.dense"),
                "out_ln": norm(sd, f"{prefix}.output.LayerNorm")}

    qf: Dict[str, Any] = {"layernorm": norm(sd, "qformer.layernorm")}
    for i in range(cfg.qformer.layers):
        q = f"qformer.encoder.layer.{i}"
        layer = {"attention": qf_attn(f"{q}.attention"),
                 "intermediate_query": linear(
                     sd, f"{q}.intermediate_query.dense"),
                 "output_query": linear(sd, f"{q}.output_query.dense"),
                 "output_ln": norm(sd, f"{q}.output_query.LayerNorm")}
        if f"{q}.crossattention.attention.query.weight" in sd:
            layer["crossattention"] = qf_attn(f"{q}.crossattention")
        qf[f"layer_{i}"] = layer
    p["qformer"] = qf

    lm: Dict[str, Any] = {
        "embed_positions": t2j(
            sd["language_model.model.decoder.embed_positions.weight"]),
        "final_layer_norm": norm(
            sd, "language_model.model.decoder.final_layer_norm"),
    }
    for i in range(cfg.opt.layers):
        q = f"language_model.model.decoder.layers.{i}"
        lm[f"layer_{i}"] = {
            "self_attn_layer_norm": norm(sd, f"{q}.self_attn_layer_norm"),
            "q_proj": linear(sd, f"{q}.self_attn.q_proj"),
            "k_proj": linear(sd, f"{q}.self_attn.k_proj"),
            "v_proj": linear(sd, f"{q}.self_attn.v_proj"),
            "out_proj": linear(sd, f"{q}.self_attn.out_proj"),
            "final_layer_norm": norm(sd, f"{q}.final_layer_norm"),
            "fc1": linear(sd, f"{q}.fc1"),
            "fc2": linear(sd, f"{q}.fc2"),
        }
    p["lm"] = lm
    return p, sd.unused()


# ---------------------------------------------------------------------------
# Shared helpers: sub-model selection, 1x1 convs as linears, LoRA, EMA
# ---------------------------------------------------------------------------

def strip_prefix(state_dict: Dict, prefix: str) -> Dict:
    """Select the sub-model of a Lightning checkpoint (e.g.
    'model.diffusion_model.' or 'first_stage_model.' of the unclip6 ckpt,
    reference recon_keyframe_neurons.py:257-259)."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _maybe_1x1(w: np.ndarray) -> np.ndarray:
    """A torch 1x1 Conv2d weight [out, in, 1, 1] used as a linear ->
    flax Dense kernel [in, out]."""
    if w.ndim == 4:
        w = w.squeeze(-1).squeeze(-1)
    return w.T


def _lin_or_1x1(sd, key) -> Dict[str, np.ndarray]:
    out = {"kernel": _maybe_1x1(t2j(sd[f"{key}.weight"]))}
    if f"{key}.bias" in sd:
        out["bias"] = t2j(sd[f"{key}.bias"])
    return out

def merge_lora(weight: np.ndarray, up: np.ndarray, down: np.ndarray,
               alpha: float = 0.75) -> np.ndarray:
    """W += alpha * up @ down (reference convert_lora...py:50-120). Handles
    conv LoRA by squeezing the trailing 1x1 dims."""
    if up.ndim == 4:
        up = up.squeeze(-1).squeeze(-1)
        down = down.squeeze(-1).squeeze(-1)
        delta = (up @ down)[:, :, None, None]
    else:
        delta = up @ down
    return weight + alpha * delta


def ldm_apply_ema(state_dict: Dict) -> Tuple[Dict, int]:
    """Swap LitEma shadow weights into the live UNet params — the
    inference-time effect of the reference's `ema_scope()` (reference
    sgm/modules/ema.py:41-60 stores each param 'a.b.c' of `self.model`
    under 'model_ema.' + 'abc', dots stripped; utils.py:307 enters the
    scope around unclip sampling). Returns (new state dict, n swapped)."""
    ema = {k[len("model_ema."):]: v for k, v in state_dict.items()
           if k.startswith("model_ema.")
           and k not in ("model_ema.num_updates", "model_ema.decay")}
    out = dict(state_dict)
    swapped = 0
    for k in state_dict:
        if not k.startswith("model."):
            continue
        mangled = k[len("model."):].replace(".", "")
        if mangled in ema:
            out[k] = ema[mangled]
            swapped += 1
    return out, swapped


def filter_motion_module(state_dict: Dict) -> Dict:
    """reference animatediff/utils/util.py:106-122: keep only
    'motion_modules.' entries and drop the recomputed positional buffer."""
    return {k: v for k, v in state_dict.items()
            if "motion_modules." in k and "pos_encoder.pe" not in k}


# ---------------------------------------------------------------------------
# HF GPT-2 -> models.gpt2.TextDecoder
# ---------------------------------------------------------------------------

def import_gpt2(state_dict: Dict, n_layer: int) -> Tuple[Dict, List[str]]:
    """HF GPT2LMHeadModel state dict -> TextDecoder params subtree
    {wte, lm: {wpe, h_i: {...}, ln_f}}. GPT-2 Conv1D weights are stored
    [in, out] (no transpose)."""
    sd = _Tracker({k.replace("transformer.", ""): v
                   for k, v in state_dict.items()
                   if not k.startswith("lm_head")})
    params: Dict[str, Any] = {
        "wte": t2j(sd["wte.weight"]),
        "lm": {"wpe": t2j(sd["wpe.weight"]),
               "ln_f": norm(sd, "ln_f")},
    }
    for i in range(n_layer):
        p = f"h.{i}"
        params["lm"][f"h_{i}"] = {
            "ln_1": norm(sd, f"{p}.ln_1"),
            "c_attn": {"kernel": t2j(sd[f"{p}.attn.c_attn.weight"]),
                       "bias": t2j(sd[f"{p}.attn.c_attn.bias"])},
            "c_proj": {"kernel": t2j(sd[f"{p}.attn.c_proj.weight"]),
                       "bias": t2j(sd[f"{p}.attn.c_proj.bias"])},
            "ln_2": norm(sd, f"{p}.ln_2"),
            "mlp_fc": {"kernel": t2j(sd[f"{p}.mlp.c_fc.weight"]),
                       "bias": t2j(sd[f"{p}.mlp.c_fc.bias"])},
            "mlp_proj": {"kernel": t2j(sd[f"{p}.mlp.c_proj.weight"]),
                         "bias": t2j(sd[f"{p}.mlp.c_proj.bias"])},
        }
    unused = [k for k in sd.unused() if not k.endswith("attn.bias")
              and not k.endswith("attn.masked_bias")]
    return params, unused


# ---------------------------------------------------------------------------
# open_clip bigG towers (precompute's frozen encoders) -> models.clip
# ---------------------------------------------------------------------------

def _open_clip_block(sd, p: str) -> Dict[str, Any]:
    return {
        "ln_1": norm(sd, f"{p}.ln_1"),
        "in_proj": {"kernel": t2j(sd[f"{p}.attn.in_proj_weight"]).T,
                    "bias": t2j(sd[f"{p}.attn.in_proj_bias"])},
        "out_proj": linear(sd, f"{p}.attn.out_proj"),
        "ln_2": norm(sd, f"{p}.ln_2"),
        "mlp_fc": linear(sd, f"{p}.mlp.c_fc"),
        "mlp_proj": linear(sd, f"{p}.mlp.c_proj"),
    }


def import_open_clip_vision(state_dict: Dict, layers: int,
                            prefix: str = "visual."
                            ) -> Tuple[Dict, List[str]]:
    """open_clip VisionTransformer (the bigG tower the reference embeds
    with) -> CLIPVisionTower params; keys outside `prefix` are ignored."""
    sd = _Tracker({k[len(prefix):]: v for k, v in state_dict.items()
                   if k.startswith(prefix)})
    params: Dict[str, Any] = {
        "patch_embed": {"kernel": t2j(sd["conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": t2j(sd["class_embedding"]),
        "positional_embedding": t2j(sd["positional_embedding"]),
        "ln_pre": norm(sd, "ln_pre"),
        "ln_post": norm(sd, "ln_post"),
        "proj": t2j(sd["proj"]),
    }
    for i in range(layers):
        params[f"resblock_{i}"] = _open_clip_block(
            sd, f"transformer.resblocks.{i}")
    return params, sd.unused()


def import_open_clip_text(state_dict: Dict, layers: int
                          ) -> Tuple[Dict, List[str]]:
    """open_clip text tower (the reference's FrozenOpenCLIPEmbedder2) ->
    CLIPTextTower params; the `visual.` keys are ignored."""
    sd = _Tracker({k: v for k, v in state_dict.items()
                   if not k.startswith("visual.")})
    params: Dict[str, Any] = {
        "token_embedding": t2j(sd["token_embedding.weight"]),
        "positional_embedding": t2j(sd["positional_embedding"]),
        "ln_final": norm(sd, "ln_final"),
        "text_projection": t2j(sd["text_projection"]),
    }
    for i in range(layers):
        params[f"resblock_{i}"] = _open_clip_block(
            sd, f"transformer.resblocks.{i}")
    return params, sd.unused()


# ---------------------------------------------------------------------------
# HF CLIP text (SD-1.5's text encoder) -> models.clip.CLIPTextTower
# ---------------------------------------------------------------------------

def import_hf_clip_text(state_dict: Dict, layers: int
                        ) -> Tuple[Dict, List[str]]:
    """HF CLIPTextModel (SD-1.5's `cond_stage_model.transformer`, openai/
    clip-vit-large-patch14 layout) -> CLIPTextTower params."""
    sd = _Tracker({k.replace("text_model.", ""): v
                   for k, v in state_dict.items()
                   if "position_ids" not in k})
    params: Dict[str, Any] = {
        "token_embedding": t2j(sd["embeddings.token_embedding.weight"]),
        "positional_embedding": t2j(
            sd["embeddings.position_embedding.weight"]),
        "ln_final": norm(sd, "final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        params["text_projection"] = t2j(sd["text_projection.weight"]).T
    for i in range(layers):
        p = f"encoder.layers.{i}"
        qw = t2j(sd[f"{p}.self_attn.q_proj.weight"])
        kw = t2j(sd[f"{p}.self_attn.k_proj.weight"])
        vw = t2j(sd[f"{p}.self_attn.v_proj.weight"])
        qb = t2j(sd[f"{p}.self_attn.q_proj.bias"])
        kb = t2j(sd[f"{p}.self_attn.k_proj.bias"])
        vb = t2j(sd[f"{p}.self_attn.v_proj.bias"])
        params[f"resblock_{i}"] = {
            "ln_1": norm(sd, f"{p}.layer_norm1"),
            "in_proj": {"kernel": np.concatenate([qw, kw, vw], 0).T,
                        "bias": np.concatenate([qb, kb, vb], 0)},
            "out_proj": linear(sd, f"{p}.self_attn.out_proj"),
            "ln_2": norm(sd, f"{p}.layer_norm2"),
            "mlp_fc": linear(sd, f"{p}.mlp.fc1"),
            "mlp_proj": linear(sd, f"{p}.mlp.fc2"),
        }
    return params, sd.unused()


# ---------------------------------------------------------------------------
# diffusers AutoencoderKL -> models.vae.AutoencoderKL
# ---------------------------------------------------------------------------

def import_diffusers_vae(state_dict: Dict, num_blocks: int,
                         layers_per_block: int = 2
                         ) -> Tuple[Dict, List[str]]:
    sd = _Tracker(dict(state_dict))
    p: Dict[str, Any] = {
        "quant_conv": conv(sd, "quant_conv"),
        "post_quant_conv": conv(sd, "post_quant_conv"),
        "encoder": {"conv_in": conv(sd, "encoder.conv_in"),
                    "norm_out": norm(sd, "encoder.conv_norm_out"),
                    "conv_out": conv(sd, "encoder.conv_out")},
        "decoder": {"conv_in": conv(sd, "decoder.conv_in"),
                    "norm_out": norm(sd, "decoder.conv_norm_out"),
                    "conv_out": conv(sd, "decoder.conv_out")},
    }

    def resnet(prefix):
        r = {"norm1": norm(sd, f"{prefix}.norm1"),
             "conv1": conv(sd, f"{prefix}.conv1"),
             "norm2": norm(sd, f"{prefix}.norm2"),
             "conv2": conv(sd, f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in sd:
            r["nin_shortcut"] = conv(sd, f"{prefix}.conv_shortcut")
        return r

    def attn(prefix):
        return {"norm": norm(sd, f"{prefix}.group_norm"),
                "q": linear(sd, f"{prefix}.to_q"),
                "k": linear(sd, f"{prefix}.to_k"),
                "v": linear(sd, f"{prefix}.to_v"),
                "proj_out": linear(sd, f"{prefix}.to_out.0")}

    for i in range(num_blocks):
        for j in range(layers_per_block):
            p["encoder"][f"down_{i}_block_{j}"] = resnet(
                f"encoder.down_blocks.{i}.resnets.{j}")
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            p["encoder"][f"down_{i}_downsample"] = {
                "conv": conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
        for j in range(layers_per_block + 1):
            key = f"decoder.up_blocks.{i}.resnets.{j}"
            if f"{key}.norm1.weight" in sd:
                p["decoder"][f"up_{i}_block_{j}"] = resnet(key)
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            p["decoder"][f"up_{i}_upsample"] = {
                "conv": conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}

    for tower in ("encoder", "decoder"):
        p[tower]["mid_block_1"] = resnet(f"{tower}.mid_block.resnets.0")
        p[tower]["mid_block_2"] = resnet(f"{tower}.mid_block.resnets.1")
        p[tower]["mid_attn"] = attn(f"{tower}.mid_block.attentions.0")
    return p, sd.unused()


# ---------------------------------------------------------------------------
# LDM/sgm UNet (unclip6 Lightning ckpt) -> models.unet2d.UNetModel
# ---------------------------------------------------------------------------

def _ldm_resblock(sd, p: str) -> Dict[str, Any]:
    """OpenAI-UNet ResBlock (reference openaimodel.py:210-356):
    in_layers(GN,SiLU,conv) / emb_layers(SiLU,linear) / out_layers
    (GN,SiLU,drop,conv) / skip_connection."""
    r = {"in_norm": norm(sd, f"{p}.in_layers.0"),
         "in_conv": conv(sd, f"{p}.in_layers.2"),
         "emb_proj": linear(sd, f"{p}.emb_layers.1"),
         "out_norm": norm(sd, f"{p}.out_layers.0"),
         "out_conv": conv(sd, f"{p}.out_layers.3")}
    if f"{p}.skip_connection.weight" in sd:
        r["skip_conv"] = conv(sd, f"{p}.skip_connection")
    return r


def _ldm_transformer(sd, p: str, depth: int) -> Dict[str, Any]:
    """sgm SpatialTransformer (reference attention.py:619-759); proj_in/
    proj_out are Linear under use_linear_in_transformer, else 1x1 conv."""
    t: Dict[str, Any] = {"norm": norm(sd, f"{p}.norm"),
                         "proj_in": _lin_or_1x1(sd, f"{p}.proj_in"),
                         "proj_out": _lin_or_1x1(sd, f"{p}.proj_out")}
    for d in range(depth):
        q = f"{p}.transformer_blocks.{d}"
        t[f"block_{d}"] = {
            "norm1": norm(sd, f"{q}.norm1"),
            "attn1": {"to_q": linear(sd, f"{q}.attn1.to_q"),
                      "to_k": linear(sd, f"{q}.attn1.to_k"),
                      "to_v": linear(sd, f"{q}.attn1.to_v"),
                      "to_out": linear(sd, f"{q}.attn1.to_out.0")},
            "norm2": norm(sd, f"{q}.norm2"),
            "attn2": {"to_q": linear(sd, f"{q}.attn2.to_q"),
                      "to_k": linear(sd, f"{q}.attn2.to_k"),
                      "to_v": linear(sd, f"{q}.attn2.to_v"),
                      "to_out": linear(sd, f"{q}.attn2.to_out.0")},
            "norm3": norm(sd, f"{q}.norm3"),
            "ff": {"proj_in": linear(sd, f"{q}.ff.net.0.proj"),
                   "proj_out": linear(sd, f"{q}.ff.net.2")},
        }
    return t


def import_ldm_unet(state_dict: Dict, cfg) -> Tuple[Dict, List[str]]:
    """LDM/sgm `model.diffusion_model` state dict -> UNetModel params.

    cfg is a config.UNet2DConfig; the input/output block
    indexing follows reference openaimodel.py:526-699 (input_blocks),
    :707-784 (output_blocks)."""
    sd = _Tracker(dict(state_dict))
    levels = len(cfg.channel_mult)
    nres = cfg.num_res_blocks
    p: Dict[str, Any] = {
        "time_embed_0": linear(sd, "time_embed.0"),
        "time_embed_2": linear(sd, "time_embed.2"),
        "conv_in": conv(sd, "input_blocks.0.0"),
        "out_norm": norm(sd, "out.0"),
        "out_conv": conv(sd, "out.2"),
        "mid_res_0": _ldm_resblock(sd, "middle_block.0"),
        "mid_attn": _ldm_transformer(sd, "middle_block.1",
                                     cfg.transformer_depth[-1]),
        "mid_res_1": _ldm_resblock(sd, "middle_block.2"),
    }
    if "label_emb.0.0.weight" in sd:  # num_classes='sequential' (adm)
        p["label_emb_0"] = linear(sd, "label_emb.0.0")
        p["label_emb_2"] = linear(sd, "label_emb.0.2")

    idx, ds = 1, 1
    for level in range(levels):
        for i in range(nres):
            p[f"down_{level}_res_{i}"] = _ldm_resblock(
                sd, f"input_blocks.{idx}.0")
            if ds in cfg.attention_resolutions:
                p[f"down_{level}_attn_{i}"] = _ldm_transformer(
                    sd, f"input_blocks.{idx}.1",
                    cfg.transformer_depth[level])
            idx += 1
        if level != levels - 1:
            p[f"down_{level}_downsample"] = {
                "op": conv(sd, f"input_blocks.{idx}.0.op")}
            idx += 1
            ds *= 2

    idx = 0
    for level in reversed(range(levels)):
        for i in range(nres + 1):
            p[f"up_{level}_res_{i}"] = _ldm_resblock(
                sd, f"output_blocks.{idx}.0")
            sub = 1
            if ds in cfg.attention_resolutions:
                p[f"up_{level}_attn_{i}"] = _ldm_transformer(
                    sd, f"output_blocks.{idx}.1",
                    cfg.transformer_depth[level])
                sub = 2
            if level and i == nres:
                p[f"up_{level}_upsample"] = {
                    "conv": conv(sd, f"output_blocks.{idx}.{sub}.conv")}
                ds //= 2
            idx += 1
    return p, sd.unused()


# ---------------------------------------------------------------------------
# LDM VAE (sgm AutoencoderKL / `first_stage_model`) -> models.vae
# ---------------------------------------------------------------------------

def import_ldm_vae(state_dict: Dict, cfg) -> Tuple[Dict, List[str]]:
    """sgm/LDM AutoencoderKL layout (reference sgm/modules/
    diffusionmodules/model.py Encoder/Decoder; `first_stage_model.` of the
    unclip6 ckpt). Differs from diffusers: down.{i}.block.{j}, mid.block_1/
    attn_1/block_2, decoder.up INDEXED IN REVERSE application order, and
    1x1-conv attention projections."""
    sd = _Tracker(dict(state_dict))
    nres = len(cfg.block_out_channels)

    def resnet(prefix):
        r = {"norm1": norm(sd, f"{prefix}.norm1"),
             "conv1": conv(sd, f"{prefix}.conv1"),
             "norm2": norm(sd, f"{prefix}.norm2"),
             "conv2": conv(sd, f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.weight" in sd:
            r["nin_shortcut"] = conv(sd, f"{prefix}.nin_shortcut")
        return r

    def attn(prefix):
        return {"norm": norm(sd, f"{prefix}.norm"),
                "q": _lin_or_1x1(sd, f"{prefix}.q"),
                "k": _lin_or_1x1(sd, f"{prefix}.k"),
                "v": _lin_or_1x1(sd, f"{prefix}.v"),
                "proj_out": _lin_or_1x1(sd, f"{prefix}.proj_out")}

    p: Dict[str, Any] = {
        "quant_conv": conv(sd, "quant_conv"),
        "post_quant_conv": conv(sd, "post_quant_conv"),
        "encoder": {"conv_in": conv(sd, "encoder.conv_in"),
                    "norm_out": norm(sd, "encoder.norm_out"),
                    "conv_out": conv(sd, "encoder.conv_out"),
                    "mid_block_1": resnet("encoder.mid.block_1"),
                    "mid_attn": attn("encoder.mid.attn_1"),
                    "mid_block_2": resnet("encoder.mid.block_2")},
        "decoder": {"conv_in": conv(sd, "decoder.conv_in"),
                    "norm_out": norm(sd, "decoder.norm_out"),
                    "conv_out": conv(sd, "decoder.conv_out"),
                    "mid_block_1": resnet("decoder.mid.block_1"),
                    "mid_attn": attn("decoder.mid.attn_1"),
                    "mid_block_2": resnet("decoder.mid.block_2")},
    }
    for i in range(nres):
        for j in range(cfg.layers_per_block):
            p["encoder"][f"down_{i}_block_{j}"] = resnet(
                f"encoder.down.{i}.block.{j}")
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            p["encoder"][f"down_{i}_downsample"] = {
                "conv": conv(sd, f"encoder.down.{i}.downsample.conv")}
        # decoder.up is built with insert(0, ...) — up.{nres-1} runs first
        # (reference model.py Decoder), our up_{i} runs in order.
        src = nres - 1 - i
        for j in range(cfg.layers_per_block + 1):
            p["decoder"][f"up_{i}_block_{j}"] = resnet(
                f"decoder.up.{src}.block.{j}")
        if f"decoder.up.{src}.upsample.conv.weight" in sd:
            p["decoder"][f"up_{i}_upsample"] = {
                "conv": conv(sd, f"decoder.up.{src}.upsample.conv")}
    return p, sd.unused()


# ---------------------------------------------------------------------------
# SVD video model (sgm VideoUNet + temporal VAE decoder) -> models.video_unet,
# models.temporal_ae
# ---------------------------------------------------------------------------

def conv3(sd, key: str) -> Dict[str, np.ndarray]:
    """torch Conv3d [out, in, kt, kh, kw] -> flax NDHWC [kt, kh, kw, in, out]."""
    out = {"kernel": t2j(sd[f"{key}.weight"]).transpose(2, 3, 4, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = t2j(sd[f"{key}.bias"])
    return out


def _ldm_resblock3d(sd, p: str) -> Dict[str, Any]:
    """Temporal res stack (openaimodel ResBlock with dims=3; reference
    video_model.py:42-55 / temporal_ae.py:32-44)."""
    r = {"in_norm": norm(sd, f"{p}.in_layers.0"),
         "in_conv": conv3(sd, f"{p}.in_layers.2"),
         "out_norm": norm(sd, f"{p}.out_layers.0"),
         "out_conv": conv3(sd, f"{p}.out_layers.3")}
    if f"{p}.emb_layers.1.weight" in sd:
        r["emb_proj"] = linear(sd, f"{p}.emb_layers.1")
    if f"{p}.skip_connection.weight" in sd:
        r["skip_conv"] = conv3(sd, f"{p}.skip_connection")
    return r


def _mix_factor(sd, p: str) -> Dict[str, np.ndarray]:
    return {"mix_factor": t2j(sd[f"{p}.mix_factor"])}


def _video_resblock(sd, p: str) -> Dict[str, Any]:
    """reference video_model.py:12-81 VideoResBlock: spatial ResBlock keys
    live directly at `p`, temporal stack at `p.time_stack`."""
    return {"spatial": _ldm_resblock(sd, p),
            "time_stack": _ldm_resblock3d(sd, f"{p}.time_stack"),
            "time_mixer": _mix_factor(sd, f"{p}.time_mixer")}


def _video_tblock(sd, q: str) -> Dict[str, Any]:
    """reference video_attention.py:15-143 VideoTransformerBlock."""
    t: Dict[str, Any] = {
        "norm1": norm(sd, f"{q}.norm1"),
        "attn1": {"to_q": linear(sd, f"{q}.attn1.to_q"),
                  "to_k": linear(sd, f"{q}.attn1.to_k"),
                  "to_v": linear(sd, f"{q}.attn1.to_v"),
                  "to_out": linear(sd, f"{q}.attn1.to_out.0")},
        "norm3": norm(sd, f"{q}.norm3"),
        "ff": {"proj_in": linear(sd, f"{q}.ff.net.0.proj"),
               "proj_out": linear(sd, f"{q}.ff.net.2")},
    }
    if f"{q}.norm_in.weight" in sd:  # ff_in
        t["norm_in"] = norm(sd, f"{q}.norm_in")
        t["ff_in"] = {"proj_in": linear(sd, f"{q}.ff_in.net.0.proj"),
                      "proj_out": linear(sd, f"{q}.ff_in.net.2")}
    if f"{q}.norm2.weight" in sd:  # temporal cross-attn present
        t["norm2"] = norm(sd, f"{q}.norm2")
        t["attn2"] = {"to_q": linear(sd, f"{q}.attn2.to_q"),
                      "to_k": linear(sd, f"{q}.attn2.to_k"),
                      "to_v": linear(sd, f"{q}.attn2.to_v"),
                      "to_out": linear(sd, f"{q}.attn2.to_out.0")}
    return t


def _video_transformer(sd, p: str, depth: int) -> Dict[str, Any]:
    """reference video_attention.py:146-301 SpatialVideoTransformer: the
    spatial SpatialTransformer keys plus time_stack / time_pos_embed /
    time_mixer."""
    t = _ldm_transformer(sd, p, depth)
    for d in range(depth):
        t[f"time_stack_{d}"] = _video_tblock(sd, f"{p}.time_stack.{d}")
    t["time_pos_embed_0"] = linear(sd, f"{p}.time_pos_embed.0")
    t["time_pos_embed_2"] = linear(sd, f"{p}.time_pos_embed.2")
    t["time_mixer"] = _mix_factor(sd, f"{p}.time_mixer")
    return t


def import_svd_unet(state_dict: Dict, cfg) -> Tuple[Dict, List[str]]:
    """sgm `model.diffusion_model` of an SVD checkpoint -> VideoUNet
    params (reference video_model.py:84-493; block indexing identical to
    import_ldm_unet with video res/transformer blocks)."""
    sd = _Tracker(dict(state_dict))
    levels = len(cfg.channel_mult)
    nres = cfg.num_res_blocks
    p: Dict[str, Any] = {
        "time_embed_0": linear(sd, "time_embed.0"),
        "time_embed_2": linear(sd, "time_embed.2"),
        "conv_in": conv(sd, "input_blocks.0.0"),
        "out_norm": norm(sd, "out.0"),
        "out_conv": conv(sd, "out.2"),
        "mid_res_0": _video_resblock(sd, "middle_block.0"),
        "mid_attn": _video_transformer(sd, "middle_block.1",
                                       cfg.transformer_depth[-1]),
        "mid_res_1": _video_resblock(sd, "middle_block.2"),
    }
    if "label_emb.0.0.weight" in sd:
        p["label_emb_0"] = linear(sd, "label_emb.0.0")
        p["label_emb_2"] = linear(sd, "label_emb.0.2")

    idx, ds = 1, 1
    for level in range(levels):
        for i in range(nres):
            p[f"down_{level}_res_{i}"] = _video_resblock(
                sd, f"input_blocks.{idx}.0")
            if ds in cfg.attention_resolutions:
                p[f"down_{level}_attn_{i}"] = _video_transformer(
                    sd, f"input_blocks.{idx}.1", cfg.transformer_depth[level])
            idx += 1
        if level != levels - 1:
            p[f"down_{level}_downsample"] = {
                "op": conv(sd, f"input_blocks.{idx}.0.op")}
            idx += 1
            ds *= 2

    idx = 0
    for level in reversed(range(levels)):
        for i in range(nres + 1):
            p[f"up_{level}_res_{i}"] = _video_resblock(
                sd, f"output_blocks.{idx}.0")
            sub = 1
            if ds in cfg.attention_resolutions:
                p[f"up_{level}_attn_{i}"] = _video_transformer(
                    sd, f"output_blocks.{idx}.1", cfg.transformer_depth[level])
                sub = 2
            if level and i == nres:
                p[f"up_{level}_upsample"] = {
                    "conv": conv(sd, f"output_blocks.{idx}.{sub}.conv")}
                ds //= 2
            idx += 1
    return p, sd.unused()


def import_video_decoder(state_dict: Dict, cfg) -> Tuple[Dict, List[str]]:
    """sgm temporal VAE decoder (`first_stage_model.decoder.` of an SVD
    ckpt) -> models.temporal_ae.VideoDecoder params (reference
    temporal_ae.py:293-349; VAE resnet keys at the block root, temporal
    stack under `.time_stack`, conv_out gains `.time_mix_conv`).
    cfg is a VideoDecoderConfig."""
    sd = _Tracker(dict(state_dict))
    v = cfg.vae
    nres = len(v.block_out_channels)
    conv_time = cfg.time_mode in ("all", "conv-only")
    attn_time = cfg.time_mode in ("all", "attn-only")
    res_time = cfg.time_mode in ("all", "conv-only")

    def resnet(prefix):
        r = {"norm1": norm(sd, f"{prefix}.norm1"),
             "conv1": conv(sd, f"{prefix}.conv1"),
             "norm2": norm(sd, f"{prefix}.norm2"),
             "conv2": conv(sd, f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.weight" in sd:
            r["nin_shortcut"] = conv(sd, f"{prefix}.nin_shortcut")
        return r

    def vres(prefix):
        if not res_time:
            return resnet(prefix)
        # temporal_ae.py:46-54 registers mix_factor directly on the block
        # (no AlphaBlender submodule, unlike video_model.py)
        return {"spatial": resnet(prefix),
                "time_stack": _ldm_resblock3d(sd, f"{prefix}.time_stack"),
                "time_mixer": _mix_factor(sd, prefix)}

    def attn(prefix):
        a = {"norm": norm(sd, f"{prefix}.norm"),
             "q": _lin_or_1x1(sd, f"{prefix}.q"),
             "k": _lin_or_1x1(sd, f"{prefix}.k"),
             "v": _lin_or_1x1(sd, f"{prefix}.v"),
             "proj_out": _lin_or_1x1(sd, f"{prefix}.proj_out")}
        if attn_time:
            a["time_mix_block"] = _video_tblock(sd, f"{prefix}.time_mix_block")
            a["video_time_embed_0"] = linear(sd, f"{prefix}.video_time_embed.0")
            a["video_time_embed_2"] = linear(sd, f"{prefix}.video_time_embed.2")
            a["time_mixer"] = _mix_factor(sd, prefix)
        return a

    p: Dict[str, Any] = {
        "conv_in": conv(sd, "conv_in"),
        "norm_out": norm(sd, "norm_out"),
        "mid_block_1": vres("mid.block_1"),
        "mid_attn": attn("mid.attn_1"),
        "mid_block_2": vres("mid.block_2"),
    }
    if conv_time:
        p["conv_out"] = {"conv": conv(sd, "conv_out"),
                         "time_mix_conv": conv3(sd, "conv_out.time_mix_conv")}
    else:
        p["conv_out"] = conv(sd, "conv_out")
    for i in range(nres):
        src = nres - 1 - i  # decoder.up is reverse-indexed (see import_ldm_vae)
        for j in range(v.layers_per_block + 1):
            p[f"up_{i}_block_{j}"] = vres(f"up.{src}.block.{j}")
        if f"up.{src}.upsample.conv.weight" in sd:
            p[f"up_{i}_upsample"] = {
                "conv": conv(sd, f"up.{src}.upsample.conv")}
    return p, sd.unused()


# ---------------------------------------------------------------------------
# diffusers SD-1.5 UNet + AnimateDiff motion modules -> models.unet3d
# ---------------------------------------------------------------------------

def _diffusers_resnet(sd, p: str) -> Dict[str, Any]:
    r = {"norm1": norm(sd, f"{p}.norm1"),
         "conv1": conv(sd, f"{p}.conv1"),
         "time_emb_proj": linear(sd, f"{p}.time_emb_proj"),
         "norm2": norm(sd, f"{p}.norm2"),
         "conv2": conv(sd, f"{p}.conv2")}
    if f"{p}.conv_shortcut.weight" in sd:
        r["conv_shortcut"] = conv(sd, f"{p}.conv_shortcut")
    return r


def _diffusers_transformer(sd, p: str) -> Dict[str, Any]:
    """diffusers Transformer2DModel depth-1 (SD-1.5: 1x1-conv proj_in/out)
    -> our Transformer3D flat naming (block_0_*)."""
    q = f"{p}.transformer_blocks.0"
    return {
        "norm": norm(sd, f"{p}.norm"),
        "proj_in": _lin_or_1x1(sd, f"{p}.proj_in"),
        "proj_out": _lin_or_1x1(sd, f"{p}.proj_out"),
        "block_0_norm1": norm(sd, f"{q}.norm1"),
        "block_0_attn1": {"to_q": linear(sd, f"{q}.attn1.to_q"),
                          "to_k": linear(sd, f"{q}.attn1.to_k"),
                          "to_v": linear(sd, f"{q}.attn1.to_v"),
                          "to_out": linear(sd, f"{q}.attn1.to_out.0")},
        "block_0_norm2": norm(sd, f"{q}.norm2"),
        "block_0_attn2": {"to_q": linear(sd, f"{q}.attn2.to_q"),
                          "to_k": linear(sd, f"{q}.attn2.to_k"),
                          "to_v": linear(sd, f"{q}.attn2.to_v"),
                          "to_out": linear(sd, f"{q}.attn2.to_out.0")},
        "block_0_norm3": norm(sd, f"{q}.norm3"),
        "block_0_ff": {"proj_in": linear(sd, f"{q}.ff.net.0.proj"),
                       "proj_out": linear(sd, f"{q}.ff.net.2")},
    }


def import_animatediff_unet3d(state_dict: Dict, cfg
                              ) -> Tuple[Dict, List[str]]:
    """diffusers SD-1.5 UNet2DConditionModel state dict -> UNet3DModel
    params (the reference `from_pretrained_2d` path, unet.py:478-572 —
    2D convs apply per-frame in the folded [(B F), H, W, C] layout, so
    weights transfer unchanged). Motion-module params are NOT in this
    checkpoint; merge them afterwards with import_motion_modules."""
    sd = _Tracker(dict(state_dict))
    p: Dict[str, Any] = {
        "conv_in": conv(sd, "conv_in"),
        "time_emb_1": linear(sd, "time_embedding.linear_1"),
        "time_emb_2": linear(sd, "time_embedding.linear_2"),
        "conv_norm_out": norm(sd, "conv_norm_out"),
        "conv_out": conv(sd, "conv_out"),
        "mid_res_0": _diffusers_resnet(sd, "mid_block.resnets.0"),
        "mid_attn": _diffusers_transformer(sd, "mid_block.attentions.0"),
        "mid_res_1": _diffusers_resnet(sd, "mid_block.resnets.1"),
    }
    for i, btype in enumerate(cfg.down_block_types):
        is_cross = btype.startswith("CrossAttn")
        for j in range(cfg.layers_per_block):
            p[f"down_{i}_res_{j}"] = _diffusers_resnet(
                sd, f"down_blocks.{i}.resnets.{j}")
            if is_cross:
                p[f"down_{i}_attn_{j}"] = _diffusers_transformer(
                    sd, f"down_blocks.{i}.attentions.{j}")
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            p[f"down_{i}_downsample"] = conv(
                sd, f"down_blocks.{i}.downsamplers.0.conv")
    for i, btype in enumerate(cfg.up_block_types):
        is_cross = btype.startswith("CrossAttn")
        for j in range(cfg.layers_per_block + 1):
            p[f"up_{i}_res_{j}"] = _diffusers_resnet(
                sd, f"up_blocks.{i}.resnets.{j}")
            if is_cross:
                p[f"up_{i}_attn_{j}"] = _diffusers_transformer(
                    sd, f"up_blocks.{i}.attentions.{j}")
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            p[f"up_{i}_upsample"] = conv(
                sd, f"up_blocks.{i}.upsamplers.0.conv")
    return p, sd.unused()


def _motion_module(sd, p: str, num_blocks: int, num_attn: int
                   ) -> Dict[str, Any]:
    """AnimateDiff TemporalTransformer3DModel (reference motion_module.py:
    173-222) -> our MotionModule flat naming. pos_encoder.pe buffers are
    recomputed, not imported (reference util.py:106-122 drops them)."""
    t = f"{p}.temporal_transformer"
    m: Dict[str, Any] = {"norm": norm(sd, f"{t}.norm"),
                         "proj_in": linear(sd, f"{t}.proj_in"),
                         "proj_out": linear(sd, f"{t}.proj_out")}
    for b in range(num_blocks):
        q = f"{t}.transformer_blocks.{b}"
        for a in range(num_attn):
            m[f"block_{b}_attn_{a}_norm"] = norm(sd, f"{q}.norms.{a}")
            m[f"block_{b}_attn_{a}"] = {
                "to_q": linear(sd, f"{q}.attention_blocks.{a}.to_q"),
                "to_k": linear(sd, f"{q}.attention_blocks.{a}.to_k"),
                "to_v": linear(sd, f"{q}.attention_blocks.{a}.to_v"),
                "to_out": linear(sd, f"{q}.attention_blocks.{a}.to_out.0")}
        m[f"block_{b}_ff_norm"] = norm(sd, f"{q}.ff_norm")
        m[f"block_{b}_ff"] = {"proj_in": linear(sd, f"{q}.ff.net.0.proj"),
                              "proj_out": linear(sd, f"{q}.ff.net.2")}
    return m


def import_motion_modules(state_dict: Dict, cfg, params: Dict
                          ) -> Tuple[Dict, List[str]]:
    """AnimateDiff motion-module ckpt (already passed through
    filter_motion_module) merged INTO unet3d params in place of the
    randomly-initialised motion submodules."""
    sd = _Tracker(dict(state_dict))
    nb = cfg.motion_num_transformer_block
    na = len(cfg.motion_attention_block_types)
    for i in range(len(cfg.down_block_types)):
        for j in range(cfg.layers_per_block):
            key = f"down_blocks.{i}.motion_modules.{j}"
            if f"{key}.temporal_transformer.norm.weight" in sd:
                params[f"down_{i}_motion_{j}"] = _motion_module(
                    sd, key, nb, na)
    for i in range(len(cfg.up_block_types)):
        for j in range(cfg.layers_per_block + 1):
            key = f"up_blocks.{i}.motion_modules.{j}"
            if f"{key}.temporal_transformer.norm.weight" in sd:
                params[f"up_{i}_motion_{j}"] = _motion_module(
                    sd, key, nb, na)
    if "mid_block.motion_modules.0.temporal_transformer.norm.weight" in sd:
        params["mid_motion_0"] = _motion_module(
            sd, "mid_block.motion_modules.0", nb, na)
    return params, sd.unused()


# ---------------------------------------------------------------------------
# AnimateDiff SparseCtrl ckpt -> models.sparse_controlnet
# ---------------------------------------------------------------------------

def import_sparse_controlnet(state_dict: Dict, cfg,
                             motion_attention_blocks: int = 1
                             ) -> Tuple[Dict, List[str]]:
    """AnimateDiff SparseControlNetModel state dict (reference
    animatediff/models/sparse_controlnet.py:85-315; v3_sd15_sparsectrl
    ckpts) -> SparseControlNetModel params. Handles both the simplified
    (single zero conv, latent conditioning) and full conv-stack condition
    embeddings; mid-block motion modules, absent from our mid (matching
    v3 configs), surface in the unused report."""
    sd = _Tracker(dict(state_dict))
    nb = cfg.motion_num_transformer_block
    p: Dict[str, Any] = {
        "conv_in": conv(sd, "conv_in"),
        "time_emb_1": linear(sd, "time_embedding.linear_1"),
        "time_emb_2": linear(sd, "time_embedding.linear_2"),
        "mid_res_0": _diffusers_resnet(sd, "mid_block.resnets.0"),
        "mid_attn": _diffusers_transformer(sd, "mid_block.attentions.0"),
        "mid_res_1": _diffusers_resnet(sd, "mid_block.resnets.1"),
        "controlnet_mid": conv(sd, "controlnet_mid_block"),
    }
    if "controlnet_cond_embedding.weight" in sd:  # simplified (zero conv)
        p["cond_embedding"] = conv(sd, "controlnet_cond_embedding")
    else:
        p["cond_in"] = conv(sd, "controlnet_cond_embedding.conv_in")
        p["cond_out"] = conv(sd, "controlnet_cond_embedding.conv_out")
        i = 0
        while f"controlnet_cond_embedding.blocks.{2 * i}.weight" in sd:
            p[f"cond_b{i}a"] = conv(
                sd, f"controlnet_cond_embedding.blocks.{2 * i}")
            p[f"cond_b{i}b"] = conv(
                sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}")
            i += 1
    k = 0
    while f"controlnet_down_blocks.{k}.weight" in sd:
        p[f"controlnet_down_{k}"] = conv(sd, f"controlnet_down_blocks.{k}")
        k += 1
    for i, btype in enumerate(cfg.down_block_types):
        is_cross = btype.startswith("CrossAttn")
        for j in range(cfg.layers_per_block):
            p[f"down_{i}_res_{j}"] = _diffusers_resnet(
                sd, f"down_blocks.{i}.resnets.{j}")
            if is_cross:
                p[f"down_{i}_attn_{j}"] = _diffusers_transformer(
                    sd, f"down_blocks.{i}.attentions.{j}")
            key = f"down_blocks.{i}.motion_modules.{j}"
            if f"{key}.temporal_transformer.norm.weight" in sd:
                p[f"down_{i}_motion_{j}"] = _motion_module(
                    sd, key, nb, motion_attention_blocks)
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            p[f"down_{i}_downsample"] = conv(
                sd, f"down_blocks.{i}.downsamplers.0.conv")
    return p, sd.unused()


# ---------------------------------------------------------------------------
# Reference NEURONS ensemble ckpt (brain_model[_prior].pth) -> NeuronsDecoupler
# ---------------------------------------------------------------------------

def _gain(sd, key) -> Dict[str, np.ndarray]:
    """dalle2 gain-only LayerNorm parameter `g` (any stored shape)."""
    return {"g": t2j(sd[f"{key}.g"]).reshape(-1)}


def _mixer_backbone(sd, n_blocks: int) -> Dict[str, Any]:
    """reference BrainModel (BrainModel_neurons.py:227-305): mixer_blocks
    are Sequential(LayerNorm, Sequential(Linear, GELU, Dropout, Linear));
    clip_proj is the 4-linear projector (indices 0,2,3,5,6,8)."""
    p: Dict[str, Any] = {
        "backbone_linear": linear(sd, "backbone.backbone_linear"),
        "clip_proj": {
            "LayerNorm_0": norm(sd, "backbone.clip_proj.0"),
            "Dense_0": linear(sd, "backbone.clip_proj.2"),
            "LayerNorm_1": norm(sd, "backbone.clip_proj.3"),
            "Dense_1": linear(sd, "backbone.clip_proj.5"),
            "LayerNorm_2": norm(sd, "backbone.clip_proj.6"),
            "Dense_2": linear(sd, "backbone.clip_proj.8"),
        },
    }
    for i in range(n_blocks):
        for blk, ours in (("mixer_blocks1", "mix1"), ("mixer_blocks2",
                                                      "mix2")):
            p[f"{ours}_ln_{i}"] = norm(sd, f"backbone.{blk}.{i}.0")
            p[f"{ours}_mlp_{i}"] = {
                "Dense_0": linear(sd, f"backbone.{blk}.{i}.1.0"),
                "Dense_1": linear(sd, f"backbone.{blk}.{i}.1.3"),
            }
    return p


def _dalle2_prior_net(sd, depth: int,
                      prefix: str = "diffusion_prior.net.") -> Dict[str, Any]:
    """dalle2-pytorch DiffusionPriorNetwork layout (the reference vendors
    its usage, BrainModel_neurons.py:484-686): continuous-time Sequential
    (SinusoidalPosEmb, MLP(depth 2)) embedder, FlaggedCausalTransformer of
    [Attention(multi-query, null_kv), FeedForward(SwiGLU)] pairs."""
    ct = prefix + "causal_transformer."
    tr: Dict[str, Any] = {
        "rel_pos_bias": {"rel_bias": t2j(
            sd[ct + "rel_pos_bias.relative_attention_bias.weight"])},
        "norm_out": _gain(sd, ct + "norm"),
        "project_out": linear(sd, ct + "project_out"),
    }
    for i in range(depth):
        a = ct + f"layers.{i}.0"
        tr[f"attn_{i}"] = {
            "norm": _gain(sd, f"{a}.norm"),
            "null_kv": t2j(sd[f"{a}.null_kv"]),
            "to_q": linear(sd, f"{a}.to_q"),
            "to_kv": linear(sd, f"{a}.to_kv"),
            "to_out": {"kernel": t2j(sd[f"{a}.to_out.0.weight"]).T},
            "out_norm": _gain(sd, f"{a}.to_out.1"),
        }
        f = ct + f"layers.{i}.1"
        tr[f"ff_{i}"] = {
            "norm": _gain(sd, f"{f}.0"),
            "proj_in": linear(sd, f"{f}.1"),
            "proj_out": linear(sd, f"{f}.5"),
        }
    return {
        "null_brain_embeds": t2j(sd[prefix + "null_brain_embeds"]),
        "null_image_embed": t2j(sd[prefix + "null_image_embed"]),
        "learned_query": t2j(sd[prefix + "learned_query"]),
        "time_mlp": {
            "Dense_0": linear(sd, prefix + "to_time_embeds.0.1.net.0.0"),
            "Dense_1": linear(sd, prefix + "to_time_embeds.0.1.net.1.0"),
            "Dense_2": linear(sd, prefix + "to_time_embeds.0.1.net.2"),
        },
        "transformer": tr,
    }


def _decoder_video(sd, prefix: str, n_up: int, layers_per_block: int
                   ) -> Dict[str, Any]:
    """reference model_variants/video_decoder.py DecoderVideo: diffusers
    resnets/attentions + temporal attentions with learned blend scalars."""

    def resnet(key):
        r = {"norm1": norm(sd, f"{key}.norm1"),
             "conv1": conv(sd, f"{key}.conv1"),
             "norm2": norm(sd, f"{key}.norm2"),
             "conv2": conv(sd, f"{key}.conv2")}
        if f"{key}.conv_shortcut.weight" in sd:
            r["conv_shortcut"] = conv(sd, f"{key}.conv_shortcut")
        return r

    def attn(key):
        return {"group_norm": norm(sd, f"{key}.group_norm"),
                "to_q": linear(sd, f"{key}.to_q"),
                "to_k": linear(sd, f"{key}.to_k"),
                "to_v": linear(sd, f"{key}.to_v"),
                "to_out": linear(sd, f"{key}.to_out.0")}

    p: Dict[str, Any] = {
        "conv_in": conv(sd, f"{prefix}.conv_in"),
        "conv_norm_out": norm(sd, f"{prefix}.conv_norm_out"),
        "mid_block": {
            "resnet_0": resnet(f"{prefix}.mid_block.resnets.0"),
            "st_attn_0": {
                "attn": attn(f"{prefix}.mid_block.attentions.0"),
                "temp_attn": attn(f"{prefix}.mid_block.temp_attentions.0"),
                "blend_weight": t2j(sd[f"{prefix}.mid_block.weights.0"]),
            },
            "resnet_1": resnet(f"{prefix}.mid_block.resnets.1"),
        },
    }
    for i in range(n_up):
        blk: Dict[str, Any] = {}
        for j in range(layers_per_block + 1):
            blk[f"resnet_{j}"] = resnet(f"{prefix}.up_blocks.{i}.resnets.{j}")
            blk[f"st_attn_{j}"] = {
                "attn": attn(f"{prefix}.up_blocks.{i}.attentions.{j}"),
                "temp_attn": attn(
                    f"{prefix}.up_blocks.{i}.temp_attentions.{j}"),
                "blend_weight": t2j(
                    sd[f"{prefix}.up_blocks.{i}.weights.{j}"]),
            }
        if f"{prefix}.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = {
                "conv": conv(sd, f"{prefix}.up_blocks.{i}.upsamplers.0.conv")}
        p[f"up_block_{i}"] = blk
    return p


def _neurons_core(sd, n_blocks: int) -> Dict[str, Any]:
    """backbone + per-subject ridge + clipproj (the NeuronsCore subtree,
    reference Neurons container members, BrainModel_neurons.py:204-226)."""
    core: Dict[str, Any] = {"backbone": _mixer_backbone(sd, n_blocks)}
    ridge: Dict[str, Any] = {}
    i = 0
    while f"ridge.linears.{i}.weight" in sd:
        ridge[f"subj{i}"] = linear(sd, f"ridge.linears.{i}")
        i += 1
    core["ridge"] = ridge
    core["clipproj"] = {"proj": t2j(sd["clipproj.proj"])}
    return core


def import_neurons_core(state_dict: Dict, n_blocks: int = 4
                        ) -> Tuple[Dict, List[str]]:
    """Stage-1 `brain_model.pth` model_state_dict (backbone/ridge/clipproj
    only) -> NeuronsCore params — the strict=False overlay the reference
    applies before stage-2 training (train_neurons.py:219-221)."""
    sd = _Tracker(dict(state_dict))
    return _neurons_core(sd, n_blocks), sd.unused()


def import_mindeye_backbone(state_dict: Dict, n_blocks: int = 4
                            ) -> Tuple[Dict, List[str]]:
    """MindEye2 `last.pth` model_state_dict -> shared mixer-backbone
    overlay (reference train_neurons.py:208-216: strict=False load of the
    MindEye2 checkpoint to warm-start convergence, after which `ridge` and
    `clipproj` are re-initialised fresh — so ONLY backbone.* survives)."""
    sd = _Tracker(dict(state_dict))
    return {"backbone": _mixer_backbone(sd, n_blocks)}, sd.unused()


def import_coco_clipproj(state_dict: Dict) -> Tuple[Dict, List[str]]:
    """`coco_tokens_avg_proj.pth` -> CLIPProj params (reference
    train_neurons.py:240-241: the frozen 1664->1280 image-token ->
    caption-embedding projector, loaded from root_dir for BOTH stages
    and kept requires_grad_(False) throughout)."""
    sd = _Tracker(dict(state_dict))
    return {"proj": t2j(sd["proj"])}, sd.unused()


def import_neurons_ensemble(state_dict: Dict, n_blocks: int = 4,
                            prior_depth: int = 6, gpt2_layers: int = 12,
                            decoder_up_blocks: int = 3,
                            decoder_layers_per_block: int = 1
                            ) -> Tuple[Dict, List[str]]:
    """Reference `brain_model_prior[_last].pth` model_state_dict (the
    Neurons container ensemble, reference train_neurons.py:48-61,148-226)
    -> NeuronsDecoupler params, so OUR inference stages run with the
    REFERENCE's released trained weights. Noise-scheduler buffers under
    diffusion_prior.* (betas etc.) are recomputed, not imported."""
    sd = _Tracker({k: v for k, v in state_dict.items()
                   if not (k.startswith("diffusion_prior.")
                           and ".net." not in k)})
    p: Dict[str, Any] = {"core": _neurons_core(sd, n_blocks)}
    p["prior_net"] = _dalle2_prior_net(sd, prior_depth)
    p["motion_proj"] = {"motion_proj": linear(sd, "motion_proj.motion_proj")}
    p["classifier"] = {
        "vision_proj_channel": linear(sd, "classifier.vision_proj_channel"),
        "classifier": linear(sd, "classifier.classifier")}

    tsd: Dict[str, Any] = {
        "q": linear(sd, "text_seg_dec.q"),
        "k": linear(sd, "text_seg_dec.k"),
        "v": linear(sd, "text_seg_dec.v"),
        "out": linear(sd, "text_seg_dec.out"),
        "norm": norm(sd, "text_seg_dec.norm"),
        "maps_0": conv(sd, "text_seg_dec.maps_projector.0"),
        "maps_gn_0": norm(sd, "text_seg_dec.maps_projector.1"),
        "maps_1": conv(sd, "text_seg_dec.maps_projector.3"),
        "maps_gn_1": norm(sd, "text_seg_dec.maps_projector.4"),
        "maps_2": conv(sd, "text_seg_dec.maps_projector.6"),
        "video_decoder": _decoder_video(sd, "text_seg_dec.video_decoder",
                                        decoder_up_blocks,
                                        decoder_layers_per_block),
        "seg_head": conv(sd, "text_seg_dec.seg_head"),
        "recon_head": conv(sd, "text_seg_dec.recon_head"),
    }
    p["text_seg_dec"] = tsd

    gpt2_sd = {k[len("text_dec.decoder."):]: sd[k] for k in list(sd.keys())
               if k.startswith("text_dec.decoder.")}
    gpt2_params, gpt2_unused = import_gpt2(gpt2_sd, gpt2_layers)
    gpt2_params["clip_project"] = linear(sd, "text_dec.clip_project.model.0")
    p["text_dec"] = gpt2_params
    # re-prefix the GPT-2 sub-importer's unused keys into the report
    unused = sd.unused() + [f"text_dec.decoder.{k}" for k in gpt2_unused]
    return p, sorted(unused)
