"""HF PyTorch checkpoints -> the port's modules, through the flax tree.

Counterpart of the importers of neurons_tpu/interop/torch_import.py that
stages 4 and 6 call, copied so that each returns the same nested numpy
tree and the same list of unused source keys as its JAX twin:

  * HF CLIPVisionModel(WithProjection)        -> models.clip.CLIPVisionTower
  * HF ViTForImageClassification              -> models.vit.ViTClassifier
  * HF VideoMAEForVideoClassification         -> models.vit.ViTClassifier
  * HF Blip2ForConditionalGeneration (OPT)    -> models.blip2.Blip2Captioner

`interop/from_jax.py:load_jax_params` then fills the port module from the
tree; `load_torch_checkpoint` does both steps. Conventions: torch Linear
weight [out, in] -> flax kernel [in, out]; Conv2d [out, in, kh, kw] ->
[kh, kw, in, out].
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
