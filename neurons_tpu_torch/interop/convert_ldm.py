"""LDM checkpoint -> diffusers-keyed state-dict converters, and the LoRA
merge.

Counterpart of neurons_tpu/interop/convert_ldm.py (the reference's
animatediff/utils/convert_from_ckpt.py:328,559,716 and
convert_lora_safetensor_to_diffusers.py:27-152): pure key remapping on
host arrays, the structure inferred by scanning the checkpoint (no config
needed). The outputs feed `torch_import.import_animatediff_unet3d` and
`import_diffusers_vae`, so DreamBooth bases and LoRA adapters reach the
port's modules through one diffusers-keyed waypoint, as the reference's
`load_weights` flow does (animatediff/utils/util.py:92-185).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from neurons_tpu_torch.interop.torch_import import t2j

_RES_MAP = (("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
            ("emb_layers.1", "time_emb_proj"), ("out_layers.0", "norm2"),
            ("out_layers.3", "conv2"), ("skip_connection", "conv_shortcut"))


def _remap_resnet(sd, src: str, dst: str, out: Dict):
    for a, b in _RES_MAP:
        for suffix in ("weight", "bias"):
            k = f"{src}.{a}.{suffix}"
            if k in sd:
                out[f"{dst}.{b}.{suffix}"] = sd[k]


def _remap_attn(sd, src: str, dst: str, out: Dict):
    # transformer_blocks.* share names between LDM and diffusers
    for k in list(sd):
        if k.startswith(f"{src}."):
            out[f"{dst}." + k[len(src) + 1:]] = sd[k]


def convert_ldm_unet_to_diffusers(sd: Dict) -> Dict:
    """`model.diffusion_model.*`-stripped LDM UNet keys -> diffusers
    UNet2DConditionModel keys (reference convert_ldm_unet_checkpoint,
    convert_from_ckpt.py:328-556)."""
    out: Dict = {}
    for suffix in ("weight", "bias"):
        out[f"conv_in.{suffix}"] = sd[f"input_blocks.0.0.{suffix}"]
        out[f"time_embedding.linear_1.{suffix}"] = sd[f"time_embed.0.{suffix}"]
        out[f"time_embedding.linear_2.{suffix}"] = sd[f"time_embed.2.{suffix}"]
        out[f"conv_norm_out.{suffix}"] = sd[f"out.0.{suffix}"]
        out[f"conv_out.{suffix}"] = sd[f"out.2.{suffix}"]

    n_input = 1 + max(int(m.group(1)) for k in sd
                      if (m := re.match(r"input_blocks\.(\d+)\.", k)))
    block = layer = 0
    for idx in range(1, n_input):
        if f"input_blocks.{idx}.0.op.weight" in sd:
            for s in ("weight", "bias"):
                out[f"down_blocks.{block}.downsamplers.0.conv.{s}"] = \
                    sd[f"input_blocks.{idx}.0.op.{s}"]
            block += 1
            layer = 0
            continue
        _remap_resnet(sd, f"input_blocks.{idx}.0",
                      f"down_blocks.{block}.resnets.{layer}", out)
        if f"input_blocks.{idx}.1.norm.weight" in sd:
            _remap_attn(sd, f"input_blocks.{idx}.1",
                        f"down_blocks.{block}.attentions.{layer}", out)
        layer += 1
    n_levels = block + 1

    _remap_resnet(sd, "middle_block.0", "mid_block.resnets.0", out)
    _remap_attn(sd, "middle_block.1", "mid_block.attentions.0", out)
    _remap_resnet(sd, "middle_block.2", "mid_block.resnets.1", out)

    n_output = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"output_blocks\.(\d+)\.", k)))
    per_level = n_output // n_levels  # num_res_blocks + 1
    for idx in range(n_output):
        blk, lyr = idx // per_level, idx % per_level
        _remap_resnet(sd, f"output_blocks.{idx}.0",
                      f"up_blocks.{blk}.resnets.{lyr}", out)
        if f"output_blocks.{idx}.1.norm.weight" in sd:
            _remap_attn(sd, f"output_blocks.{idx}.1",
                        f"up_blocks.{blk}.attentions.{lyr}", out)
        # the upsample conv lives at sub-index 1 (no attn) or 2 (attn)
        for sub in (1, 2):
            if f"output_blocks.{idx}.{sub}.conv.weight" in sd:
                for s in ("weight", "bias"):
                    out[f"up_blocks.{blk}.upsamplers.0.conv.{s}"] = \
                        sd[f"output_blocks.{idx}.{sub}.conv.{s}"]
    return out


def convert_ldm_vae_to_diffusers(sd: Dict) -> Dict:
    """LDM first-stage VAE keys -> diffusers AutoencoderKL keys
    (reference convert_ldm_vae_checkpoint, convert_from_ckpt.py:559-713);
    decoder.up reverses order, 1x1-conv attention projections squeeze to
    linears."""
    out: Dict = {}
    passthrough = {"quant_conv": "quant_conv",
                   "post_quant_conv": "post_quant_conv",
                   "encoder.conv_in": "encoder.conv_in",
                   "encoder.conv_out": "encoder.conv_out",
                   "encoder.norm_out": "encoder.conv_norm_out",
                   "decoder.conv_in": "decoder.conv_in",
                   "decoder.conv_out": "decoder.conv_out",
                   "decoder.norm_out": "decoder.conv_norm_out"}
    for a, b in passthrough.items():
        for s in ("weight", "bias"):
            out[f"{b}.{s}"] = sd[f"{a}.{s}"]

    n_down = 1 + max(int(m.group(1)) for k in sd
                     if (m := re.match(r"encoder\.down\.(\d+)\.", k)))

    def resnet(src, dst):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            for s in ("weight", "bias"):
                out[f"{dst}.{name}.{s}"] = sd[f"{src}.{name}.{s}"]
        if f"{src}.nin_shortcut.weight" in sd:
            for s in ("weight", "bias"):
                out[f"{dst}.conv_shortcut.{s}"] = sd[f"{src}.nin_shortcut.{s}"]

    def attn(src, dst):
        for s in ("weight", "bias"):
            out[f"{dst}.group_norm.{s}"] = sd[f"{src}.norm.{s}"]
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("proj_out", "to_out.0")):
            w = t2j(sd[f"{src}.{a}.weight"])
            out[f"{dst}.{b}.weight"] = (w.squeeze(-1).squeeze(-1)
                                        if w.ndim == 4 else w)
            out[f"{dst}.{b}.bias"] = sd[f"{src}.{a}.bias"]

    for i in range(n_down):
        j = 0
        while f"encoder.down.{i}.block.{j}.norm1.weight" in sd:
            resnet(f"encoder.down.{i}.block.{j}",
                   f"encoder.down_blocks.{i}.resnets.{j}")
            j += 1
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            for s in ("weight", "bias"):
                out[f"encoder.down_blocks.{i}.downsamplers.0.conv.{s}"] = \
                    sd[f"encoder.down.{i}.downsample.conv.{s}"]
        src = n_down - 1 - i  # decoder.up is reverse-indexed in LDM
        j = 0
        while f"decoder.up.{src}.block.{j}.norm1.weight" in sd:
            resnet(f"decoder.up.{src}.block.{j}",
                   f"decoder.up_blocks.{i}.resnets.{j}")
            j += 1
        if f"decoder.up.{src}.upsample.conv.weight" in sd:
            for s in ("weight", "bias"):
                out[f"decoder.up_blocks.{i}.upsamplers.0.conv.{s}"] = \
                    sd[f"decoder.up.{src}.upsample.conv.{s}"]
    for tower in ("encoder", "decoder"):
        resnet(f"{tower}.mid.block_1", f"{tower}.mid_block.resnets.0")
        attn(f"{tower}.mid.attn_1", f"{tower}.mid_block.attentions.0")
        resnet(f"{tower}.mid.block_2", f"{tower}.mid_block.resnets.1")
    return out


def merge_lora_into_state_dict(target_sd: Dict, lora_sd: Dict,
                               alpha: float = 0.8,
                               prefix: str = "lora_unet"
                               ) -> Tuple[Dict, List[str]]:
    """Merge `lora_unet_*`/`lora_te_*` safetensors pairs into a
    diffusers-keyed state dict: W += alpha * up @ down (reference
    convert_lora, convert_lora_safetensor_to_diffusers.py:50-120). LoRA
    names flatten module paths with underscores; we match them against
    the target keys with separators stripped (the reference navigates
    modules greedily — same resolution, different mechanics). Returns
    (merged dict, unmatched lora entries)."""
    norm_map = {}
    for k in target_sd:
        if k.endswith(".weight"):
            norm_map[k[:-len(".weight")].replace(".", "").replace("_", "")
                     ] = k
    out = dict(target_sd)
    missed = []
    for k in lora_sd:
        if not k.endswith(".lora_down.weight") or not k.startswith(prefix):
            continue
        stem = k[len(prefix) + 1: -len(".lora_down.weight")]
        tgt = norm_map.get(stem.replace("_", ""))
        if tgt is None:
            missed.append(k)
            continue
        down = t2j(lora_sd[k]).astype(np.float32)
        up = t2j(lora_sd[k.replace("lora_down", "lora_up")]
                 ).astype(np.float32)
        w = t2j(out[tgt]).astype(np.float32)
        if up.ndim == 4:
            delta = (up.squeeze(-1).squeeze(-1)
                     @ down.squeeze(-1).squeeze(-1))[:, :, None, None]
        else:
            delta = up @ down
        out[tgt] = w + alpha * delta
    return out, missed
