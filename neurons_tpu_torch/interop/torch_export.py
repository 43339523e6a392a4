"""The port's modules -> state dicts in the reference checkpoints' layouts.

The inverses of the importers in `torch_import.py`: each writer takes the
flax-layout tree an importer returns (`jax_tree(module)` gives it for a
port module) and gives back the state dict that importer reads, so a
module's weights can be written as the reference's released files are:

  ldm_unet_state_dict            <- import_ldm_unet (the unclip6 UNet)
  svd_state_dict                 <- load_svd: import_svd_unet,
                                    import_video_decoder and the VAE
                                    encoder's import (svd.safetensors)
  ldm_vae_state_dict             <- import_ldm_vae, and through
                                    convert_ldm_vae_to_diffusers
                                    import_diffusers_vae (the SD-1.5 VAE)
  hf_clip_text_state_dict        <- import_hf_clip_text
  open_clip_state_dict           <- import_open_clip_vision +
                                    import_open_clip_text (open_clip_bigG)
  ldm_unet3d_state_dict          <- convert_ldm_unet_to_diffusers +
                                    import_animatediff_unet3d (the SD-1.5
                                    base, motion modules left out)
  motion_module_state_dict       <- filter_motion_module +
                                    import_motion_modules (v3_sd15_mm)
  sparse_controlnet_state_dict   <- import_sparse_controlnet
  neurons_ensemble_state_dict    <- import_neurons_ensemble
                                    (brain_model_prior_last.pth)
  lora_state_dict                a LoRA pair for chosen diffusers keys
                                 (`convert_ldm.merge_lora_into_state_dict`)
  t5_encoder_state_dict          <- import_t5_encoder (HF T5EncoderModel)
  lpips_state_dict               <- import_lpips (`vgg_lpips`)
  nlayer_discriminator_state_dict <- import_nlayer_discriminator (with the
                                 BatchNorm running statistics)

`write_safetensors` writes the safetensors format that
`load_weights.read_safetensors` reads. Values are numpy arrays; a writer
that converts (`to_torch`) casts floating arrays to the dtype asked for.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, object]


def jax_tree(module: nn.Module) -> Dict:
    """A port module's parameters as the flax tree `load_jax_params` reads
    (numpy f32 on the host, one copy of each parameter; the kernels are
    transposed views of it): Linear weight -> kernel [in, out], Conv2d
    weight -> kernel HWIO, Conv3d weight -> kernel DHWIO, Embedding weight
    -> embedding, another module's weight -> its `flax_weight` name (the
    VQ codebook's `embedding`) or scale, every other parameter under its
    own name."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        arr = p.detach().to("cpu", torch.float32, copy=True).numpy()
        if leaf == "weight":
            if isinstance(owner, nn.Linear):
                leaf, arr = "kernel", arr.T
            elif isinstance(owner, nn.Conv2d):
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif isinstance(owner, nn.Conv3d):
                leaf, arr = "kernel", arr.transpose(2, 3, 4, 1, 0)
            elif isinstance(owner, nn.Embedding):
                leaf = "embedding"
            else:  # a norm's scale, or a leaf the module names itself
                leaf = getattr(owner, "flax_weight", "scale")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def jax_buffer_tree(module: nn.Module) -> Dict:
    """A port module's persistent buffers as flax's non-`params`
    collections read them (`from_jax.load_jax_buffers`'s inverse): the
    discriminator's BatchNorm `running_mean` / `running_var` as
    batch_stats `mean` / `var`, every other buffer (the EMA codebook's
    `weight`, `cluster_size`, `embed_avg`) under its own name; numpy f32."""
    from neurons_tpu_torch.interop.from_jax import BUFFER_NAMES
    leaf_of = {v: k for k, v in BUFFER_NAMES.items()}
    tree: Dict = {}
    for name, b in module.named_buffers():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        if leaf in owner._non_persistent_buffers_set:
            continue
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf_of.get(leaf, leaf)] = b.detach().to(
            "cpu", torch.float32, copy=True).numpy()
    return tree


# ------------------------------------------------------------ primitives ----

def _lin(sd: Dict, key: str, node: Tree, as_1x1: bool = False) -> None:
    w = np.asarray(node["kernel"]).T
    sd[f"{key}.weight"] = w[:, :, None, None] if as_1x1 else w
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _conv(sd: Dict, key: str, node: Tree) -> None:
    sd[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _norm(sd: Dict, key: str, node: Tree) -> None:
    sd[f"{key}.weight"] = np.asarray(node["scale"])
    sd[f"{key}.bias"] = np.asarray(node["bias"])


def to_torch(sd: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.Tensor]:
    """numpy state dict -> contiguous torch tensors, floats in `dtype`."""
    out = {}
    for k, v in sd.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


# ------------------------------------------------------- LDM UNet (unCLIP) ----

def _ldm_resblock(sd, p: str, node: Tree) -> None:
    _norm(sd, f"{p}.in_layers.0", node["in_norm"])
    _conv(sd, f"{p}.in_layers.2", node["in_conv"])
    _lin(sd, f"{p}.emb_layers.1", node["emb_proj"])
    _norm(sd, f"{p}.out_layers.0", node["out_norm"])
    _conv(sd, f"{p}.out_layers.3", node["out_conv"])
    if "skip_conv" in node:
        _conv(sd, f"{p}.skip_connection", node["skip_conv"])


def _attn_block(sd, p: str, node: Tree) -> None:
    for k in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{p}.{k}", node[k])
    _lin(sd, f"{p}.to_out.0", node["to_out"])


def _ldm_transformer(sd, p: str, node: Tree, depth: int,
                     as_1x1: bool) -> None:
    _norm(sd, f"{p}.norm", node["norm"])
    _lin(sd, f"{p}.proj_in", node["proj_in"], as_1x1)
    _lin(sd, f"{p}.proj_out", node["proj_out"], as_1x1)
    for d in range(depth):
        q, blk = f"{p}.transformer_blocks.{d}", node[f"block_{d}"]
        _norm(sd, f"{q}.norm1", blk["norm1"])
        _attn_block(sd, f"{q}.attn1", blk["attn1"])
        _norm(sd, f"{q}.norm2", blk["norm2"])
        _attn_block(sd, f"{q}.attn2", blk["attn2"])
        _norm(sd, f"{q}.norm3", blk["norm3"])
        _lin(sd, f"{q}.ff.net.0.proj", blk["ff"]["proj_in"])
        _lin(sd, f"{q}.ff.net.2", blk["ff"]["proj_out"])


def _unet_blocks(sd, tree: Tree, cfg, resblock, transformer) -> None:
    """The LDM UNet's key walk (input_blocks / middle_block /
    output_blocks), shared by the unCLIP and the SVD UNets:
    `resblock(sd, key, node)` and `transformer(sd, key, node, depth)`
    write one block."""
    _lin(sd, "time_embed.0", tree["time_embed_0"])
    _lin(sd, "time_embed.2", tree["time_embed_2"])
    if "label_emb_0" in tree:
        _lin(sd, "label_emb.0.0", tree["label_emb_0"])
        _lin(sd, "label_emb.0.2", tree["label_emb_2"])
    _conv(sd, "input_blocks.0.0", tree["conv_in"])
    _norm(sd, "out.0", tree["out_norm"])
    _conv(sd, "out.2", tree["out_conv"])
    resblock(sd, "middle_block.0", tree["mid_res_0"])
    transformer(sd, "middle_block.1", tree["mid_attn"],
                cfg.transformer_depth[-1])
    resblock(sd, "middle_block.2", tree["mid_res_1"])
    levels, nres = len(cfg.channel_mult), cfg.num_res_blocks
    idx, ds = 1, 1
    for level in range(levels):
        for i in range(nres):
            resblock(sd, f"input_blocks.{idx}.0",
                     tree[f"down_{level}_res_{i}"])
            if ds in cfg.attention_resolutions:
                transformer(sd, f"input_blocks.{idx}.1",
                            tree[f"down_{level}_attn_{i}"],
                            cfg.transformer_depth[level])
            idx += 1
        if level != levels - 1:
            _conv(sd, f"input_blocks.{idx}.0.op",
                  tree[f"down_{level}_downsample"]["op"])
            idx += 1
            ds *= 2
    idx = 0
    for level in reversed(range(levels)):
        for i in range(nres + 1):
            resblock(sd, f"output_blocks.{idx}.0",
                     tree[f"up_{level}_res_{i}"])
            sub = 1
            if ds in cfg.attention_resolutions:
                transformer(sd, f"output_blocks.{idx}.1",
                            tree[f"up_{level}_attn_{i}"],
                            cfg.transformer_depth[level])
                sub = 2
            if level and i == nres:
                _conv(sd, f"output_blocks.{idx}.{sub}.conv",
                      tree[f"up_{level}_upsample"]["conv"])
                ds //= 2
            idx += 1


def ldm_unet_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """UNetModel tree -> the LDM/sgm `model.diffusion_model` keys
    (unprefixed): input_blocks / middle_block / output_blocks."""
    sd: Dict[str, np.ndarray] = {}
    lin_io = not getattr(cfg, "use_linear_in_transformer", True)
    _unet_blocks(sd, tree, cfg, _ldm_resblock,
                 lambda sd, p, node, depth: _ldm_transformer(
                     sd, p, node, depth, lin_io))
    return sd


def ema_state_dict(sd: Mapping[str, np.ndarray],
                   prefix: str = "model.") -> Dict[str, np.ndarray]:
    """LitEma's shadow keys of a Lightning module's `model.*` entries:
    'model_ema.' + the name without its prefix and dots (what
    `ldm_apply_ema` swaps back in), and its two counters."""
    out = {"model_ema." + k[len(prefix):].replace(".", ""): v
           for k, v in sd.items() if k.startswith(prefix)}
    out["model_ema.num_updates"] = np.asarray(110000, np.int64)
    out["model_ema.decay"] = np.asarray(0.9999, np.float32)
    return out


# ---------------------------------------------------------------- LDM VAE ----

def _vae_resnet(sd, p: str, node: Tree) -> None:
    for k in ("norm1", "norm2"):
        _norm(sd, f"{p}.{k}", node[k])
    for k in ("conv1", "conv2"):
        _conv(sd, f"{p}.{k}", node[k])
    if "nin_shortcut" in node:
        _conv(sd, f"{p}.nin_shortcut", node["nin_shortcut"])


def _vae_attn(sd, p: str, node: Tree) -> None:
    _norm(sd, f"{p}.norm", node["norm"])
    for k in ("q", "k", "v", "proj_out"):
        _lin(sd, f"{p}.{k}", node[k], as_1x1=True)


def ldm_vae_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """AutoencoderKL tree -> the LDM first-stage keys (unprefixed):
    down.{i}.block.{j}, mid.block_1 / attn_1 / block_2, decoder.up indexed
    in reverse, 1x1-conv attention projections."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "quant_conv", tree["quant_conv"])
    _conv(sd, "post_quant_conv", tree["post_quant_conv"])
    for tower in ("encoder", "decoder"):
        t = tree[tower]
        _conv(sd, f"{tower}.conv_in", t["conv_in"])
        _norm(sd, f"{tower}.norm_out", t["norm_out"])
        _conv(sd, f"{tower}.conv_out", t["conv_out"])
        _vae_resnet(sd, f"{tower}.mid.block_1", t["mid_block_1"])
        _vae_attn(sd, f"{tower}.mid.attn_1", t["mid_attn"])
        _vae_resnet(sd, f"{tower}.mid.block_2", t["mid_block_2"])
    nres = len(cfg.block_out_channels)
    enc, dec = tree["encoder"], tree["decoder"]
    for i in range(nres):
        for j in range(cfg.layers_per_block):
            _vae_resnet(sd, f"encoder.down.{i}.block.{j}",
                        enc[f"down_{i}_block_{j}"])
        if f"down_{i}_downsample" in enc:
            _conv(sd, f"encoder.down.{i}.downsample.conv",
                  enc[f"down_{i}_downsample"]["conv"])
        src = nres - 1 - i
        for j in range(cfg.layers_per_block + 1):
            _vae_resnet(sd, f"decoder.up.{src}.block.{j}",
                        dec[f"up_{i}_block_{j}"])
        if f"up_{i}_upsample" in dec:
            _conv(sd, f"decoder.up.{src}.upsample.conv",
                  dec[f"up_{i}_upsample"]["conv"])
    return sd


# ------------------------------------------------------------------- SVD ----

def _conv3(sd: Dict, key: str, node: Tree) -> None:
    sd[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(4, 3, 0, 1, 2)
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _ldm_resblock3d(sd, p: str, node: Tree) -> None:
    _norm(sd, f"{p}.in_layers.0", node["in_norm"])
    _conv3(sd, f"{p}.in_layers.2", node["in_conv"])
    if "emb_proj" in node:
        _lin(sd, f"{p}.emb_layers.1", node["emb_proj"])
    _norm(sd, f"{p}.out_layers.0", node["out_norm"])
    _conv3(sd, f"{p}.out_layers.3", node["out_conv"])
    if "skip_conv" in node:
        _conv3(sd, f"{p}.skip_connection", node["skip_conv"])


def _mix_factor(sd, p: str, node: Tree) -> None:
    sd[f"{p}.mix_factor"] = np.asarray(node["mix_factor"])


def _video_resblock(sd, p: str, node: Tree) -> None:
    _ldm_resblock(sd, p, node["spatial"])
    _ldm_resblock3d(sd, f"{p}.time_stack", node["time_stack"])
    _mix_factor(sd, f"{p}.time_mixer", node["time_mixer"])


def _video_tblock(sd, q: str, node: Tree) -> None:
    _norm(sd, f"{q}.norm1", node["norm1"])
    _attn_block(sd, f"{q}.attn1", node["attn1"])
    _norm(sd, f"{q}.norm3", node["norm3"])
    _lin(sd, f"{q}.ff.net.0.proj", node["ff"]["proj_in"])
    _lin(sd, f"{q}.ff.net.2", node["ff"]["proj_out"])
    if "ff_in" in node:
        _norm(sd, f"{q}.norm_in", node["norm_in"])
        _lin(sd, f"{q}.ff_in.net.0.proj", node["ff_in"]["proj_in"])
        _lin(sd, f"{q}.ff_in.net.2", node["ff_in"]["proj_out"])
    if "attn2" in node:
        _norm(sd, f"{q}.norm2", node["norm2"])
        _attn_block(sd, f"{q}.attn2", node["attn2"])


def _video_transformer(sd, p: str, node: Tree, depth: int) -> None:
    _ldm_transformer(sd, p, node, depth, as_1x1=False)
    for d in range(depth):
        _video_tblock(sd, f"{p}.time_stack.{d}", node[f"time_stack_{d}"])
    _lin(sd, f"{p}.time_pos_embed.0", node["time_pos_embed_0"])
    _lin(sd, f"{p}.time_pos_embed.2", node["time_pos_embed_2"])
    _mix_factor(sd, f"{p}.time_mixer", node["time_mixer"])


def svd_unet_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """VideoUNet tree -> the sgm `model.diffusion_model` keys of an SVD
    checkpoint (unprefixed)."""
    sd: Dict[str, np.ndarray] = {}
    _unet_blocks(sd, tree, cfg, _video_resblock, _video_transformer)
    return sd


def video_decoder_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """VideoDecoder tree -> the sgm temporal decoder's keys (unprefixed;
    `first_stage_model.decoder.` in an SVD checkpoint): a block's resnet
    at its root, its temporal stack under `.time_stack` and its
    `mix_factor` on the block; conv_out's time-mix conv under
    `conv_out.time_mix_conv`; up indexed in reverse."""
    sd: Dict[str, np.ndarray] = {}

    def block(key, node):
        if "spatial" not in node:  # time_mode 'attn-only'
            _vae_resnet(sd, key, node)
            return
        _vae_resnet(sd, key, node["spatial"])
        _ldm_resblock3d(sd, f"{key}.time_stack", node["time_stack"])
        _mix_factor(sd, key, node["time_mixer"])

    _conv(sd, "conv_in", tree["conv_in"])
    _norm(sd, "norm_out", tree["norm_out"])
    block("mid.block_1", tree["mid_block_1"])
    attn = tree["mid_attn"]
    _vae_attn(sd, "mid.attn_1", attn)
    if "time_mix_block" in attn:
        _video_tblock(sd, "mid.attn_1.time_mix_block", attn["time_mix_block"])
        _lin(sd, "mid.attn_1.video_time_embed.0", attn["video_time_embed_0"])
        _lin(sd, "mid.attn_1.video_time_embed.2", attn["video_time_embed_2"])
        _mix_factor(sd, "mid.attn_1", attn["time_mixer"])
    block("mid.block_2", tree["mid_block_2"])
    if "time_mix_conv" in tree["conv_out"]:
        _conv(sd, "conv_out", tree["conv_out"]["conv"])
        _conv3(sd, "conv_out.time_mix_conv", tree["conv_out"]["time_mix_conv"])
    else:
        _conv(sd, "conv_out", tree["conv_out"])
    nres = len(cfg.vae.block_out_channels)
    for i in range(nres):
        src = nres - 1 - i
        for j in range(cfg.vae.layers_per_block + 1):
            block(f"up.{src}.block.{j}", tree[f"up_{i}_block_{j}"])
        if f"up_{i}_upsample" in tree:
            _conv(sd, f"up.{src}.upsample.conv",
                  tree[f"up_{i}_upsample"]["conv"])
    return sd


def vae_encoder_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """vae.Encoder tree -> the sgm encoder's keys (unprefixed; the
    `encoder.` half of `ldm_vae_state_dict`)."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "conv_in", tree["conv_in"])
    _norm(sd, "norm_out", tree["norm_out"])
    _conv(sd, "conv_out", tree["conv_out"])
    _vae_resnet(sd, "mid.block_1", tree["mid_block_1"])
    _vae_attn(sd, "mid.attn_1", tree["mid_attn"])
    _vae_resnet(sd, "mid.block_2", tree["mid_block_2"])
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            _vae_resnet(sd, f"down.{i}.block.{j}", tree[f"down_{i}_block_{j}"])
        if f"down_{i}_downsample" in tree:
            _conv(sd, f"down.{i}.downsample.conv",
                  tree[f"down_{i}_downsample"]["conv"])
    return sd


def svd_state_dict(unet: Tree, unet_cfg, decoder: Tree, dec_cfg,
                   encoder: Tree) -> Dict[str, np.ndarray]:
    """The three trees -> one SVD checkpoint's keys in the sgm layout:
    `model.diffusion_model.` (the VideoUNet), `first_stage_model.decoder.`
    (the temporal decoder) and `first_stage_model.encoder.` (the encoder
    of dec_cfg.vae)."""
    sd = {f"model.diffusion_model.{k}": v
          for k, v in svd_unet_state_dict(unet, unet_cfg).items()}
    sd.update({f"first_stage_model.decoder.{k}": v
               for k, v in video_decoder_state_dict(decoder, dec_cfg).items()})
    sd.update({f"first_stage_model.encoder.{k}": v
               for k, v in vae_encoder_state_dict(encoder,
                                                  dec_cfg.vae).items()})
    return sd


# -------------------------------------------------------- HF CLIP text -------

def hf_clip_text_state_dict(tree: Tree, layers: int,
                            prefix: str = "text_model."
                            ) -> Dict[str, np.ndarray]:
    """CLIPTextTower tree -> HF CLIPTextModel keys (SD-1.5's text encoder
    has no text_projection; one is written only if the tree has it)."""
    sd: Dict[str, np.ndarray] = {}
    p = prefix
    sd[f"{p}embeddings.token_embedding.weight"] = np.asarray(
        tree["token_embedding"])
    sd[f"{p}embeddings.position_embedding.weight"] = np.asarray(
        tree["positional_embedding"])
    _norm(sd, f"{p}final_layer_norm", tree["ln_final"])
    if "text_projection" in tree:
        sd["text_projection.weight"] = np.asarray(tree["text_projection"]).T
    for i in range(layers):
        q, blk = f"{p}encoder.layers.{i}", tree[f"resblock_{i}"]
        w = np.asarray(blk["in_proj"]["kernel"]).T
        b = np.asarray(blk["in_proj"]["bias"])
        for j, k in enumerate(("q_proj", "k_proj", "v_proj")):
            d = w.shape[0] // 3
            sd[f"{q}.self_attn.{k}.weight"] = w[j * d:(j + 1) * d]
            sd[f"{q}.self_attn.{k}.bias"] = b[j * d:(j + 1) * d]
        _lin(sd, f"{q}.self_attn.out_proj", blk["out_proj"])
        _norm(sd, f"{q}.layer_norm1", blk["ln_1"])
        _norm(sd, f"{q}.layer_norm2", blk["ln_2"])
        _lin(sd, f"{q}.mlp.fc1", blk["mlp_fc"])
        _lin(sd, f"{q}.mlp.fc2", blk["mlp_proj"])
    return sd


# ------------------------------------------------- open_clip bigG towers ----

def _open_clip_block(sd, p: str, blk: Tree) -> None:
    _norm(sd, f"{p}.ln_1", blk["ln_1"])
    sd[f"{p}.attn.in_proj_weight"] = np.asarray(blk["in_proj"]["kernel"]).T
    sd[f"{p}.attn.in_proj_bias"] = np.asarray(blk["in_proj"]["bias"])
    _lin(sd, f"{p}.attn.out_proj", blk["out_proj"])
    _norm(sd, f"{p}.ln_2", blk["ln_2"])
    _lin(sd, f"{p}.mlp.c_fc", blk["mlp_fc"])
    _lin(sd, f"{p}.mlp.c_proj", blk["mlp_proj"])


def open_clip_state_dict(vision: Tree, vision_layers: int, text: Tree,
                         text_layers: int) -> Dict[str, np.ndarray]:
    """CLIPVisionTower and CLIPTextTower trees -> one open_clip model's
    keys (`visual.*` for the vision tower, the text tower's at the top)."""
    sd: Dict[str, np.ndarray] = {
        "visual.conv1.weight": np.asarray(
            vision["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "visual.class_embedding": np.asarray(vision["class_embedding"]),
        "visual.positional_embedding": np.asarray(
            vision["positional_embedding"]),
        "visual.proj": np.asarray(vision["proj"]),
        "token_embedding.weight": np.asarray(text["token_embedding"]),
        "positional_embedding": np.asarray(text["positional_embedding"]),
        "text_projection": np.asarray(text["text_projection"]),
    }
    _norm(sd, "visual.ln_pre", vision["ln_pre"])
    _norm(sd, "visual.ln_post", vision["ln_post"])
    _norm(sd, "ln_final", text["ln_final"])
    for i in range(vision_layers):
        _open_clip_block(sd, f"visual.transformer.resblocks.{i}",
                         vision[f"resblock_{i}"])
    for i in range(text_layers):
        _open_clip_block(sd, f"transformer.resblocks.{i}",
                         text[f"resblock_{i}"])
    return sd


# ------------------------------------- SD-1.5 UNet (LDM keys) and motion ----

_LDM_RES = (("norm1", "in_layers.0", _norm), ("conv1", "in_layers.2", _conv),
            ("time_emb_proj", "emb_layers.1", _lin),
            ("norm2", "out_layers.0", _norm), ("conv2", "out_layers.3", _conv),
            ("conv_shortcut", "skip_connection", _conv))


def _ldm_from_diffusers_resnet(sd, p: str, node: Tree) -> None:
    for ours, ldm, put in _LDM_RES:
        if ours in node:
            put(sd, f"{p}.{ldm}", node[ours])


def _diffusers_transformer(sd, p: str, node: Tree) -> None:
    """Transformer3D (flat block_0_* names) -> diffusers Transformer2DModel
    keys with SD-1.5's 1x1-conv proj_in/out (the same under LDM names)."""
    q = f"{p}.transformer_blocks.0"
    _norm(sd, f"{p}.norm", node["norm"])
    _lin(sd, f"{p}.proj_in", node["proj_in"], as_1x1=True)
    _lin(sd, f"{p}.proj_out", node["proj_out"], as_1x1=True)
    for k in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{q}.{k}", node[f"block_0_{k}"])
    _attn_block(sd, f"{q}.attn1", node["block_0_attn1"])
    _attn_block(sd, f"{q}.attn2", node["block_0_attn2"])
    _lin(sd, f"{q}.ff.net.0.proj", node["block_0_ff"]["proj_in"])
    _lin(sd, f"{q}.ff.net.2", node["block_0_ff"]["proj_out"])


def ldm_unet3d_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """The spatial part of a UNet3DModel tree -> an SD-1.5 LDM UNet
    (unprefixed input_blocks / middle_block / output_blocks keys), the
    layout `convert_ldm_unet_to_diffusers` converts back; the motion
    modules are not in it."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "input_blocks.0.0", tree["conv_in"])
    _lin(sd, "time_embed.0", tree["time_emb_1"])
    _lin(sd, "time_embed.2", tree["time_emb_2"])
    _norm(sd, "out.0", tree["conv_norm_out"])
    _conv(sd, "out.2", tree["conv_out"])
    _ldm_from_diffusers_resnet(sd, "middle_block.0", tree["mid_res_0"])
    _diffusers_transformer(sd, "middle_block.1", tree["mid_attn"])
    _ldm_from_diffusers_resnet(sd, "middle_block.2", tree["mid_res_1"])
    idx = 1
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            _ldm_from_diffusers_resnet(sd, f"input_blocks.{idx}.0",
                                       tree[f"down_{i}_res_{j}"])
            if btype.startswith("CrossAttn"):
                _diffusers_transformer(sd, f"input_blocks.{idx}.1",
                                       tree[f"down_{i}_attn_{j}"])
            idx += 1
        if f"down_{i}_downsample" in tree:
            _conv(sd, f"input_blocks.{idx}.0.op", tree[f"down_{i}_downsample"])
            idx += 1
    per_level = cfg.layers_per_block + 1
    for i, btype in enumerate(cfg.up_block_types):
        for j in range(per_level):
            idx = i * per_level + j
            _ldm_from_diffusers_resnet(sd, f"output_blocks.{idx}.0",
                                       tree[f"up_{i}_res_{j}"])
            sub = 1
            if btype.startswith("CrossAttn"):
                _diffusers_transformer(sd, f"output_blocks.{idx}.1",
                                       tree[f"up_{i}_attn_{j}"])
                sub = 2
            if j == per_level - 1 and f"up_{i}_upsample" in tree:
                _conv(sd, f"output_blocks.{idx}.{sub}.conv",
                      tree[f"up_{i}_upsample"])
    return sd


def _motion_module(sd, p: str, node: Tree, num_blocks: int, num_attn: int,
                   pe_len: int = 0) -> None:
    t = f"{p}.temporal_transformer"
    _norm(sd, f"{t}.norm", node["norm"])
    _lin(sd, f"{t}.proj_in", node["proj_in"])
    _lin(sd, f"{t}.proj_out", node["proj_out"])
    for b in range(num_blocks):
        q = f"{t}.transformer_blocks.{b}"
        for a in range(num_attn):
            _norm(sd, f"{q}.norms.{a}", node[f"block_{b}_attn_{a}_norm"])
            _attn_block(sd, f"{q}.attention_blocks.{a}",
                        node[f"block_{b}_attn_{a}"])
            if pe_len:  # the positional buffer the loader drops
                c = np.asarray(node["proj_in"]["kernel"]).shape[0]
                sd[f"{q}.attention_blocks.{a}.pos_encoder.pe"] = np.zeros(
                    (1, pe_len, c), np.float32)
        _norm(sd, f"{q}.ff_norm", node[f"block_{b}_ff_norm"])
        _lin(sd, f"{q}.ff.net.0.proj", node[f"block_{b}_ff"]["proj_in"])
        _lin(sd, f"{q}.ff.net.2", node[f"block_{b}_ff"]["proj_out"])


def motion_module_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """The motion modules of a UNet3DModel tree -> an AnimateDiff motion
    module checkpoint (diffusers block names, with the `pos_encoder.pe`
    buffers the loader drops)."""
    sd: Dict[str, np.ndarray] = {}
    nb = cfg.motion_num_transformer_block
    na = len(cfg.motion_attention_block_types)
    pe = cfg.motion_max_seq_length
    for name, node in tree.items():
        parts = name.split("_")
        if "motion" not in parts:
            continue
        if parts[0] == "mid":
            key = "mid_block.motion_modules.0"
        else:
            key = f"{parts[0]}_blocks.{parts[1]}.motion_modules.{parts[3]}"
        _motion_module(sd, key, node, nb, na, pe)
    return sd


def lora_state_dict(target_keys: Iterable[str], shapes: Mapping[str, tuple],
                    rank: int, seed: int, scale: float = 0.01
                    ) -> Dict[str, np.ndarray]:
    """Seeded LoRA pairs for the diffusers weight keys `target_keys`
    (`shapes` their [out, in] shapes): 'lora_unet_' + the key's module path
    with dots as underscores, `.lora_down.weight` [rank, in] and
    `.lora_up.weight` [out, rank]."""
    g = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for k in target_keys:
        out_f, in_f = shapes[k][:2]
        stem = "lora_unet_" + k[:-len(".weight")].replace(".", "_")
        sd[f"{stem}.lora_down.weight"] = (
            scale * g.standard_normal((rank, in_f))).astype(np.float32)
        sd[f"{stem}.lora_up.weight"] = (
            scale * g.standard_normal((out_f, rank))).astype(np.float32)
    return sd


# --------------------------------------------------------------- SparseCtrl ----

def _diffusers_resnet(sd, p: str, node: Tree) -> None:
    for k, put in (("norm1", _norm), ("conv1", _conv),
                   ("time_emb_proj", _lin), ("norm2", _norm),
                   ("conv2", _conv), ("conv_shortcut", _conv)):
        if k in node:
            put(sd, f"{p}.{k}", node[k])


def sparse_controlnet_state_dict(tree: Tree, cfg, motion_attention_blocks:
                                 int = 1) -> Dict[str, np.ndarray]:
    """SparseControlNetModel tree -> the AnimateDiff SparseCtrl keys."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "conv_in", tree["conv_in"])
    _lin(sd, "time_embedding.linear_1", tree["time_emb_1"])
    _lin(sd, "time_embedding.linear_2", tree["time_emb_2"])
    _diffusers_resnet(sd, "mid_block.resnets.0", tree["mid_res_0"])
    _diffusers_transformer(sd, "mid_block.attentions.0", tree["mid_attn"])
    _diffusers_resnet(sd, "mid_block.resnets.1", tree["mid_res_1"])
    _conv(sd, "controlnet_mid_block", tree["controlnet_mid"])
    if "cond_embedding" in tree:
        _conv(sd, "controlnet_cond_embedding", tree["cond_embedding"])
    else:
        _conv(sd, "controlnet_cond_embedding.conv_in", tree["cond_in"])
        _conv(sd, "controlnet_cond_embedding.conv_out", tree["cond_out"])
        i = 0
        while f"cond_b{i}a" in tree:
            _conv(sd, f"controlnet_cond_embedding.blocks.{2 * i}",
                  tree[f"cond_b{i}a"])
            _conv(sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}",
                  tree[f"cond_b{i}b"])
            i += 1
    k = 0
    while f"controlnet_down_{k}" in tree:
        _conv(sd, f"controlnet_down_blocks.{k}", tree[f"controlnet_down_{k}"])
        k += 1
    nb = cfg.motion_num_transformer_block
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            _diffusers_resnet(sd, f"down_blocks.{i}.resnets.{j}",
                              tree[f"down_{i}_res_{j}"])
            if btype.startswith("CrossAttn"):
                _diffusers_transformer(sd, f"down_blocks.{i}.attentions.{j}",
                                       tree[f"down_{i}_attn_{j}"])
            if f"down_{i}_motion_{j}" in tree:
                _motion_module(sd, f"down_blocks.{i}.motion_modules.{j}",
                               tree[f"down_{i}_motion_{j}"], nb,
                               motion_attention_blocks)
        if f"down_{i}_downsample" in tree:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv",
                  tree[f"down_{i}_downsample"])
    return sd


# ------------------------------------------------- the NEURONS ensemble ----

def _mixer_backbone(sd, node: Tree, n_blocks: int) -> None:
    _lin(sd, "backbone.backbone_linear", node["backbone_linear"])
    cp = node["clip_proj"]
    for i, (kind, key) in enumerate((("LayerNorm_0", "0"), ("Dense_0", "2"),
                                     ("LayerNorm_1", "3"), ("Dense_1", "5"),
                                     ("LayerNorm_2", "6"), ("Dense_2", "8"))):
        put = _norm if kind.startswith("LayerNorm") else _lin
        put(sd, f"backbone.clip_proj.{key}", cp[kind])
    for i in range(n_blocks):
        for blk, ours in (("mixer_blocks1", "mix1"), ("mixer_blocks2",
                                                      "mix2")):
            _norm(sd, f"backbone.{blk}.{i}.0", node[f"{ours}_ln_{i}"])
            mlp = node[f"{ours}_mlp_{i}"]
            _lin(sd, f"backbone.{blk}.{i}.1.0", mlp["Dense_0"])
            _lin(sd, f"backbone.{blk}.{i}.1.3", mlp["Dense_1"])


def _neurons_core(sd, node: Tree, n_blocks: int) -> None:
    _mixer_backbone(sd, node["backbone"], n_blocks)
    i = 0
    while f"subj{i}" in node["ridge"]:
        _lin(sd, f"ridge.linears.{i}", node["ridge"][f"subj{i}"])
        i += 1
    sd["clipproj.proj"] = np.asarray(node["clipproj"]["proj"])


def neurons_core_state_dict(tree: Tree, n_blocks: int
                            ) -> Dict[str, np.ndarray]:
    """NeuronsCore tree -> the stage-1 `brain_model.pth` keys."""
    sd: Dict[str, np.ndarray] = {}
    _neurons_core(sd, tree, n_blocks)
    return sd


def _gain(sd, key: str, node: Tree) -> None:
    sd[f"{key}.g"] = np.asarray(node["g"])


def _dalle2_prior_net(sd, node: Tree, depth: int,
                      prefix: str = "diffusion_prior.net.") -> None:
    ct = prefix + "causal_transformer."
    tr = node["transformer"]
    sd[ct + "rel_pos_bias.relative_attention_bias.weight"] = np.asarray(
        tr["rel_pos_bias"]["rel_bias"])
    _gain(sd, ct + "norm", tr["norm_out"])
    _lin(sd, ct + "project_out", tr["project_out"])
    for i in range(depth):
        a, at = ct + f"layers.{i}.0", tr[f"attn_{i}"]
        _gain(sd, f"{a}.norm", at["norm"])
        sd[f"{a}.null_kv"] = np.asarray(at["null_kv"])
        _lin(sd, f"{a}.to_q", at["to_q"])
        _lin(sd, f"{a}.to_kv", at["to_kv"])
        sd[f"{a}.to_out.0.weight"] = np.asarray(at["to_out"]["kernel"]).T
        _gain(sd, f"{a}.to_out.1", at["out_norm"])
        f, ff = ct + f"layers.{i}.1", tr[f"ff_{i}"]
        _gain(sd, f"{f}.0", ff["norm"])
        _lin(sd, f"{f}.1", ff["proj_in"])
        _lin(sd, f"{f}.5", ff["proj_out"])
    for k in ("null_brain_embeds", "null_image_embed", "learned_query"):
        sd[prefix + k] = np.asarray(node[k])
    tm = node["time_mlp"]
    _lin(sd, prefix + "to_time_embeds.0.1.net.0.0", tm["Dense_0"])
    _lin(sd, prefix + "to_time_embeds.0.1.net.1.0", tm["Dense_1"])
    _lin(sd, prefix + "to_time_embeds.0.1.net.2", tm["Dense_2"])


def _decoder_video(sd, prefix: str, node: Tree, n_up: int,
                   layers_per_block: int) -> None:
    def resnet(key, r):
        for k in ("norm1", "norm2"):
            _norm(sd, f"{key}.{k}", r[k])
        for k in ("conv1", "conv2", "conv_shortcut"):
            if k in r:
                _conv(sd, f"{key}.{k}", r[k])

    def attn(key, a):
        _norm(sd, f"{key}.group_norm", a["group_norm"])
        for k in ("to_q", "to_k", "to_v"):
            _lin(sd, f"{key}.{k}", a[k])
        _lin(sd, f"{key}.to_out.0", a["to_out"])

    def st_attn(where, j, st):
        attn(f"{where}.attentions.{j}", st["attn"])
        attn(f"{where}.temp_attentions.{j}", st["temp_attn"])
        sd[f"{where}.weights.{j}"] = np.asarray(st["blend_weight"])

    _conv(sd, f"{prefix}.conv_in", node["conv_in"])
    _norm(sd, f"{prefix}.conv_norm_out", node["conv_norm_out"])
    mid = node["mid_block"]
    resnet(f"{prefix}.mid_block.resnets.0", mid["resnet_0"])
    st_attn(f"{prefix}.mid_block", 0, mid["st_attn_0"])
    resnet(f"{prefix}.mid_block.resnets.1", mid["resnet_1"])
    for i in range(n_up):
        blk = node[f"up_block_{i}"]
        where = f"{prefix}.up_blocks.{i}"
        for j in range(layers_per_block + 1):
            resnet(f"{where}.resnets.{j}", blk[f"resnet_{j}"])
            st_attn(where, j, blk[f"st_attn_{j}"])
        if "upsample" in blk:
            _conv(sd, f"{where}.upsamplers.0.conv", blk["upsample"]["conv"])


def _gpt2(sd, node: Tree, n_layer: int, prefix: str) -> None:
    sd[prefix + "transformer.wte.weight"] = np.asarray(node["wte"])
    sd[prefix + "lm_head.weight"] = np.asarray(node["wte"])  # tied, dropped
    lm = node["lm"]
    sd[prefix + "transformer.wpe.weight"] = np.asarray(lm["wpe"])
    _norm(sd, prefix + "transformer.ln_f", lm["ln_f"])
    for i in range(n_layer):
        p, h = f"{prefix}transformer.h.{i}", lm[f"h_{i}"]
        _norm(sd, f"{p}.ln_1", h["ln_1"])
        _norm(sd, f"{p}.ln_2", h["ln_2"])
        # GPT-2's Conv1D stores [in, out], the flax kernel's layout
        for ours, theirs in (("c_attn", "attn.c_attn"),
                             ("c_proj", "attn.c_proj"),
                             ("mlp_fc", "mlp.c_fc"),
                             ("mlp_proj", "mlp.c_proj")):
            sd[f"{p}.{theirs}.weight"] = np.asarray(h[ours]["kernel"])
            sd[f"{p}.{theirs}.bias"] = np.asarray(h[ours]["bias"])
        sd[f"{p}.attn.bias"] = np.ones((1, 1, 4, 4), np.float32)  # dropped


def neurons_ensemble_state_dict(tree: Tree, n_blocks: int, prior_depth: int,
                                gpt2_layers: int,
                                decoder_up_blocks: int = 3,
                                decoder_layers_per_block: int = 1
                                ) -> Dict[str, np.ndarray]:
    """NeuronsDecoupler tree -> the reference's `brain_model_prior_last.pth`
    model_state_dict (the Neurons container), with the prior's scheduler
    buffers the importer recomputes."""
    sd: Dict[str, np.ndarray] = {}
    _neurons_core(sd, tree["core"], n_blocks)
    _dalle2_prior_net(sd, tree["prior_net"], prior_depth)
    sd["diffusion_prior.noise_scheduler.betas"] = np.linspace(
        1e-4, 2e-2, 100, dtype=np.float32)
    _lin(sd, "motion_proj.motion_proj", tree["motion_proj"]["motion_proj"])
    cl = tree["classifier"]
    _lin(sd, "classifier.vision_proj_channel", cl["vision_proj_channel"])
    _lin(sd, "classifier.classifier", cl["classifier"])
    t = tree["text_seg_dec"]
    for k in ("q", "k", "v", "out"):
        _lin(sd, f"text_seg_dec.{k}", t[k])
    _norm(sd, "text_seg_dec.norm", t["norm"])
    for ours, idx, put in (("maps_0", 0, _conv), ("maps_gn_0", 1, _norm),
                           ("maps_1", 3, _conv), ("maps_gn_1", 4, _norm),
                           ("maps_2", 6, _conv)):
        put(sd, f"text_seg_dec.maps_projector.{idx}", t[ours])
    _decoder_video(sd, "text_seg_dec.video_decoder", t["video_decoder"],
                   decoder_up_blocks, decoder_layers_per_block)
    _conv(sd, "text_seg_dec.seg_head", t["seg_head"])
    _conv(sd, "text_seg_dec.recon_head", t["recon_head"])
    _gpt2(sd, tree["text_dec"], gpt2_layers, "text_dec.decoder.")
    _lin(sd, "text_dec.clip_project.model.0",
         tree["text_dec"]["clip_project"])
    return sd


# ------------------------------------------------------------ safetensors ----

_ST_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
             torch.bool: "BOOL"}


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` in the safetensors format (an 8-byte little-endian
    header length, the JSON header padded to 8 bytes, then each tensor's
    little-endian bytes in order). Returns the bytes written."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs = []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        blobs.append(t)
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(raw) + offset


# ------------------------------------- T5, LPIPS, the PatchGAN discriminator --

def t5_encoder_state_dict(tree: Tree, cfg) -> Dict[str, np.ndarray]:
    """T5Encoder tree -> HF T5EncoderModel keys (`embed_tokens` tied to
    `shared`, as HF saves it)."""
    sd: Dict[str, np.ndarray] = {
        "shared.weight": np.asarray(tree["shared"]),
        "encoder.embed_tokens.weight": np.asarray(tree["shared"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
        ".weight": np.asarray(tree["relative_attention_bias"]),
        "encoder.final_layer_norm.weight": np.asarray(
            tree["final_norm"]["weight"]),
    }
    for i in range(cfg.num_layers):
        q, blk = f"encoder.block.{i}", tree[f"block_{i}"]
        sd[f"{q}.layer.0.layer_norm.weight"] = np.asarray(
            blk["attn_norm"]["weight"])
        for k in ("q", "k", "v", "o"):
            _lin(sd, f"{q}.layer.0.SelfAttention.{k}", blk[k])
        sd[f"{q}.layer.1.layer_norm.weight"] = np.asarray(
            blk["ff_norm"]["weight"])
        for k in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{q}.layer.1.DenseReluDense.{k}", blk[k])
    return sd


def lpips_state_dict(tree: Tree) -> Dict[str, np.ndarray]:
    """LPIPS tree -> the `vgg_lpips` layout (the VGG trunk's slices, the
    NetLin heads after their dropout, the scaling layer's buffers)."""
    from neurons_tpu_torch.training.perceptual import (_SCALE, _SHIFT,
                                                       _VGG_SLICES, LPIPS_CHNS)
    sd: Dict[str, np.ndarray] = {
        "scaling_layer.shift": np.asarray(_SHIFT, np.float32)[None, :, None,
                                                              None],
        "scaling_layer.scale": np.asarray(_SCALE, np.float32)[None, :, None,
                                                              None]}
    for si, (_, idxs) in enumerate(_VGG_SLICES):
        for ci in idxs:
            _conv(sd, f"net.slice{si + 1}.{ci}", tree["net"][f"conv_{ci}"])
    for k in range(len(LPIPS_CHNS)):
        _conv(sd, f"lin{k}.model.1", tree[f"lin{k}"])
    return sd


def nlayer_discriminator_state_dict(params: Tree, batch_stats: Tree,
                                    n_layers: int = 3
                                    ) -> Dict[str, np.ndarray]:
    """NLayerDiscriminator params and batch_stats trees -> the PatchGAN's
    Sequential keys (`main.<i>`, the BatchNorms' running statistics and
    `num_batches_tracked`)."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "main.0", params["conv_0"])
    si = 2
    for n in range(1, n_layers + 1):
        _conv(sd, f"main.{si}", params[f"conv_{n}"])
        _norm(sd, f"main.{si + 1}", params[f"bn_{n}"])
        sd[f"main.{si + 1}.running_mean"] = np.asarray(
            batch_stats[f"bn_{n}"]["mean"])
        sd[f"main.{si + 1}.running_var"] = np.asarray(
            batch_stats[f"bn_{n}"]["var"])
        sd[f"main.{si + 1}.num_batches_tracked"] = np.asarray(0, np.int64)
        si += 3
    _conv(sd, f"main.{si}", params["conv_out"])
    return sd
