"""The reference's weight bundles -> parameter trees of the port's modules.

Counterpart of neurons_tpu/interop/load_weights.py: one call per weight
bundle, each returning the same nested numpy tree (flax layout) and the
same report as its JAX twin; `from_jax.load_jax_params` then fills the
port module:

  * unclip6 Lightning ckpt         -> stage-3 UNet + VAE (EMA swapped in)
  * SD-1.5 / DreamBooth LDM ckpt
    + AnimateDiff motion module
    + domain-adapter LoRA          -> stage-5 UNet3D
  * SD-1.5 VAE and text encoder    -> stage-5 VAE, CLIP text tower
  * SparseCtrl ckpt                -> stage-5 controlnet
  * SVD ckpt (sgm layout)          -> VideoUNet, temporal VideoDecoder,
                                      VAE Encoder

Files are read on the host. A `.safetensors` file is read by this module's
own reader (`read_safetensors`: memory-mapped, each tensor a
`torch.frombuffer` view, BF16/F16/F32 and the integer types); a torch zip
checkpoint is loaded memory-mapped, so an f32 tensor's numpy view (`t2j`)
stays file-backed until a module takes it. `materialize` builds a module
on the meta device and allocates it on the card in the stage's dtype, so
no f32 copy of a module is ever made on the host.
"""

from __future__ import annotations

import json
import mmap
import os
import resource
import sys
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from neurons_tpu_torch.interop import convert_ldm, torch_import as TI

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file as {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}},
    offsets relative to the end of the header), then the raw little-endian
    tensors. The file is memory-mapped copy-on-write: a tensor's pages are
    read when it is used."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors on a big-endian host")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which this reader does not know")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=count,
                             offset=base + begin)
        out[name] = t.reshape(shape)
    return out


def _torch_load(path: str) -> Dict:
    """A checkpoint's state dict: `.safetensors` through `read_safetensors`;
    otherwise `torch.load` (memory-mapped where the file is a zip
    checkpoint) with the JAX package's semantics: full unpickling, and a
    Lightning file's `state_dict` taken."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=False,
                    mmap=zipfile.is_zipfile(path))
    return sd.get("state_dict", sd)


def load_unclip_engine(ckpt_path: str, unet_cfg, vae_cfg,
                       use_ema: bool = True) -> Tuple[Dict, Dict, Dict]:
    """unclip6_epoch0_step110000.ckpt -> (unet2d params, vae params,
    report). EMA shadow weights replace the live UNet weights first (the
    reference samples inside `ema_scope`)."""
    sd = _torch_load(ckpt_path)
    report: Dict[str, Any] = {}
    if use_ema:
        sd, report["ema_swapped"] = TI.ldm_apply_ema(sd)
    unet_sd = TI.strip_prefix(sd, "model.diffusion_model.")
    unet_params, report["unet_unused"] = TI.import_ldm_unet(unet_sd, unet_cfg)
    vae_sd = TI.strip_prefix(sd, "first_stage_model.")
    vae_params, report["vae_unused"] = TI.import_ldm_vae(vae_sd, vae_cfg)
    return unet_params, vae_params, report


def load_animatediff_unet3d(base_ckpt_path: str, motion_module_path: str,
                            cfg,
                            lora_path: Optional[str] = None,
                            lora_alpha: float = 0.8,
                            dreambooth_path: Optional[str] = None
                            ) -> Tuple[Dict, Dict]:
    """Stage-5 UNet3D params assembled as the reference's `load_weights`
    does: SD-1.5 base (or a DreamBooth override) -> LDM->diffusers
    conversion -> LoRA merge -> spatial import -> motion-module merge."""
    report: Dict[str, Any] = {}
    sd = _torch_load(dreambooth_path or base_ckpt_path)
    if any(k.startswith("model.diffusion_model.") for k in sd):
        sd = TI.strip_prefix(sd, "model.diffusion_model.")
    if any(k.startswith("input_blocks.") for k in sd) or \
            "time_embed.0.weight" in sd:
        sd = convert_ldm.convert_ldm_unet_to_diffusers(sd)
    if lora_path:
        lora_sd = _torch_load(lora_path)
        sd, report["lora_unmatched"] = convert_ldm.merge_lora_into_state_dict(
            sd, lora_sd, alpha=lora_alpha, prefix="lora_unet")
        del lora_sd
    params, report["spatial_unused"] = TI.import_animatediff_unet3d(sd, cfg)
    del sd
    mm_sd = TI.filter_motion_module(_torch_load(motion_module_path))
    params, report["motion_unused"] = TI.import_motion_modules(
        mm_sd, cfg, params)
    return params, report


def load_sd_vae(ckpt_path: str, cfg) -> Tuple[Dict, Dict]:
    """SD-1.5 first-stage VAE (LDM keys under `first_stage_model.` or a
    standalone diffusers dump) -> AutoencoderKL params."""
    sd = _torch_load(ckpt_path)
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = TI.strip_prefix(sd, "first_stage_model.")
    if "encoder.down.0.block.0.norm1.weight" in sd:  # LDM layout
        sd = convert_ldm.convert_ldm_vae_to_diffusers(sd)
    params, unused = TI.import_diffusers_vae(
        sd, num_blocks=len(cfg.block_out_channels),
        layers_per_block=cfg.layers_per_block)
    return params, {"vae_unused": unused}


def load_sd_text_encoder(ckpt_path: str, layers: int) -> Tuple[Dict, Dict]:
    """SD-1.5 CLIP text tower (`cond_stage_model.transformer.` HF layout)
    -> CLIPTextTower params (SD's encoder has no `text_projection`)."""
    sd = _torch_load(ckpt_path)
    for prefix in ("cond_stage_model.transformer.",
                   "text_encoder.", "cond_stage_model.model."):
        if any(k.startswith(prefix) for k in sd):
            sd = TI.strip_prefix(sd, prefix)
            break
    params, unused = TI.import_hf_clip_text(sd, layers)
    return params, {"text_unused": unused}


def load_sparse_controlnet(ckpt_path: str, cfg) -> Tuple[Dict, Dict]:
    sd = _torch_load(ckpt_path)
    if any(k.startswith("controlnet.") for k in sd):
        sd = TI.strip_prefix(sd, "controlnet.")
    params, unused = TI.import_sparse_controlnet(sd, cfg)
    return params, {"controlnet_unused": unused}


def load_svd(ckpt_path: str, unet_cfg, dec_cfg,
             vae_cfg=None) -> Tuple[Dict, Dict, Dict, Dict]:
    """SVD checkpoint -> (VideoUNet params, temporal-decoder params,
    VAE-encoder params, report). The SVD safetensors/Lightning file uses
    the sgm layout: `model.diffusion_model.` the VideoUNet,
    `first_stage_model.` an AutoencodingEngine with an sgm Encoder (no
    quant_conv) and the temporal VideoDecoder; the `conditioner.` towers
    are counted and skipped. vae_cfg defaults to dec_cfg.vae; the encoder
    takes the LDM VAE key scheme (the encoder half only) and fills a
    `models.vae.Encoder`."""
    sd = _torch_load(ckpt_path)
    report: Dict[str, Any] = {}
    if any(k.startswith("conditioner.") for k in sd):
        # conditioner CLIP/VAE towers are loaded separately
        report["conditioner_keys_skipped"] = sum(
            1 for k in sd if k.startswith("conditioner."))
    unet_sd = TI.strip_prefix(sd, "model.diffusion_model.")
    unet_params, report["unet_unused"] = TI.import_svd_unet(unet_sd,
                                                            unet_cfg)
    fs = TI.strip_prefix(sd, "first_stage_model.")
    dec_sd = TI.strip_prefix(fs, "decoder.")
    dec_params, report["decoder_unused"] = TI.import_video_decoder(
        dec_sd, dec_cfg)
    vae_cfg = vae_cfg or dec_cfg.vae
    enc_params: Dict[str, Any] = {}
    if any(k.startswith("encoder.") for k in fs):
        enc_sd = TI.strip_prefix(fs, "encoder.")
        enc_params, report["encoder_unused"] = _import_vae_encoder(
            enc_sd, vae_cfg)
    return unet_params, dec_params, enc_params, report


def _import_vae_encoder(sd: Dict, cfg) -> Tuple[Dict, list]:
    """The encoder half of the sgm VAE layout (the key scheme
    import_ldm_vae maps under 'encoder.')."""
    tr = TI._Tracker(dict(sd))

    def resnet(prefix):
        r = {"norm1": TI.norm(tr, f"{prefix}.norm1"),
             "conv1": TI.conv(tr, f"{prefix}.conv1"),
             "norm2": TI.norm(tr, f"{prefix}.norm2"),
             "conv2": TI.conv(tr, f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.weight" in tr:
            r["nin_shortcut"] = TI.conv(tr, f"{prefix}.nin_shortcut")
        return r

    p: Dict[str, Any] = {
        "conv_in": TI.conv(tr, "conv_in"),
        "norm_out": TI.norm(tr, "norm_out"),
        "conv_out": TI.conv(tr, "conv_out"),
        "mid_block_1": resnet("mid.block_1"),
        "mid_attn": {"norm": TI.norm(tr, "mid.attn_1.norm"),
                     "q": TI._lin_or_1x1(tr, "mid.attn_1.q"),
                     "k": TI._lin_or_1x1(tr, "mid.attn_1.k"),
                     "v": TI._lin_or_1x1(tr, "mid.attn_1.v"),
                     "proj_out": TI._lin_or_1x1(tr, "mid.attn_1.proj_out")},
        "mid_block_2": resnet("mid.block_2"),
    }
    n = len(cfg.block_out_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block):
            p[f"down_{i}_block_{j}"] = resnet(f"down.{i}.block.{j}")
        if f"down.{i}.downsample.conv.weight" in tr:
            p[f"down_{i}_downsample"] = {
                "conv": TI.conv(tr, f"down.{i}.downsample.conv")}
    return p, tr.unused()


# ------------------------------------------------ filling the port modules ----

def materialize(build: Callable[..., nn.Module], device,
                dtype: torch.dtype) -> nn.Module:
    """`build(device=, dtype=)` on the meta device, then allocated
    uninitialised on `device` in `dtype` (no host copy, no init kernels);
    buffers are recomputed where they live (`init_buffers`). Every
    parameter must then be filled (`load_jax_params` is strict)."""
    module = build(device="meta", dtype=dtype).to_empty(device=device)
    for m in module.modules():
        if hasattr(m, "init_buffers"):
            m.init_buffers()
    return module.eval()


class RssPeak:
    """The host process's resident set size while a block runs, sampled
    every `interval` s by a thread (/proc/self/statm): `before` and `peak`
    in bytes."""

    def __init__(self, interval: float = 0.005):
        self.interval, self.before, self.peak = interval, 0, 0

    @staticmethod
    def now() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    def __enter__(self):
        import threading
        self.before = self.peak = self.now()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(self.interval):
                self.peak = max(self.peak, self.now())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())


def file_bytes(*paths: Optional[str]) -> int:
    return sum(os.path.getsize(p) for p in paths if p and os.path.exists(p))
