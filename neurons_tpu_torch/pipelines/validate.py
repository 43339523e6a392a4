"""Re-scoring of the --fast presets: how far each preset's final latents
lie from the exact sampler's, per stage, on the weights at hand.

The scoring of neurons_tpu/cli.py:cmd_validate, factored out of the
command so that it can run on any modules and draws:

  stage 3: `unclip_sample` on the unCLIP UNet, tokens [1, n_tok, ctx],
           a zero adm vector, the decode the identity (the samples are the
           latents unscaled, x 0.8 + 0.2, clipped to [0, 1], as the JAX
           command scores them);
  stage 5: `reconstruct_video` through UNet3D + SparseCtrl on a blurry
           video, a keyframe and a text embedding; the encoder is an 8 x 8
           average pool of the pixels (3 channels and the first again,
           minus 0.5), the decoded frames are not scored.

Per preset and stage: the rms of (fast - exact) over the rms of exact
(`rms_rel`, 5 decimals) and their correlation (`corr`, 6 decimals), both in
f32 numpy as the JAX command computes them. Every run of a stage takes the
same explicit draws, as the JAX command reuses its keys; a run whose
options another preset already ran is not run again (the same options
give the same latents), so the exact trajectory runs once a stage.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from neurons_tpu_torch.models.vae import DiagonalGaussian
from neurons_tpu_torch.pipelines.keyframe import UnclipNoise, unclip_sample
from neurons_tpu_torch.pipelines.video import reconstruct_video


class ValidateInputs(NamedTuple):
    """The draws every run of a stage shares."""

    tokens: torch.Tensor       # [1, n_tok, ctx]: stage 3's CLIP tokens
    vector: torch.Tensor       # [1, adm_in_channels]
    unclip: UnclipNoise        # stage 3's sampler draws
    video_noise: torch.Tensor  # [1, 4, F, hw5, hw5]: stage 5's init noise
    blurry: torch.Tensor       # [1, 6, 3, 8 hw5, 8 hw5] in [0, 1]
    keyframe: torch.Tensor     # [1, 3, 8 hw5, 8 hw5] in [0, 1]
    text: torch.Tensor         # [1, 77, cross_attention_dim]


def draw_inputs(context_dim: int, adm_in_channels: int, cross_dim: int,
                hw3: int, hw5: int, frames: int, n_tok: int,
                seed: int) -> ValidateInputs:
    """The draws of the JAX command's shapes and scales, from a CPU
    generator seeded with `seed`."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g)

    tokens = normal(1, n_tok, context_dim) * 0.3
    lat3 = (1, 4, hw3, hw3)
    unclip = UnclipNoise(normal(*lat3), normal(*lat3), normal(1),
                         normal(*tokens.shape))
    px = hw5 * 8
    return ValidateInputs(
        tokens=tokens, vector=torch.zeros((1, adm_in_channels)),
        unclip=unclip, video_noise=normal(1, 4, frames, hw5, hw5),
        blurry=torch.rand((1, 6, 3, px, px), generator=g),
        keyframe=torch.rand((1, 3, px, px), generator=g),
        text=normal(1, 77, cross_dim) * 0.1)


class ProxyAutoencoder(nn.Module):
    """The stand-in autoencoder of the scoring: `encode` pools 8 x 8 pixel
    blocks (3 channels and the first again, minus 0.5), `decode` is the
    identity. Its one parameter gives the pipelines its device and f32."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros((), device=device),
                                   requires_grad=False)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        n, c, h, w = x.shape
        p = x.float().reshape(n, c, h // 8, 8, w // 8, 8).mean(dim=(3, 5))
        mean = torch.cat([p, p[:, :1]], dim=1) - 0.5
        return DiagonalGaussian(mean, torch.zeros_like(mean))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return z


def deviation(base: np.ndarray, fast: np.ndarray) -> Dict[str, float]:
    """rms(fast - base) / rms(base) and their correlation, in f32."""
    base = np.asarray(base, np.float32)
    fast = np.asarray(fast, np.float32)
    diff = fast - base
    rms = float(np.sqrt((diff ** 2).mean())
                / max(np.sqrt((base ** 2).mean()), 1e-12))
    corr = float(np.corrcoef(base.ravel(), fast.ravel())[0, 1])
    return {"rms_rel": round(rms, 5), "corr": round(corr, 6)}


def preset_options(spec: dict, steps3: int, steps5: int):
    """A FAST_PRESETS entry -> (stage 3's options, stage 5's), the gate
    step held below the stage's step count."""
    return ({"tgate_step": min(spec["recon"]["tgate"], steps3 - 1),
             "tgate_pab": spec["recon"]["tgate_pab"]},
            {"tgate_step": min(spec["video"]["tgate"], steps5 - 1),
             "tgate_pab": spec["video"]["tgate_pab"]})


@torch.inference_mode()
def score_presets(unet2d: nn.Module, unet3d: nn.Module,
                  controlnet: nn.Module, inputs: ValidateInputs,
                  presets: dict, *, steps3: int, hw3: int, steps5: int,
                  frames: int, device,
                  log: Optional[Callable[[str], None]] = None):
    """{preset: {"stage3": deviation, "stage5": deviation}} of each preset
    against the exact sampler, and the seconds of each run
    ({"stage3": {options: s}, "stage5": {options: s}}, the exact run under
    "exact"). The modules lie on `device`; the draws are moved there."""
    dev = torch.device(device)
    vae = ProxyAutoencoder(dev)
    tokens, vector = inputs.tokens.to(dev), inputs.vector.to(dev)
    blurry, keyframe = inputs.blurry.to(dev), inputs.keyframe.to(dev)
    text = inputs.text.to(dev)

    def stage3(**opts):
        return unclip_sample(unet2d, vae, tokens, num_steps=steps3,
                             latent_hw=hw3, noise=inputs.unclip,
                             vector=vector, **opts)

    def stage5(**opts):
        return reconstruct_video(
            unet3d, controlnet, vae, blurry, keyframe, text,
            torch.zeros_like(text), num_steps=steps5, n_frames=frames,
            noise=inputs.video_noise, device=dev, **opts).latents

    runs = {"stage3": stage3, "stage5": stage5}
    done: Dict[tuple, np.ndarray] = {}
    seconds: Dict[str, Dict[str, float]] = {"stage3": {}, "stage5": {}}

    def latents(stage: str, opts: dict) -> np.ndarray:
        key = (stage,) + tuple(sorted(opts.items()))
        if key not in done:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            done[key] = runs[stage](**opts).float().cpu().numpy()
            name = ",".join(f"{k}={v}" for k, v in sorted(opts.items()))
            seconds[stage][name or "exact"] = time.perf_counter() - t0
        return done[key]

    results = {}
    for name, spec in sorted(presets.items()):
        opts3, opts5 = preset_options(spec, steps3, steps5)
        r3 = deviation(latents("stage3", {}), latents("stage3", opts3))
        r5 = deviation(latents("stage5", {}), latents("stage5", opts5))
        results[name] = {"stage3": r3, "stage5": r5}
        if log is not None:
            log(f"--fast {name}: stage3 rms={r3['rms_rel']:.4f} "
                f"corr={r3['corr']:.5f} | stage5 rms={r5['rms_rel']:.4f} "
                f"corr={r5['corr']:.5f}")
    return results, seconds
