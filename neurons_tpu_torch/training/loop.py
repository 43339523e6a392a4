"""The stage-2 training loop (epochs of steps over host-side batches).

Counterpart of neurons_tpu/training/loop.py:407-577 (`run_stage2`) and
:680-705 (`synthetic_stage2_batch_builder`): the epoch/step loop with the
SoftCLIP temperature index, the curriculum arguments, the optional bf16
frozen core, a log line every `log_every` steps and the per-epoch mean of
every loss term. The JAX loop's mesh argument has no counterpart (one
card). Checkpointing and resume, the epoch-end core eval and the seg
panels are not ported yet (ROADMAP queue 1); the JAX package's epoch eval
scores only the frozen core (loop.py:584-598), which a port must not copy
as if it were intended.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import (BrainModelConfig, DecouplerConfig,
                                      PriorConfig, TrainConfig)
from neurons_tpu_torch.data import cc2017
from neurons_tpu_torch.training import losses, train_decoupler

# logger(metrics, step): the per-epoch record
Logger = Callable[[Dict[str, float], int], None]


def _log(msg: str):
    print(msg, flush=True)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def run_stage2(bcfg: BrainModelConfig, pcfg: PriorConfig,
               dcfg: DecouplerConfig, tcfg: TrainConfig, gpt2_cfg,
               train_split: cc2017.CC2017Split,
               batch_builder: Callable[[Dict, int], Dict],
               core_params: Optional[Dict[str, torch.Tensor]] = None,
               log_every: int = 50, logger: Optional[Logger] = None,
               bf16_frozen_core: bool = False, device="cuda"
               ) -> train_decoupler.TrainState:
    """Stage-2 training. `batch_builder(batch, epoch)` assembles the
    precomputed-table fields (numpy) for a raw batch of `train_split`.
    Weights come from `tcfg.seed`, each step's draws from a generator seeded
    with it, the batch order of epoch e from seed `tcfg.seed + e`.
    `bf16_frozen_core=True` holds the forward-only core in bf16."""
    device = resolve_device(device)
    steps_per_epoch = max(len(train_split) // tcfg.batch_size, 1)
    bundle, state = train_decoupler.init_stage2(
        bcfg, pcfg, dcfg, tcfg, gpt2_cfg, steps_per_epoch, seed=tcfg.seed,
        core_params=core_params, device=device)
    step_fn = train_decoupler.make_stage2_train_step(bundle, tcfg, dcfg,
                                                     steps_per_epoch)
    mixup_epochs = int(tcfg.mixup_pct * tcfg.num_epochs)
    soft_temps = losses.cosine_anneal(
        tcfg.soft_temp_start, tcfg.soft_temp_end,
        max(tcfg.num_epochs - mixup_epochs, 1)).tolist()
    if bf16_frozen_core:
        bundle.model.core.to(torch.bfloat16)
        state = state._replace(params=dict(bundle.model.named_parameters()))
    generator = torch.Generator(device).manual_seed(tcfg.seed)

    for epoch in range(tcfg.num_epochs):
        t0 = time.time()
        comps: Dict[str, list] = {}
        temp_idx = min(max(epoch - mixup_epochs, 0), len(soft_temps) - 1)
        for it, raw in enumerate(cc2017.batches(train_split, tcfg.batch_size,
                                                seed=tcfg.seed + epoch)):
            batch = to_device(batch_builder(raw, epoch), device)
            state, metrics = step_fn(state, generator, batch, epoch, it,
                                     soft_temps[temp_idx])
            for k, v in metrics.items():
                comps.setdefault(k, []).append(v)
            if it % log_every == 0:
                _log(f"epoch {epoch} it {it}: "
                     f"loss={float(metrics['loss']):.4f} "
                     f"prior={float(metrics['loss_prior']):.4f} "
                     f"seg={float(metrics['loss_key_obj_seg']):.4f}")
        means = {k: float(torch.stack(v).float().mean())
                 for k, v in comps.items()}
        _log(f"epoch {epoch}: mean_loss={means['loss']:.4f} "
             f"({time.time() - t0:.1f}s)")
        if logger is not None:
            logger({"epoch": epoch, "train/mean_loss": means["loss"],
                    **{f"train/mean_{k}": v for k, v in means.items()
                       if k != "loss"},
                    "epoch_seconds": time.time() - t0}, state.step)
    return state


def synthetic_stage2_batch_builder(bcfg: BrainModelConfig,
                                   dcfg: DecouplerConfig, gpt2_vocab: int,
                                   seed: int = 0) -> Callable:
    """Batch builder with random frozen-encoder tables (numpy, from `seed`):
    the smoke path when real CLIP/VAE tables are absent."""
    g = np.random.default_rng(seed)

    def build(batch: Dict, epoch: int) -> Dict:
        b = len(batch["voxel"])
        f = dcfg.n_frames
        n, c = bcfg.clip_seq_dim, bcfg.clip_emb_dim
        return {
            "voxel": batch["voxel"][:, :1].astype(np.float32),
            "clip_vision_target": g.normal(size=(b, n, c)).astype(np.float32),
            "clip_video_target": g.normal(size=(b, f, n, c)).astype(np.float32),
            "text_emb": batch["text_emb"].astype(np.float32),
            "key_obj_text_embed": g.normal(
                size=(b, dcfg.clip_txt_emb_dim)).astype(np.float32),
            "key_obj_masks": batch["key_obj_masks"][:, :f].astype(np.float32),
            "cls_label": batch["cls_label"].astype(np.float32),
            "clip_tokens": (batch["clip_tokens"][:, :12] % gpt2_vocab
                            ).astype(np.int32),
            "vae_latents": g.normal(size=(b, f, 4, 8, 8)).astype(np.float32),
        }

    return build
