"""The tiny data-parallel cases of tests/test_torch_port_parallel.py, as
plain functions that both the test (one process, the whole batch) and its
two-rank worker (tests/torch_parallel_worker.py, this rank's rows) call.
JAX-free: the worker imports no JAX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from neurons_tpu_torch import config
from neurons_tpu_torch.data import cc2017
from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
from neurons_tpu_torch.training import train_brain as tb
from neurons_tpu_torch.training import train_decoupler as td
from neurons_tpu_torch.utils import checkpoint as ckpt

#: the stage-1 cases' widths (those of tests/test_torch_port_stage1.py)
BCFG = dict(hidden_dim=32, n_blocks=2, clip_seq_dim=4, clip_emb_dim=16,
            clip_txt_emb_dim=8, subjects=(3,))
B1 = 8  # stage 1's global batch
STAGE2_SEED = 7


def stage2_configs():
    pcfg = config.tiny_pipeline_config()
    return (pcfg, config.replace(pcfg.train, bf16_autocast=False),
            tiny_gpt2_config())


def _grads(state, keep) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in state.params.items()
            if keep(n)}


def one_stage1_step(spec: Dict, batch: Dict[str, torch.Tensor], mesh):
    """One `make_stage1_train_step` from `spec` (params, the global
    batch's draws, TrainConfig fields) on `batch` (the rows of this
    process). Returns the metrics and the gradients the update used."""
    bcfg = config.BrainModelConfig(**BCFG)
    tcfg = config.TrainConfig(**spec["tcfg"])
    core, state, schedule = tb.init_stage1(bcfg, tcfg, 2, device="cpu")
    with torch.no_grad():
        for n, v in spec["params"].items():
            state.params[n].copy_(v)
    step = tb.make_stage1_train_step(core, schedule, tcfg, mesh)
    state, metrics = step(state, spec["draws"], batch["voxel"],
                          batch["target"], batch["text"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(state, lambda n: not tb.FROZEN(n))}


def one_stage2_step(spec: Dict, batch: Dict[str, torch.Tensor], mesh):
    """One f32 `make_stage2_train_step` of the tiny pipeline config (seeded
    weights) with the global batch's draws of `spec` on `batch`."""
    pcfg, tcfg, gcfg = stage2_configs()
    bundle, state = td.init_stage2(pcfg.brain, pcfg.prior, pcfg.decoupler,
                                   tcfg, gcfg, 4, seed=STAGE2_SEED,
                                   device="cpu")
    step = td.make_stage2_train_step(bundle, tcfg, pcfg.decoupler, 4, mesh)
    state, metrics = step(state, spec["draws"], batch, 0, 0, 0.05)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(state, lambda n: not td.is_core(n))}


def stage2_batch(seed: int = 3) -> Dict[str, np.ndarray]:
    """A global batch of the tiny pipeline config (numpy)."""
    pcfg, tcfg, gcfg = stage2_configs()
    g = np.random.default_rng(seed)
    b, f = tcfg.batch_size, pcfg.decoupler.n_frames
    n, c = pcfg.brain.clip_seq_dim, pcfg.brain.clip_emb_dim
    ct = pcfg.decoupler.clip_txt_emb_dim
    tokens = g.integers(1, gcfg.vocab_size, size=(b, 12))
    tokens[:, 9:] = 0
    tokens[0, 5:] = 0  # rows of other lengths: the global token count
    f32 = np.float32
    return {
        "voxel": g.standard_normal((b, 1, pcfg.brain.voxel_counts[0]), f32),
        "clip_vision_target": g.standard_normal((b, n, c), f32),
        "clip_video_target": g.standard_normal((b, f, n, c), f32),
        "text_emb": g.standard_normal((b, ct), f32),
        "key_obj_text_embed": g.standard_normal((b, ct), f32),
        "key_obj_masks": (g.uniform(size=(b, f, 32, 32)) < 0.3).astype(f32),
        "cls_label": (g.uniform(size=(b, pcfg.decoupler.num_classes))
                      < 0.3).astype(f32),
        "clip_tokens": tokens.astype(np.int64),
        "vae_latents": g.standard_normal((b, f, 4, 8, 8), f32),
    }


def stage1_run_args(spec: Dict):
    """(positional args of `run_stage1`, keywords) of the loop case: the
    tiny core over 2 batches of 8 structured synthetic clips, 2 epochs."""
    bcfg = config.BrainModelConfig(**BCFG)
    kw = dict(seq=bcfg.clip_seq_dim, emb=bcfg.clip_emb_dim,
              txt_dim=bcfg.clip_txt_emb_dim, n_frames=4)
    nv = bcfg.voxel_counts[0]
    train, table, _ = cc2017.structured_synthetic_split(2 * B1, nv, **kw)
    test, test_table, _ = cc2017.structured_synthetic_split(
        B1, nv, seed=1, train=False, **kw)
    tcfg = config.TrainConfig(**spec["tcfg"])
    return ((bcfg, tcfg, train, test, table, test_table),
            dict(warm_start_params=spec["params"], log_every=1))


def record_saves(monkeypatch=None) -> List:
    """Wrap `checkpoint.save_ckpt` (the loops look it up at call time) to
    record each call's (tag, epoch, extra) before it runs; through
    `monkeypatch` where given, else for the rest of the process."""
    calls, save = [], ckpt.save_ckpt

    def recording(directory, tag, **kw):
        extra = kw.get("extra") or {}
        calls.append((tag, int(kw.get("epoch", 0)),
                      {k: float(v) for k, v in extra.items()}))
        return save(directory, tag, **kw)

    if monkeypatch is not None:
        monkeypatch.setattr(ckpt, "save_ckpt", recording)
    else:
        ckpt.save_ckpt = recording
    return calls
