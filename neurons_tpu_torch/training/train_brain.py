"""Stage-1 trainer: the brain core aligned contrastively to CLIP space.

Counterpart of neurons_tpu/training/train_brain.py. One step mixes the
voxels (BiMixCo), runs ridge -> backbone -> clipproj with the mixer
dropout, takes the bidirectional InfoNCE against the CLIP image tokens
(mixup soft targets) and against the caption embeddings (0.25 x), and
applies AdamW to every parameter but `clipproj`, which is frozen (it is
not in the optimizer: `freeze_by_prefix(("clipproj",))`).

bf16 autocast (TrainConfig.bf16_autocast) is the JAX package's, as in
stage 2 (`module_caller`): the forward runs through
torch.func.functional_call on bf16 copies of the f32 masters, the voxels
cast to bf16 after the mixup, the outputs and every loss term in f32.

Randomness: a step's mixup draws and dropout keep masks are one
`Stage1Draws`, passed in or drawn from a generator (`draw_stage1`).

Data-parallel (a `parallel.Mesh` of N > 1 ranks, each holding its rows of
the global batch): the step is the one-process step of the global batch.
Its draws are the global batch's (every rank draws them alike); MixCo
mixes the gathered voxels and each rank keeps its rows, and both InfoNCE
terms run over the gathered embeddings (`distributed.gather_rows`, whose
backward sums the ranks' gradients), so every rank's loss is the global
one; the gradients are then averaged over the ranks before the update
(`distributed.all_reduce_grads_`), which the clip sees.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import BrainModelConfig, TrainConfig
from neurons_tpu_torch.models.brain import MixerDropout, draw_mixer_dropout
from neurons_tpu_torch.models.neurons import NeuronsCore
from neurons_tpu_torch.parallel import distributed
from neurons_tpu_torch.parallel.mesh import Mesh, local_rows
from neurons_tpu_torch.training import losses
from neurons_tpu_torch.training.optimizers import (Schedule, freeze_by_prefix,
                                                   make_optimizer,
                                                   optimizer_step)
from neurons_tpu_torch.utils.synth_init import synth_params_

FROZEN = freeze_by_prefix(("clipproj",))


class TrainState(NamedTuple):
    """`params` are the model's own parameters by name (the optimizer
    updates the trainable ones in place); `step` counts updates from 0."""

    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int


class Stage1Draws(NamedTuple):
    """One step's draws: the raw mixup draws, and the mixer dropout's keep
    masks (None: the core runs without dropout)."""

    mixco: losses.MixcoState
    dropout: Optional[MixerDropout]


def module_caller(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                  bf16: bool):
    """`call(submodule, *args, **kw)`: the submodule ("" for `model`
    itself) with the call's weights (bf16 copies of the masters under
    autocast, else f32), floating args cast to the call's type, floating
    outputs back to f32."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    weights = {n: p.to(dtype) for n, p in params.items()}

    def cast(x, to):
        return x.to(to) if torch.is_tensor(x) and x.is_floating_point() else x

    def call(sub: str, *args, **kw):
        prefix = sub + "." if sub else ""
        sub_weights = {n[len(prefix):]: w for n, w in weights.items()
                       if n.startswith(prefix)}
        out = functional_call(model.get_submodule(sub), sub_weights,
                              tuple(cast(a, dtype) for a in args), kw)
        if isinstance(out, tuple):
            return tuple(cast(o, torch.float32) for o in out)
        return cast(out, torch.float32)

    return call


def init_stage1(cfg: BrainModelConfig, tcfg: TrainConfig,
                steps_per_epoch: int, seed: int = 0, device="cuda",
                host_draws: bool = False
                ) -> Tuple[NeuronsCore, TrainState, Schedule]:
    """The f32 core with seeded random weights (`synth_params_`, drawn on
    the CPU with `host_draws`), AdamW over all of it but `clipproj`
    (frozen), and the LR schedule."""
    with torch.device(resolve_device(device)):
        model = NeuronsCore(cfg)
    synth_params_(model, seed, host=host_draws)
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(not FROZEN(n))
    opt, schedule = make_optimizer(
        tcfg, [p for n, p in params.items() if not FROZEN(n)],
        steps_per_epoch)
    return model, TrainState(params, opt, 0), schedule


def draw_stage1(cfg: BrainModelConfig, voxel: torch.Tensor,
                generator: torch.Generator,
                rows: Optional[int] = None) -> Stage1Draws:
    """A step's draws for a batch `voxel` [B, ...] from `generator` (on
    its device; they are moved to the batch's where used): the mixup's,
    then the dropout keep masks. `rows`: draw for that many rows instead
    (the global batch of a data-parallel step)."""
    b = voxel.shape[0] if rows is None else rows
    return Stage1Draws(losses.draw_mixco(b, generator),
                       draw_mixer_dropout(cfg, b, generator))


def shard_draws(draws: Stage1Draws, mesh: Mesh) -> Stage1Draws:
    """This rank's rows of a global batch's draws: the dropout masks'
    (MixCo's stay global: it mixes the gathered batch)."""
    if draws.dropout is None:
        return draws
    b = draws.mixco.perm.shape[0]
    rows = local_rows(mesh, b)
    return Stage1Draws(draws.mixco, MixerDropout(
        *(tuple(m[rows] for m in ms) for ms in draws.dropout)))


def stage1_loss(model: NeuronsCore, params: Dict[str, torch.Tensor],
                draws: Stage1Draws, voxel: torch.Tensor,
                clip_target: torch.Tensor, text_target: torch.Tensor,
                mixco_temp: float, use_mixco: bool = True,
                bf16_autocast: bool = False, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The stage-1 loss and its metrics. With `use_mixco` the vision term
    is the mixup InfoNCE, else SoftCLIP. Under a `mesh` of several ranks the
    inputs are this rank's rows, the draws the global batch's MixCo draws
    and this rank's dropout masks (`shard_draws`), and the loss is the
    global batch's."""
    sharded = mesh is not None and mesh.world > 1
    state = None
    if use_mixco and sharded:
        mixed, state = losses.mixco(distributed.gather_rows(voxel),
                                    draws.mixco)
        voxel = mixed[local_rows(mesh, mixed.shape[0])]
    elif use_mixco:
        voxel, state = losses.mixco(voxel, draws.mixco)
    call = module_caller(model, params, bf16_autocast)
    _, clip_vision, clip_text = call(
        "", voxel, deterministic=draws.dropout is None,
        dropout_masks=draws.dropout)
    b = clip_vision.shape[0]
    v_norm = losses.l2norm(clip_vision.reshape(b, -1))
    t_norm = losses.l2norm(clip_target.reshape(b, -1))
    ct_norm = losses.l2norm(clip_text)
    tt_norm = losses.l2norm(text_target.reshape(b, -1))
    if sharded:
        v_norm, t_norm, ct_norm, tt_norm = map(
            distributed.gather_rows, (v_norm, t_norm, ct_norm, tt_norm))
    if use_mixco:
        loss_vision = losses.mixco_nce(v_norm, t_norm, temp=mixco_temp,
                                       state=state)
    else:
        loss_vision = losses.soft_clip_loss(v_norm, t_norm)
    loss_text = losses.mixco_nce(ct_norm, tt_norm) * 0.25
    loss = loss_vision + loss_text
    return loss, {"loss": loss.detach(),
                  "loss_clip_vision": loss_vision.detach(),
                  "loss_clip_txt": loss_text.detach()}


def make_stage1_train_step(model: NeuronsCore, schedule: Schedule,
                           tcfg: TrainConfig, mesh: Optional[Mesh] = None):
    """`train_step(state, draws, voxel, clip_target, text_target)` ->
    (state, metrics); `draws` is a Stage1Draws or a torch.Generator to draw
    them from (dropout on). The previous step's gradients are released
    before the backward, so one set is live at a time. Under a `mesh` the
    inputs are this rank's rows and `draws` the global batch's (a
    generator draws them for the global batch); the gradients are averaged
    over the ranks before the update."""
    cfg = model.backbone.cfg
    sharded = mesh is not None and mesh.world > 1

    def train_step(state: TrainState,
                   draws: Union[Stage1Draws, torch.Generator],
                   voxel: torch.Tensor, clip_target: torch.Tensor,
                   text_target: torch.Tensor):
        if isinstance(draws, torch.Generator):
            draws = draw_stage1(cfg, voxel, draws, rows=(
                voxel.shape[0] * mesh.world if sharded else None))
        if sharded:
            draws = shard_draws(draws, mesh)
        trainable = [p for n, p in state.params.items() if not FROZEN(n)]
        for p in trainable:
            p.grad = None
        loss, metrics = stage1_loss(model, state.params, draws, voxel,
                                    clip_target, text_target,
                                    tcfg.mixco_temp, use_mixco=True,
                                    bf16_autocast=tcfg.bf16_autocast,
                                    mesh=mesh)
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        # another subject's ridge gets a zero gradient, as optax gives it
        for p, g in zip(trainable, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        del grads
        if mesh is not None:
            distributed.all_reduce_grads_(trainable)
        optimizer_step(state.optimizer, schedule, state.step, tcfg.grad_clip)
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_stage1_eval_step(model: NeuronsCore):
    """`eval_step(params, voxel, clip_target, text_target)` -> the epoch
    eval's metrics (0-d tensors), in f32 without dropout: top-1 retrieval
    of the CLIP targets within the batch, both ways, and top-5 caption
    retrieval through clipproj."""

    @torch.no_grad()
    def eval_step(params, voxel, clip_target, text_target):
        _, clip_vision, clip_text = functional_call(model, params, (voxel,))
        v = losses.l2norm(clip_vision.reshape(clip_vision.shape[0], -1))
        t = losses.l2norm(clip_target.reshape(clip_target.shape[0], -1))
        labels = torch.arange(v.shape[0], device=v.device)
        fwd = losses.topk_accuracy(
            losses.batchwise_cosine_similarity(v, t), labels, k=1)
        bwd = losses.topk_accuracy(
            losses.batchwise_cosine_similarity(t, v), labels, k=1)
        ct = losses.l2norm(clip_text)
        tt = losses.l2norm(text_target.reshape(text_target.shape[0], -1))
        txt = losses.topk_accuracy(
            losses.batchwise_cosine_similarity(ct, tt), labels, k=5)
        return {"test_fwd_percent_correct": fwd,
                "test_bwd_percent_correct": bwd,
                "text_fwd_percent_correct": txt}

    return eval_step


def select_stage1_inputs(batch: Dict[str, np.ndarray], epoch: int,
                         clip_targets: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Epoch-parity selection: voxel repeat epoch % 2, frame 2 + epoch % 2
    of the CLIP table [N, n_frames, 256, 1664] (clamped to its depth; f32,
    the table may be f16 on disk), else of the batch's images."""
    r = epoch % 2
    voxel = batch["voxel"][:, r][:, None]  # [B, 1, nv]
    if clip_targets is not None:
        frame = min(2 + r, clip_targets.shape[1] - 1)
        target = np.asarray(clip_targets[batch["index"], frame], np.float32)
        return voxel, target
    return voxel, batch["images"][:, 2 + r]
