"""The training loops of stages 1 and 2: epochs of steps over host-side
batches, the epoch eval, checkpointing and resume.

Counterpart of neurons_tpu/training/loop.py: `run_stage1` (epoch-parity
inputs, the retrieval eval in batches of 100, best-metric saves, optionally
throttled, a full-state `brain_model_last`), `run_stage2` (the SoftCLIP
temperature index, the curriculum, the optional bf16 frozen core, the
one-time `brain_model_core` artifact, mid-run saves of the trained subtree
only, the full-tree `brain_model_prior_last` at the end, the seg panels),
both with resume from their `_last` tag and a simulated preemption
(`stop_after_epochs`), and the stage-2 batch builders.

`mesh` (a `parallel.Mesh`, from `create_mesh`) trains data-parallel over
the process group, as the JAX loops train over theirs: every rank
assembles the same global batch from the same seed and
`prefetch_to_device` gives it this rank's rows (on a card from pinned
memory, on a side stream, two batches ahead); the steps compute the global
batch's loss and average the gradients (train_brain, train_decoupler), so
every rank holds the same parameters. Each rank runs the stage-1 eval and
takes rank 0's metrics (`broadcast_from_host0`), so every rank makes the
same best and save decisions. Rank 0 alone logs, writes metrics and saves
(`utils/checkpoint.py`); every rank takes rank 0's answer of whether to
resume and from where, and a barrier follows the final save. Without a
mesh the loop is a mesh of one rank: the same feed, on one process.

Each step's draws come from a generator seeded from (seed, epoch, step)
(`utils.prng.epoch_generator`, the port's `epoch_key`), the batch order of
epoch e from seed `tcfg.seed + e` and the LR schedule from the step count
the checkpoint carries, so a run resumed at an epoch boundary takes the
steps an uninterrupted run takes. Stage 1 draws on the CPU (its draws are
small, and the card and the CPU then draw alike); stage 2 on its device.

Stage 2 has no epoch eval yet: the JAX package's scores only the frozen
core (loop.py:584-598), so its metric cannot move during stage 2. Without
one, `brain_model_prior` is saved on the `best_save_every` schedule, as
the JAX loop saves it when it runs without a test split.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import (BrainModelConfig, DecouplerConfig,
                                      PriorConfig, TrainConfig)
from neurons_tpu_torch.data import cc2017
from neurons_tpu_torch.diffusion import prior as prior_lib
from neurons_tpu_torch.models.decoder_video import DecoderDropout
from neurons_tpu_torch.parallel import distributed
from neurons_tpu_torch.parallel.mesh import (Mesh, local_rows,
                                             prefetch_to_device, replicate)
from neurons_tpu_torch.training import losses, train_brain, train_decoupler
from neurons_tpu_torch.training.train_decoupler import is_core
from neurons_tpu_torch.utils import checkpoint as ckpt_lib
from neurons_tpu_torch.utils.metrics_log import MetricLogger
from neurons_tpu_torch.utils.prng import epoch_generator

#: draws(epoch, it, batch) -> the step's draws (Stage1Draws or Stage2Draws)
#: for its batch of device tensors
DrawFn = Callable[[int, int, Dict[str, torch.Tensor]], Any]


def _log(msg: str):
    if distributed.is_main_process():
        print(msg, flush=True)


def _loop_mesh(device, mesh: Optional[Mesh]) -> Mesh:
    """The loop's mesh: `mesh` (on `device`), or this process alone."""
    device = resolve_device(device)
    if mesh is None:
        return Mesh(world=1, rank=0, device=device)
    if mesh.device != device:
        raise ValueError(f"the mesh's device {mesh.device} is not the "
                         f"loop's {device}")
    return mesh


def _resume_found(ckpt_dir: str, tag: str) -> bool:
    """Whether `tag` is there to resume from: rank 0's answer on every
    rank. Rank 0 first finishes a swap a crash interrupted (`ckpt_lib.
    exists` puts a `<tag>.old` back), and the broadcast returns on no rank
    before it has, so every rank then reads the same tag."""
    found = distributed.is_main_process() and ckpt_lib.exists(ckpt_dir, tag)
    return distributed.broadcast_from_host0(found)


def _resume_point(point: Tuple[int, float, int]) -> Tuple[int, float, int]:
    """(start epoch, best metric, best epoch) of a resume, rank 0's on
    every rank."""
    return distributed.broadcast_from_host0(point)


def _eval_targets(clip_targets_test, sl: slice, device) -> torch.Tensor:
    """The eval's CLIP targets for a test chunk: frame 2 of the table
    [N, n_frames, 256, 1664] (clamped to its depth), or a callable
    `sl -> [b, 256, 1664]` tensor."""
    if callable(clip_targets_test):
        return clip_targets_test(sl)
    return torch.as_tensor(np.asarray(
        clip_targets_test[sl, min(2, clip_targets_test.shape[1] - 1)],
        np.float32), device=device)


def _sans_core(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A mid-run stage-2 payload: the trained subtree only. The frozen core
    is immutable during stage 2 and has its own one-time artifact
    (`brain_model_core`), so the mid-run saves scale with the trained
    model; the end-of-training save keeps the full tree."""
    return {n: p for n, p in params.items() if not is_core(n)}


def _best_extra(best_metric: float, epoch: int) -> Dict:
    """The best-gate state saved with every `_last` tag, so a resumed run
    keeps its best-metric watermark."""
    return {"best_metric": float(best_metric), "best_epoch": int(epoch)}


#: accounting of the last `_restore_state`: `peak_extra_bytes`, the most
#: bytes the restore held on the state's device above the live state at
#: any point (a tensor whose type the payload changes is replaced, the old
#: one freed after: one tensor at most); `copied_bytes`, the bytes copied
#: in place; on a CUDA device also `device_peak_extra_bytes`, the allocator's
#: peak during the restore above what is allocated after it (the restore
#: resets the device's peak-memory statistics)
LAST_RESTORE_STATS: Dict[str, int] = {}


class _RestoreAccounting:
    def __init__(self):
        self.extra = self.peak_extra = 0
        self.copied_bytes = self.put_bytes = self.freed_bytes = 0

    def put(self, n: int):
        self.extra += n
        self.put_bytes += n
        self.peak_extra = max(self.peak_extra, self.extra)

    def freed(self, n: int):
        self.extra -= n
        self.freed_bytes += n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _restore_tensor(dst: torch.Tensor, src: torch.Tensor,
                    acct: _RestoreAccounting):
    """`src` (CPU) into `dst` in place. Where the payload holds another
    type (a bf16 frozen core) the payload's wins: a tensor of its type
    takes `dst`'s place and the old storage is freed."""
    if dst.shape != src.shape:
        raise ValueError(f"checkpoint shape {tuple(src.shape)} != live "
                         f"shape {tuple(dst.shape)}")
    if dst.dtype == src.dtype:
        dst.copy_(src)
        acct.copied_bytes += _nbytes(src)
        return
    new = src.to(dst.device)
    acct.put(_nbytes(new))
    old = _nbytes(dst)
    dst.data = new
    acct.freed(old)


def _load_optimizer_state(opt: torch.optim.Optimizer, saved: Dict,
                          acct: _RestoreAccounting) -> bool:
    """A saved optimizer state_dict copied into `opt`'s state in place
    (`load_state_dict` would allocate a second copy of both moments);
    False, with nothing changed, when it does not fit `opt`."""
    params = [p for g in opt.param_groups for p in g["params"]]
    groups = saved.get("param_groups", [])
    if ([len(g["params"]) for g in groups]
            != [len(g["params"]) for g in opt.param_groups]):
        return False
    states = saved.get("state", {})
    for i, p in enumerate(params):
        live, got = opt.state.get(p, {}), states.get(i)
        if got is None or set(got) != set(live) or any(
                torch.is_tensor(v) and v.shape != live[k].shape
                for k, v in got.items()):
            return False
    for i, p in enumerate(params):
        for k, v in states[i].items():
            _restore_tensor(opt.state[p][k], v, acct)
    for live_group, group in zip(opt.param_groups, groups):
        live_group.update({k: v for k, v in group.items() if k != "params"})
    return True


def _restore_state(ckpt_dir: str, tag: str, state):
    """Resume from `tag` into the live `state` (a TrainState), in place:
    the payload is read on the CPU (memory-mapped) and copied into the
    live parameters and optimizer moments tensor by tensor, so the device
    holds one train state throughout, plus one tensor where the payload
    changes a type.

    Three payload generations: the full tree; the trained subtree only
    (stage 2's mid-run saves: live entries the payload lacks, the frozen
    core, keep their values); params only (no opt_state, or one that does
    not fit the optimizer: the optimizer state and, with the step count,
    the LR schedule restart, and a line says so). Restore first, then cast:
    the restored tensors take the payload's types, and a caller's bf16 cast
    of the frozen core comes after. Returns (state, start_epoch, extra)."""
    payload = ckpt_lib.load_ckpt(ckpt_dir, tag)
    acct = _RestoreAccounting()
    device = next(iter(state.params.values())).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    step = int(payload["step"])
    with torch.no_grad():
        for name, value in payload["params"].items():
            if name in state.params:
                _restore_tensor(state.params[name], value, acct)
        saved_opt = payload.get("opt_state")
        if saved_opt is None:
            _log(f"--- resume: {tag} carries no opt_state (a params-only "
                 f"payload): the optimizer state and LR schedule restart ---")
            step = 0
        elif not _load_optimizer_state(state.optimizer, saved_opt, acct):
            _log(f"--- resume: the opt_state of {tag} does not fit the "
                 f"optimizer; params-only resume: the optimizer state and "
                 f"LR schedule restart ---")
            step = 0
    LAST_RESTORE_STATS.clear()
    LAST_RESTORE_STATS.update(
        peak_extra_bytes=acct.peak_extra, copied_bytes=acct.copied_bytes,
        put_bytes=acct.put_bytes, freed_bytes=acct.freed_bytes)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        LAST_RESTORE_STATS["device_peak_extra_bytes"] = (
            torch.cuda.max_memory_allocated(device)
            - torch.cuda.memory_allocated(device))
    return (state._replace(step=step), int(payload["epoch"]) + 1,
            payload.get("extra") or {})


def _open_saver(ckpt_dir: Optional[str], async_saves: bool):
    """(writer or None, the mid-run save function)."""
    saver = (ckpt_lib.AsyncCkptWriter() if (async_saves and ckpt_dir)
             else None)
    return saver, (saver.submit if saver is not None else ckpt_lib.save_ckpt)


def _stop_now(stop_after_epochs, epoch, start_epoch, num_epochs) -> bool:
    return (stop_after_epochs is not None
            and epoch + 1 - start_epoch >= stop_after_epochs
            and epoch + 1 < num_epochs)


# ------------------------------------------------------------ stage 1 ----

def run_stage1(bcfg: BrainModelConfig, tcfg: TrainConfig,
               train_split: cc2017.CC2017Split,
               test_split: cc2017.CC2017Split,
               clip_targets_train, clip_targets_test,
               ckpt_dir: Optional[str] = None,
               log_every: int = 50, logger=None,
               resume: bool = False,
               stop_after_epochs: Optional[int] = None,
               warm_start_params: Optional[Dict[str, torch.Tensor]] = None,
               async_saves: bool = False,
               best_save_every: int = 1,
               draws: Optional[DrawFn] = None,
               host_draws: bool = False,
               device="cuda",
               mesh: Optional[Mesh] = None) -> train_brain.TrainState:
    """Stage-1 training of the core.

    clip_targets_*: the CLIP tables [N, n_frames, 256, 1664] (numpy or
    memory-mapped), or callables: train `(indices, epoch) -> [B, 256, 1664]`
    and test `slice -> [b, 256, 1664]` tensors.
    `warm_start_params`: a {name: tensor} overlay of the core's parameters
    applied after init (a resume takes precedence).
    `resume=True` restores `brain_model_last` (params, optimizer, step,
    epoch, the best-metric watermark). `stop_after_epochs=k` simulates a
    preemption: after k epochs it saves `brain_model_last` (and flushes an
    unsaved best) and returns; the schedule keeps its full horizon.
    `best_save_every=k` saves the best-metric `brain_model` at most once
    per k epochs: a deferred save writes the save epoch's params, and its
    `extra` carries best_metric, best_epoch and save_epoch_metric; an
    unsaved improvement is flushed at the last epoch and on preemption.
    `async_saves=True` writes the mid-run saves in the background
    (`AsyncCkptWriter`, a device copy of the payload).
    `draws(epoch, it, batch)` gives a step's draws; by default they come
    from the CPU generator of (tcfg.seed, epoch, it), dropout on;
    `host_draws=True` draws the initial weights on the CPU too, so the
    card starts where the CPU starts.
    `logger` has MetricLogger's `log_metrics`; by default a MetricLogger
    under `ckpt_dir`. `mesh`: data-parallel over its ranks (module
    docstring; `device` must be the mesh's); a callable
    `clip_targets_train` is asked for this rank's rows, and `draws`
    returns the global batch's draws (`batch` holds this rank's rows)."""
    mesh = _loop_mesh(device, mesh)
    device = mesh.device
    if logger is None:
        logger = MetricLogger(log_dir=ckpt_dir)
    steps_per_epoch = max(len(train_split) // tcfg.batch_size, 1)
    model, state, schedule = train_brain.init_stage1(
        bcfg, tcfg, steps_per_epoch, seed=tcfg.seed, device=device,
        host_draws=host_draws)
    if warm_start_params is not None:
        with torch.no_grad():
            for name, value in warm_start_params.items():
                if name in state.params:
                    state.params[name].copy_(value)
    replicate(mesh, state.params)
    step_fn = train_brain.make_stage1_train_step(model, schedule, tcfg, mesh)
    eval_fn = train_brain.make_stage1_eval_step(model)
    if draws is None:
        def draws(epoch, it, batch):  # the step draws the global batch's
            return epoch_generator(tcfg.seed, epoch, it)

    start_epoch, best_metric, best_epoch = 0, -np.inf, -1
    if resume and ckpt_dir and _resume_found(ckpt_dir, "brain_model_last"):
        state, start_epoch, rextra = _restore_state(
            ckpt_dir, "brain_model_last", state)
        best_metric = float(rextra.get("best_metric", -np.inf))
        best_epoch = int(rextra.get("best_epoch", -1))
        start_epoch, best_metric, best_epoch = _resume_point(
            (start_epoch, best_metric, best_epoch))
        _log(f"--- resumed brain_model_last at epoch {start_epoch} "
             f"(best_metric {best_metric:.3f}) ---")

    saver, mid_save = _open_saver(ckpt_dir, async_saves)
    try:
        state = _stage1_epochs(
            tcfg, train_split, test_split, clip_targets_train,
            clip_targets_test, ckpt_dir, log_every, logger,
            stop_after_epochs, saver, mid_save, state, step_fn, eval_fn,
            draws, start_epoch, best_metric, best_epoch, best_save_every,
            device, mesh)
    except BaseException:
        if saver is not None:
            saver.abort()  # drop queued snapshots; don't leak the thread
        raise
    if saver is not None:
        saver.close()
    distributed.barrier()  # every tag on disk before any rank reads one
    return state


def _stage1_batches(train_split, tcfg, epoch, clip_targets_train):
    """The host batches of an epoch (a callable `clip_targets_train`
    gives this rank's rows: `_stage1_feed`)."""
    for batch in cc2017.batches(train_split, tcfg.batch_size,
                                seed=tcfg.seed + epoch):
        if callable(clip_targets_train):
            voxel = batch["voxel"][:, epoch % 2][:, None]
            target = clip_targets_train(batch["index"], epoch)
        else:
            voxel, target = train_brain.select_stage1_inputs(
                batch, epoch, clip_targets_train)
        yield {"voxel": voxel, "target": target, "text": batch["text_emb"]}


def _stage1_feed(train_split, tcfg, epoch, clip_targets_train, mesh):
    targets = clip_targets_train
    if callable(clip_targets_train):
        def targets(index, epoch):  # this rank's rows, placed by the caller
            return clip_targets_train(index[local_rows(mesh, len(index))],
                                      epoch)
    return prefetch_to_device(
        _stage1_batches(train_split, tcfg, epoch, targets), mesh)


def _stage1_eval(eval_fn, params, test_split, clip_targets_test, device):
    """The retrieval eval in batches of min(100, len(test)) (the
    reference's test loader: top-1 among 99 distractors, not over the whole
    test set); the mean of each metric over the batches."""
    eval_bs = min(100, len(test_split))
    sums = {"test_fwd_percent_correct": 0.0,
            "test_bwd_percent_correct": 0.0,
            "text_fwd_percent_correct": 0.0}
    nb = 0
    for start in range(0, len(test_split) - eval_bs + 1, eval_bs):
        sl = slice(start, start + eval_bs)
        ev = eval_fn(params,
                     torch.as_tensor(test_split.voxel[sl, :1], device=device),
                     _eval_targets(clip_targets_test, sl, device),
                     torch.as_tensor(test_split.text_emb[sl], device=device))
        for k in sums:
            sums[k] += float(ev[k])
        nb += 1
    return {k: v / nb for k, v in sums.items()}


def _stage1_epochs(tcfg, train_split, test_split, clip_targets_train,
                   clip_targets_test, ckpt_dir, log_every, logger,
                   stop_after_epochs, saver, mid_save, state, step_fn,
                   eval_fn, draws, start_epoch, best_metric, best_epoch,
                   best_save_every, device, mesh):
    pending_best = False
    last_best_saved = -(1 << 30)
    for epoch in range(start_epoch, tcfg.num_epochs):
        t0 = time.time()
        ep_losses = []
        for it, b in enumerate(_stage1_feed(train_split, tcfg, epoch,
                                            clip_targets_train, mesh)):
            state, metrics = step_fn(state, draws(epoch, it, b), b["voxel"],
                                     b["target"], b["text"])
            ep_losses.append(metrics["loss"])
            if it % log_every == 0:
                _log(f"epoch {epoch} it {it}: "
                     f"loss={float(metrics['loss']):.4f}")
        ep_losses = [float(x) for x in ep_losses]

        ev = _stage1_eval(eval_fn, state.params, test_split,
                          clip_targets_test, device)
        ev = distributed.broadcast_from_host0(ev)  # rank 0's, everywhere
        fwd = ev["test_fwd_percent_correct"]
        bwd = ev["test_bwd_percent_correct"]
        txt = ev["text_fwd_percent_correct"]
        metric = fwd + bwd + txt
        _log(f"epoch {epoch}: mean_loss={np.mean(ep_losses):.4f} "
             f"fwd={fwd:.3f} bwd={bwd:.3f} txt={txt:.3f} "
             f"({time.time() - t0:.1f}s)")
        logger.log_metrics({"epoch": epoch,
                            "train/mean_loss": float(np.mean(ep_losses)),
                            "test/fwd_pct": fwd, "test/bwd_pct": bwd,
                            "test/text_pct": txt,
                            "epoch_seconds": time.time() - t0},
                           step=state.step)
        if metric > best_metric:
            best_metric, best_epoch = metric, epoch
            pending_best = True
        if ckpt_dir and pending_best and (
                epoch - last_best_saved >= best_save_every
                or epoch == tcfg.num_epochs - 1):
            if epoch == best_epoch:
                _log(f"  new best metric {best_metric:.3f} -> saved "
                     f"brain_model")
            else:
                _log(f"  best metric {best_metric:.3f} seen at epoch "
                     f"{best_epoch}; saving epoch {epoch} params (metric "
                     f"{metric:.3f}; best_save_every={best_save_every} "
                     f"throttle: tag approximate)")
            mid_save(ckpt_dir, "brain_model", params=state.params,
                     opt_state=None, step=state.step, epoch=epoch,
                     extra={**_best_extra(best_metric, best_epoch),
                            "save_epoch_metric": float(metric)})
            last_best_saved = epoch
            pending_best = False
        if _stop_now(stop_after_epochs, epoch, start_epoch, tcfg.num_epochs):
            if ckpt_dir:
                if saver is not None:
                    saver.drain()
                if pending_best:
                    _log(f"  flushing pending best (metric {best_metric:.3f}, "
                         f"epoch {best_epoch}) before preemption")
                    ckpt_lib.save_ckpt(
                        ckpt_dir, "brain_model", params=state.params,
                        step=state.step, epoch=epoch,
                        extra=_best_extra(best_metric, best_epoch))
                ckpt_lib.save_ckpt(
                    ckpt_dir, "brain_model_last", params=state.params,
                    opt_state=state.optimizer.state_dict(), step=state.step,
                    epoch=epoch, extra=_best_extra(best_metric, best_epoch))
            _log(f"--- simulated preemption after epoch {epoch} ---")
            return state
    if saver is not None:
        saver.drain()
    if ckpt_dir and tcfg.ckpt_saving:
        ckpt_lib.save_ckpt(ckpt_dir, "brain_model_last", params=state.params,
                           opt_state=state.optimizer.state_dict(),
                           step=state.step, epoch=tcfg.num_epochs - 1,
                           extra=_best_extra(best_metric, best_epoch))
    return state


# ------------------------------------------------------------ stage 2 ----

def run_stage2(bcfg: BrainModelConfig, pcfg: PriorConfig,
               dcfg: DecouplerConfig, tcfg: TrainConfig, gpt2_cfg,
               train_split: cc2017.CC2017Split,
               batch_builder: Callable[[Dict, int], Dict],
               core_params: Optional[Dict[str, torch.Tensor]] = None,
               ckpt_dir: Optional[str] = None,
               log_every: int = 50, logger=None,
               resume: bool = False,
               image_log_every: int = 1,
               bf16_frozen_core: bool = False,
               last_save_every: int = 0,
               stop_after_epochs: Optional[int] = None,
               async_saves: bool = False,
               best_save_every: int = 1,
               draws: Optional[DrawFn] = None,
               host_draws: bool = False,
               device="cuda",
               mesh: Optional[Mesh] = None) -> train_decoupler.TrainState:
    """Stage-2 training. `batch_builder(batch, epoch)` assembles the
    precomputed-table fields (numpy) for a raw batch of `train_split`;
    `core_params` is stage 1's core (`load_stage1_core`). Weights come
    from `tcfg.seed`; `draws(epoch, it, batch)` gives a step's draws, by
    default `draw_stage2` from the device generator of (tcfg.seed, epoch,
    it); `host_draws=True` draws them and the initial weights on the CPU
    generator instead, so the card draws what the CPU draws. `bf16_frozen_core=True` holds the
    forward-only core in bf16 (after any resume restore).

    With `ckpt_dir`: the one-time `brain_model_core` artifact (the frozen
    core, in its training type) before the first epoch; `brain_model_prior`
    (the trained subtree) every `best_save_every` epochs and at the last;
    `brain_model_prior_last` (the trained subtree and the optimizer) every
    `last_save_every` epochs, and with the full tree at the end.
    `resume`, `stop_after_epochs` and `async_saves` as in `run_stage1`.
    `image_log_every=k` logs the seg panels (`make_stage2_seg_panel_fn`,
    `min(4, B)` clips of the epoch's last batch) every k epochs through
    `logger.log_images`; `logger` has MetricLogger's `log_metrics` and
    `log_images`, by default a MetricLogger under `ckpt_dir`. `mesh`:
    data-parallel over its ranks (module docstring; `device` must be the
    mesh's); `draws` returns the global batch's draws (`batch` holds this
    rank's rows), and rank 0 logs the seg panel of its rows."""
    mesh = _loop_mesh(device, mesh)
    device = mesh.device
    if logger is None:
        logger = MetricLogger(log_dir=ckpt_dir)
    steps_per_epoch = max(len(train_split) // tcfg.batch_size, 1)
    bundle, state = train_decoupler.init_stage2(
        bcfg, pcfg, dcfg, tcfg, gpt2_cfg, steps_per_epoch, seed=tcfg.seed,
        core_params=core_params, device=device, host_draws=host_draws)
    replicate(mesh, state.params)
    step_fn = train_decoupler.make_stage2_train_step(
        bundle, tcfg, dcfg, steps_per_epoch, mesh)
    mixup_epochs = int(tcfg.mixup_pct * tcfg.num_epochs)
    soft_temps = losses.cosine_anneal(
        tcfg.soft_temp_start, tcfg.soft_temp_end,
        max(tcfg.num_epochs - mixup_epochs, 1)).tolist()
    if draws is None and host_draws:
        host_diffusion = prior_lib.PriorDiffusion.create(
            pcfg.timesteps, pcfg.cond_drop_prob, device="cpu")

        def draws(epoch, it, batch):
            shape = {"clip_vision_target": batch["clip_vision_target"].cpu()}
            d = train_decoupler.draw_stage2(
                host_diffusion, shape, dcfg,
                epoch_generator(tcfg.seed, epoch, it),
                rows=batch["voxel"].shape[0] * mesh.world)
            return train_decoupler.Stage2Draws(
                prior_lib.PriorDraws(*(x.to(device) for x in d.prior)),
                DecoderDropout(*(x.to(device) for x in d.dropout)))
    elif draws is None:
        def draws(epoch, it, batch):  # the step draws the global batch's
            return epoch_generator(tcfg.seed, epoch, it, device)

    start_epoch, best_metric, best_epoch = 0, -np.inf, -1
    tag = "brain_model_prior_last"
    if resume and ckpt_dir and _resume_found(ckpt_dir, tag):
        state, start_epoch, rextra = _restore_state(ckpt_dir, tag, state)
        best_metric = float(rextra.get("best_metric", -np.inf))
        best_epoch = int(rextra.get("best_epoch", -1))
        start_epoch, best_metric, best_epoch = _resume_point(
            (start_epoch, best_metric, best_epoch))
        _log(f"--- resumed {tag} at epoch {start_epoch} ---")
    if bf16_frozen_core:
        bundle.model.core.to(torch.bfloat16)
        state = state._replace(params=dict(bundle.model.named_parameters()))
    if (ckpt_dir and tcfg.ckpt_saving
            and not ckpt_lib.exists(ckpt_dir, "brain_model_core")):
        # without it a run killed before the final full-tree `_last` would
        # leave no copy of the core beside its sans-core saves
        t0 = time.time()
        ckpt_lib.save_ckpt(ckpt_dir, "brain_model_core",
                           params={n: p for n, p in state.params.items()
                                   if is_core(n)})
        _log(f"--- wrote the one-time brain_model_core artifact "
             f"({time.time() - t0:.1f}s) ---")

    saver, mid_save = _open_saver(ckpt_dir, async_saves)
    panel_fn = (train_decoupler.make_stage2_seg_panel_fn(bundle, dcfg)
                if image_log_every else None)
    try:
        state = _stage2_epochs(
            tcfg, train_split, batch_builder, ckpt_dir, log_every, logger,
            image_log_every, last_save_every, stop_after_epochs,
            best_save_every, state, step_fn, soft_temps, mixup_epochs, draws,
            saver, mid_save, panel_fn, start_epoch, best_metric, best_epoch,
            device, mesh)
    except BaseException:
        if saver is not None:
            saver.abort()
        raise
    if saver is not None:
        saver.close()
    distributed.barrier()  # every tag on disk before any rank reads one
    return state


def _stage2_epochs(tcfg, train_split, batch_builder, ckpt_dir, log_every,
                   logger, image_log_every, last_save_every,
                   stop_after_epochs, best_save_every, state, step_fn,
                   soft_temps, mixup_epochs, draws, saver, mid_save,
                   panel_fn, start_epoch, best_metric, best_epoch, device,
                   mesh):
    last_best_saved = -(1 << 30)
    for epoch in range(start_epoch, tcfg.num_epochs):
        t0 = time.time()
        comps: Dict[str, list] = {}
        temp_idx = min(max(epoch - mixup_epochs, 0), len(soft_temps) - 1)
        last_batch = None
        host = (batch_builder(raw, epoch) for raw in cc2017.batches(
            train_split, tcfg.batch_size, seed=tcfg.seed + epoch))
        for it, batch in enumerate(prefetch_to_device(host, mesh)):
            state, metrics = step_fn(state, draws(epoch, it, batch), batch,
                                     epoch, it, soft_temps[temp_idx])
            for k, v in metrics.items():
                comps.setdefault(k, []).append(v)
            last_batch = batch
            if it % log_every == 0:
                _log(f"epoch {epoch} it {it}: "
                     f"loss={float(metrics['loss']):.4f} "
                     f"prior={float(metrics['loss_prior']):.4f} "
                     f"seg={float(metrics['loss_key_obj_seg']):.4f}")
        if (panel_fn is not None and epoch % image_log_every == 0
                and last_batch is not None
                and distributed.is_main_process()):
            nshow = min(4, last_batch["voxel"].shape[0])
            pred, gt = panel_fn(
                state.params, epoch_generator(tcfg.seed, epoch, 0, device),
                {k: v[:nshow] for k, v in last_batch.items()})
            logger.log_images({"seg_pred": pred.cpu().numpy(),
                               "seg_gt": gt.cpu().numpy()}, step=state.step)
        means = {k: float(torch.stack(v).float().mean())
                 for k, v in comps.items()}
        _log(f"epoch {epoch}: mean_loss={means['loss']:.4f} "
             f"({time.time() - t0:.1f}s)")
        logger.log_metrics({"epoch": epoch, "train/mean_loss": means["loss"],
                            **{f"train/mean_{k}": v for k, v in means.items()
                               if k != "loss"},
                            "epoch_seconds": time.time() - t0},
                           step=state.step)
        # no eval (module docstring): every epoch is a pending best
        if ckpt_dir and (epoch - last_best_saved >= best_save_every
                         or epoch == tcfg.num_epochs - 1):
            mid_save(ckpt_dir, "brain_model_prior",
                     params=_sans_core(state.params), step=state.step,
                     epoch=epoch,
                     extra={**_best_extra(best_metric, best_epoch),
                            "save_epoch_metric": float("nan")})
            last_best_saved = epoch
        if (ckpt_dir and last_save_every
                and (epoch + 1) % last_save_every == 0):
            mid_save(ckpt_dir, "brain_model_prior_last",
                     params=_sans_core(state.params),
                     opt_state=state.optimizer.state_dict(),
                     step=state.step, epoch=epoch,
                     extra=_best_extra(best_metric, best_epoch))
        if _stop_now(stop_after_epochs, epoch, start_epoch, tcfg.num_epochs):
            if ckpt_dir:
                if saver is not None:
                    saver.drain()
                if last_best_saved != epoch:  # don't drop the pending save
                    _log("  flushing the pending brain_model_prior before "
                         "preemption")
                    ckpt_lib.save_ckpt(
                        ckpt_dir, "brain_model_prior",
                        params=_sans_core(state.params), step=state.step,
                        epoch=epoch,
                        extra=_best_extra(best_metric, best_epoch))
                ckpt_lib.save_ckpt(
                    ckpt_dir, "brain_model_prior_last",
                    params=_sans_core(state.params),
                    opt_state=state.optimizer.state_dict(), step=state.step,
                    epoch=epoch, extra=_best_extra(best_metric, best_epoch))
            _log(f"--- simulated preemption after epoch {epoch} ---")
            return state
    if saver is not None:
        saver.drain()  # never race the full-tree save below on a tag
    if ckpt_dir and tcfg.ckpt_saving:
        ckpt_lib.save_ckpt(ckpt_dir, "brain_model_prior_last",
                           params=state.params,
                           opt_state=state.optimizer.state_dict(),
                           step=state.step, epoch=tcfg.num_epochs - 1,
                           extra=_best_extra(best_metric, best_epoch))
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


def structured_stage2_batch_builder(clip_targets: np.ndarray, aux: Dict,
                                    split: cc2017.CC2017Split,
                                    dcfg: DecouplerConfig,
                                    gpt2_vocab: int) -> Callable:
    """Batch builder over `cc2017.structured_synthetic_split`'s outputs:
    per-sample targets indexed by the batch's dataset 'index', so the
    stage-2 losses can converge. The builder depends on the batch and the
    tables only: a resumed run builds the batches an uninterrupted one
    builds."""

    def build(batch: Dict, epoch: int) -> Dict:
        f = dcfg.n_frames
        idx = batch["index"]
        video = np.asarray(clip_targets[idx, :f], np.float32)
        key_cls = batch["key_obj_cls"].astype(np.int64)
        return {
            "voxel": batch["voxel"][:, :1].astype(np.float32),
            "clip_vision_target": video[:, min(2, f - 1)],
            "clip_video_target": video,
            "text_emb": batch["text_emb"].astype(np.float32),
            "key_obj_text_embed": aux["class_text_embeds"][key_cls],
            "key_obj_masks": batch["key_obj_masks"][:, :f].astype(np.float32),
            "cls_label": batch["cls_label"].astype(np.float32),
            "clip_tokens": (batch["clip_tokens"][:, :12] % gpt2_vocab
                            ).astype(np.int32),
            "vae_latents": np.asarray(aux["vae_latents"][idx, :f],
                                      np.float32),
        }

    return build


def table_stage2_batch_builder(root_dir: str, dcfg: DecouplerConfig,
                               gpt2_vocab: int,
                               caption_token_len: int = 60) -> Callable:
    """Real-data batch builder over the precomputed frozen-encoder tables
    under `root_dir` (`clip_targets_train.npy` [N, F, 256, 1664] and
    `vae_latents_train.npy` [N, F, 4, h, w], memory-mapped, and
    `class_text_embeds.npy` [51, 1280]), rows addressed by the batch's
    dataset 'index'."""
    import os

    clip_t = np.load(os.path.join(root_dir, "clip_targets_train.npy"),
                     mmap_mode="r")
    vae_t = np.load(os.path.join(root_dir, "vae_latents_train.npy"),
                    mmap_mode="r")
    class_emb = np.load(os.path.join(root_dir, "class_text_embeds.npy"))

    def build(batch: Dict, epoch: int) -> Dict:
        f = dcfg.n_frames
        idx = batch["index"]
        video = np.asarray(clip_t[idx, :f], np.float32)
        key_cls = batch["key_obj_cls"].astype(np.int64)
        return {
            "voxel": batch["voxel"][:, :1].astype(np.float32),
            "clip_vision_target": video[:, min(2, f - 1)],
            "clip_video_target": video,
            "text_emb": batch["text_emb"].astype(np.float32),
            "key_obj_text_embed": class_emb[key_cls].astype(np.float32),
            "key_obj_masks": batch["key_obj_masks"][:, :f].astype(np.float32),
            "cls_label": batch["cls_label"].astype(np.float32),
            "clip_tokens": (batch["clip_tokens"][:, :caption_token_len]
                            % gpt2_vocab).astype(np.int32),
            "vae_latents": np.asarray(vae_t[idx, :f], np.float32),
        }

    return build
