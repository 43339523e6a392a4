"""Stage-2 trainer: diffusion prior + decoupler heads.

Counterpart of neurons_tpu/training/train_decoupler.py. One step computes
all seven losses (prior DDPM MSE, temporal SoftCLIP, text NCE, key-object
Dice, multi-label BCE, caption CE, blurry-video L1) under the progressive
curriculum, takes gradients of the trainable parameters only, and applies
the AdamW update; the stage-1 core is frozen (it runs under no_grad and is
not in the optimizer).

Input contract (the JAX package's precomputed tables): `batch` holds
  voxel [B, 1, V], clip_vision_target [B, N, C], clip_video_target
  [B, F, N, C], text_emb [B, Ct], key_obj_text_embed [B, Ct],
  key_obj_masks [B, F, H, W], cls_label [B, K], clip_tokens [B, T] (int),
  vae_latents [B, F, 4, h, w]
as tensors on the model's device.

bf16 autocast (TrainConfig.bf16_autocast) is the JAX package's, not
torch.autocast: JAX casts every f32 parameter and input of a module call
to bf16 and its outputs back to f32, while torch.autocast picks per op and
keeps LayerNorm, GroupNorm and softmax in f32, a different function. So
each module call here runs through torch.func.functional_call with bf16
copies of the f32 master weights (the cast is in the autograd graph, so
the gradients reach the masters in f32), its f32 inputs cast to bf16 and
its bf16 outputs cast back to f32. Without autocast the call uses the
weights in f32 (a bf16 frozen core is promoted, as flax promotes it).

Randomness: the prior's timesteps, noise and cond-drop keep masks and the
decoder's dropout masks are one `Stage2Draws`, passed in or drawn from a
`torch.Generator` outside the checkpointed decoder calls, so that the
recompute of `torch.utils.checkpoint` (which restores the global RNG, not
a generator) sees the same masks. Both decoder calls share one set of
masks, as the JAX package's two applies share one dropout key.

Data-parallel (a `parallel.Mesh` of N > 1 ranks, each holding its rows of
the global batch): the step is the one-process step of the global batch,
as GSPMD computes it for the JAX package. The draws are the global
batch's, sliced to this rank's rows (`shard_draws`). The terms coupled
across the batch run over gathered rows (`distributed.gather_rows`, whose
backward sums the ranks' gradients): the temporal SoftCLIP over the B*F
rows, the text InfoNCE, the decoder's text attention over the batch of
texts and its temporal attention over all B*F rows (`decoder_video`); Dice
and the caption cross-entropy sum over the global batch (`across`), and
the per-row means (the prior's MSE, BCE, L1) are averaged over the ranks
(`distributed.mean_across_ranks`: shards are of equal size). Every rank's
loss and metrics are then the global batch's, and the gradients are
averaged over the ranks before the update (the clip sees the average).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import (BrainModelConfig, DecouplerConfig,
                                      PriorConfig, TrainConfig)
from neurons_tpu_torch.diffusion.prior import (PriorDiffusion, PriorDraws,
                                               draw_prior, p_losses)
from neurons_tpu_torch.models.decoder_video import (DecoderDropout, RowSplit,
                                                    draw_decoder_dropout)
from neurons_tpu_torch.models.gpt2 import GPT2Config
from neurons_tpu_torch.models.neurons import NeuronsDecoupler
from neurons_tpu_torch.parallel import distributed
from neurons_tpu_torch.parallel.mesh import Mesh, local_rows
from neurons_tpu_torch.training import losses
from neurons_tpu_torch.training.curriculum import get_loss_weights
from neurons_tpu_torch.training.train_brain import TrainState, module_caller
from neurons_tpu_torch.training.optimizers import (Schedule, make_optimizer,
                                                   optimizer_step)
from neurons_tpu_torch.utils.synth_init import synth_params_

LOSS_TERMS = ("loss_prior", "loss_clip_vision", "loss_clip_txt",
              "loss_key_obj_seg", "loss_multi_cls", "loss_text_gen",
              "loss_recon_video")


class Stage2Bundle(NamedTuple):
    model: NeuronsDecoupler     # the module; its parameters are the masters
    diffusion: PriorDiffusion
    schedule: Schedule


class Stage2Draws(NamedTuple):
    """One step's draws: the prior's, and the decoder's dropout keep masks
    (None: the decoder runs without dropout)."""

    prior: PriorDraws
    dropout: Optional[DecoderDropout]


def is_core(name: str) -> bool:
    return name.split(".", 1)[0] == "core"


def init_stage2(bcfg: BrainModelConfig, pcfg: PriorConfig,
                dcfg: DecouplerConfig, tcfg: TrainConfig,
                gpt2_cfg: GPT2Config, steps_per_epoch: int, seed: int = 0,
                core_params: Optional[Dict[str, torch.Tensor]] = None,
                device="cuda", host_draws: bool = False
                ) -> Tuple[Stage2Bundle, TrainState]:
    """The f32 ensemble with seeded random weights (`synth_params_`, drawn
    on the CPU with `host_draws`), the
    stage-1 core overlaid from `core_params` (a core state dict; names it
    does not hold keep their fresh values, unknown names are ignored, as
    the JAX package's restore_into) and frozen, and AdamW over the rest."""
    model = NeuronsDecoupler(bcfg, pcfg, dcfg, gpt2_cfg, device=device)
    synth_params_(model, seed, host=host_draws)
    if core_params is not None:
        own = dict(model.core.named_parameters())
        with torch.no_grad():
            for name, value in core_params.items():
                if name in own:
                    own[name].copy_(value)
    for p in model.core.parameters():
        p.requires_grad_(False)
    params = dict(model.named_parameters())
    opt, schedule = make_optimizer(
        tcfg, [p for n, p in params.items() if not is_core(n)],
        steps_per_epoch)
    diffusion = PriorDiffusion.create(pcfg.timesteps, pcfg.cond_drop_prob,
                                      device=resolve_device(device))
    return Stage2Bundle(model, diffusion, schedule), TrainState(params, opt, 0)


def draw_stage2(diffusion: PriorDiffusion, batch: Dict[str, torch.Tensor],
                dcfg: DecouplerConfig, generator: torch.Generator,
                rows: Optional[int] = None) -> Stage2Draws:
    """A step's draws for `batch` from `generator`: the prior's, then the
    decoder's keep masks. `rows`: draw for that many rows instead (the
    global batch of a data-parallel step)."""
    target = batch["clip_vision_target"]
    shape = tuple(target.shape) if rows is None else (
        (rows,) + tuple(target.shape[1:]))
    b, n = shape[:2]
    device = target.device
    prior = draw_prior(diffusion, shape, generator, device)
    return Stage2Draws(prior, draw_decoder_dropout(
        b * dcfg.n_frames, n, b, dcfg.clip_txt_emb_dim, generator, device))


def shard_draws(draws: Stage2Draws, mesh: Mesh) -> Stage2Draws:
    """This rank's rows of a global batch's draws: the prior's rows of B,
    the decoder masks' rows of B*F (their text axis stays the global
    batch's)."""
    rows = local_rows(mesh, draws.prior.times.shape[0])
    prior = PriorDraws(*(x[rows] for x in draws.prior))
    if draws.dropout is None:
        return Stage2Draws(prior, None)
    flat = local_rows(mesh, draws.dropout.attn.shape[0])
    return Stage2Draws(prior, DecoderDropout(
        *(m[flat] for m in draws.dropout)))


def stage2_loss(bundle: Stage2Bundle, params: Dict[str, torch.Tensor],
                draws: Stage2Draws, batch: Dict[str, torch.Tensor],
                soft_temp: float, weights: torch.Tensor, tcfg: TrainConfig,
                dcfg: DecouplerConfig, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted stage-2 loss and its metrics (each term, the total and
    the caption token accuracy). Under a `mesh` of several ranks `batch`
    and `draws` are this rank's rows (`shard_draws`) and the loss and
    metrics are the global batch's."""
    sharded = mesh is not None and mesh.world > 1
    gather = distributed.gather_rows if sharded else (lambda x: x)
    mean = distributed.mean_across_ranks if sharded else (lambda x: x)
    across = distributed.sum_across_ranks if sharded else None
    call = module_caller(bundle.model, params, tcfg.bf16_autocast)
    voxel = batch["voxel"]
    b, f = voxel.shape[0], dcfg.n_frames
    # the decoder's temporal sequence: all B*F rows of the global batch
    split = (RowSplit(distributed.gather_rows,
                      local_rows(mesh, b * f * mesh.world))
             if sharded else None)

    # frozen core forward
    with torch.no_grad():
        _, clip_vision, _ = call("core", voxel)

    # prior DDPM loss
    def net(image_embed, times, brain_embed, **kw):
        return call("prior_net", image_embed, times, brain_embed, **kw)

    loss_prior, prior_out = p_losses(bundle.diffusion, net,
                                     batch["clip_vision_target"], clip_vision,
                                     draws=draws.prior)
    loss_prior = mean(loss_prior)

    motion = call("motion_proj", prior_out)              # [B, F, N, C]

    # temporal SoftCLIP
    vt = losses.l2norm(batch["clip_video_target"].reshape(b, f, -1)
                       ).reshape(b * f, -1)
    mt = losses.l2norm(motion.reshape(b, f, -1)).reshape(b * f, -1)
    loss_clip_vision = losses.soft_clip_loss(gather(mt), gather(vt),
                                             temp=soft_temp)

    # text alignment
    pred_text = call("core.clipproj", motion.mean(dim=1))
    pred_text_norm = losses.l2norm(pred_text)
    target_text_norm = losses.l2norm(batch["text_emb"].reshape(b, -1))
    loss_clip_txt = losses.mixco_nce(gather(pred_text_norm),
                                     gather(target_text_norm))

    # key-object segmentation and blurry recon: the DecoderVideo head,
    # recomputed in the backward (its 64x64 activations are the step's
    # memory peak). Its temporal sequence is all B*F rows, as the JAX
    # package passes it (`split` over the ranks); the text attention runs
    # over the global batch's texts.
    def seg_decode(flat, text, is_seg):
        return call("text_seg_dec", flat, gather(text), time=flat.shape[0],
                    is_seg=is_seg, deterministic=draws.dropout is None,
                    dropout_masks=draws.dropout, split=split)

    flat_motion = motion.reshape(b * f, motion.shape[2], motion.shape[3])
    seg_logits = checkpoint(seg_decode, flat_motion,
                            batch["key_obj_text_embed"], True,
                            use_reentrant=False)         # [(B F), 1, h, w]
    hw = seg_logits.shape[-2:]
    masks = batch["key_obj_masks"]
    masks = F.interpolate(masks.reshape(b * f, 1, *masks.shape[-2:]).float(),
                          size=tuple(hw), mode="nearest-exact")
    loss_seg = losses.dice_loss(seg_logits, masks, across=across)

    # multi-label classification
    cls_pred = call("classifier", motion.mean(dim=1).mean(dim=1))
    loss_cls = mean(losses.bce_with_logits(cls_pred, batch["cls_label"]))

    # caption CE
    tokens = batch["clip_tokens"].long()
    logits = call("text_dec", pred_text_norm, tokens)[:, :-1]
    loss_text = losses.cross_entropy_ignore(logits, tokens, across=across)
    valid = tokens > 0
    hits = ((logits.argmax(-1) == tokens) & valid).sum()
    count = valid.sum()
    if sharded:
        hits, count = across(hits), across(count)
    acc_text = hits / count.clamp(min=1)

    # blurry video recon
    vae_lat = batch["vae_latents"]
    vae_lat = vae_lat.reshape(b * f, *vae_lat.shape[2:])
    rec = checkpoint(seg_decode, flat_motion, pred_text, False,
                     use_reentrant=False)                # [(B F), 4, h', w']
    rec = F.interpolate(rec, size=tuple(vae_lat.shape[-2:]),
                        mode="nearest-exact")
    loss_recon = mean(losses.l1_loss(rec, vae_lat))

    w = weights.to(loss_prior.device)
    loss = (loss_prior * tcfg.prior_scale + loss_clip_vision + loss_clip_txt
            + loss_seg * w[0] + loss_cls * w[1] + loss_text * w[2]
            + loss_recon * w[3])
    terms = (loss_prior, loss_clip_vision, loss_clip_txt, loss_seg, loss_cls,
             loss_text, loss_recon)
    metrics = {"loss": loss.detach(),
               **{k: v.detach() for k, v in zip(LOSS_TERMS, terms)},
               "train_acc_text_gen": acc_text.detach()}
    return loss, metrics


def make_stage2_seg_panel_fn(bundle: Stage2Bundle, dcfg: DecouplerConfig):
    """`panel(params, draws, batch)` -> (pred, gt), each [(B F), h, w]: the
    seg head's masks through a sigmoid beside the ground-truth masks
    resized to them (nearest, half-pixel centres), from the same one-step
    prior x0 the seg head trains on, without dropout or autocast (the
    JAX package's panel applies the f32 tree). `draws` are the prior's
    `PriorDraws` or a generator to draw them from. Runs under no_grad, on
    the weights' device, through the port's attention wrappers."""
    model = bundle.model

    @torch.no_grad()
    def panel(params: Dict[str, torch.Tensor],
              draws: Union[PriorDraws, torch.Generator],
              batch: Dict[str, torch.Tensor]):
        call = module_caller(model, params, False)
        voxel = batch["voxel"]
        b, f = voxel.shape[0], dcfg.n_frames
        _, clip_vision, _ = call("core", voxel)
        target = batch["clip_vision_target"]
        if isinstance(draws, torch.Generator):
            draws = draw_prior(bundle.diffusion, tuple(target.shape), draws,
                               target.device)

        def net(image_embed, times, brain_embed, **kw):
            return call("prior_net", image_embed, times, brain_embed, **kw)

        _, prior_out = p_losses(bundle.diffusion, net, target, clip_vision,
                                draws=draws)
        motion = call("motion_proj", prior_out)
        flat = motion.reshape(b * f, motion.shape[2], motion.shape[3])
        seg = call("text_seg_dec", flat, batch["key_obj_text_embed"],
                   time=b * f)
        pred = torch.sigmoid(seg.float())               # [(B F), 1, h, w]
        masks = batch["key_obj_masks"]
        gt = F.interpolate(masks.reshape(b * f, 1, *masks.shape[-2:]).float(),
                           size=tuple(pred.shape[-2:]), mode="nearest-exact")
        return pred[:, 0], gt[:, 0]

    return panel


def make_stage2_train_step(bundle: Stage2Bundle, tcfg: TrainConfig,
                           dcfg: DecouplerConfig, steps_per_epoch: int,
                           mesh: Optional[Mesh] = None):
    """`train_step(state, draws, batch, epoch, iteration, soft_temp)` ->
    (state, metrics); `draws` is a Stage2Draws or a torch.Generator to draw
    them from (dropout on). Under a `mesh` `batch` holds this rank's rows
    and `draws` are the global batch's (a generator draws them for the
    global batch); the gradients are averaged over the ranks before the
    update."""
    sharded = mesh is not None and mesh.world > 1

    def train_step(state: TrainState,
                   draws: Union[Stage2Draws, torch.Generator],
                   batch: Dict[str, torch.Tensor], epoch: int,
                   iteration: int, soft_temp: float):
        weights = get_loss_weights(tcfg.num_epochs, epoch, iteration,
                                   steps_per_epoch)
        if isinstance(draws, torch.Generator):
            draws = draw_stage2(bundle.diffusion, batch, dcfg, draws, rows=(
                batch["voxel"].shape[0] * mesh.world if sharded else None))
        if sharded:
            draws = shard_draws(draws, mesh)
        trainable = [p for n, p in state.params.items() if not is_core(n)]
        loss, metrics = stage2_loss(bundle, state.params, draws, batch,
                                    soft_temp, weights, tcfg, dcfg, mesh)
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        # an unused parameter gets a zero gradient, as optax gives it (its
        # Adam moments still decay)
        for p, g in zip(trainable, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        del grads
        if mesh is not None:
            distributed.all_reduce_grads_(trainable)
        optimizer_step(state.optimizer, bundle.schedule, state.step,
                       tcfg.grad_clip)
        return state._replace(step=state.step + 1), metrics

    return train_step
