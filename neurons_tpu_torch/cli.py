"""The staged CLI of the port: stages 1-6 and e, `pipeline`, the tables,
the preset re-scoring and the server.

Counterpart of neurons_tpu/cli.py, with the same subcommands, flags, EXP
tree and artifacts:

  python -m neurons_tpu_torch.cli train-brain      stage 1: the core
  python -m neurons_tpu_torch.cli train-decoupler  stage 2: the heads
  python -m neurons_tpu_torch.cli recon            stage 3: keyframes,
      blurry videos and caption ids -> video_subj0{N}_all_recons.pt, ...
  python -m neurons_tpu_torch.cli caption          stage 4: BLIP-2 captions
  python -m neurons_tpu_torch.cli video            stage 5: the GIFs
  python -m neurons_tpu_torch.cli decoupled-eval   stage e: the heads' Dice
      and multi-label scores
  python -m neurons_tpu_torch.cli eval             stage 6: the metric report
  python -m neurons_tpu_torch.cli pipeline 12345e6 the stages in order
  python -m neurons_tpu_torch.cli precompute       the frozen-encoder tables
      (CLIP-bigG tokens, VAE latents, class-name embeds) under --root_dir
  python -m neurons_tpu_torch.cli validate         the --fast presets'
      deviation on the weights in --weights_dir (fastpath_validation.json)
  python -m neurons_tpu_torch.cli serve            the HTTP server over the
      clip (serving.py)

Every command runs on the card; `--platform cpu` runs it on the CPU.
`--synthetic --tiny` runs a stage on random data at miniature widths;
`--synthetic` alone draws full-width weights on the device in the stage's
dtype. Without them a missing weights file, class table, ground-truth
video or test-mask file raises. `--profile DIR` writes a torch.profiler
trace of the command to DIR/trace.json; `--debug_nans` turns on autograd's
anomaly mode (a NaN in a backward raises; the JAX package's jax_debug_nans
also checks forwards).

Weights read from `--weights_dir` (the reference's file names):
`unclip6_epoch0_step110000.ckpt` (stage 3), `v3_sd15_mm.ckpt`,
`realisticVisionV60B1_v51VAE.safetensors` (or `sd-v1-5.ckpt`),
`v3_sd15_adapter.ckpt` (optional LoRA) and `v3_sd15_sparsectrl_rgb.ckpt`
(stage 5), `brain_model_prior_last.pth` (the released ensemble, when the
EXP tree holds no stage-2 checkpoint), `last.pth` (MindEye2 warm start),
`blip2-opt.pt` (stage 4), the stage-6 classifiers, and `open_clip_bigG.pt`
with `sd_vae.pt` (precompute). From `--root_dir`: the CC2017 tensors
(`data/cc2017.py:load_split`), `class_text_embeds.npy`,
`clip_targets_{train,test}.npy`, `vae_latents_train.npy`,
`coco_tokens_avg_proj.pth`.

Under torchrun (`torchrun --nproc_per_node=N -m neurons_tpu_torch.cli
...`) the CLI joins the process group the environment describes
(`parallel/distributed.py:initialize`; NCCL, or gloo with `--platform
cpu`), each rank on cuda:LOCAL_RANK: `train-brain` and `train-decoupler`
train data-parallel over every rank (`create_mesh()`),
and `video` without `--num_shards` takes the clips `rank::N`.

Random draws of the generation stages come from a CPU generator seeded by
(seed, stage, the batch's first clip) (`utils/prng.py:stage_generator`),
so a card run and a CPU run draw the same noise; under `--tiny` the random
weights and stage 2's draws are made on the CPU too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from neurons_tpu_torch.config import FAST_PRESETS

_STAGE_STATS: dict = {}  # stage -> steady-state stats of its last loop
_CMD_T0: list = []       # set by _setup: the command's start
_SETUP_S: dict = {}
_STALL_EVENTS: dict = {}  # stage -> slow-batch events (_watchdog)
_LOAD_STATS: dict = {}    # weight bundle -> seconds, bytes, host peak RSS


def _add_common(p):
    p.add_argument("--subj", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--exp", type=str, default="exp1")
    p.add_argument("--root_dir", type=str, default="./cc2017_dataset")
    p.add_argument("--exp_dir", type=str, default="./EXP")
    p.add_argument("--weights_dir", type=str, default="./pretrained_weights")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true",
                   help="run on random data (no dataset needed)")
    p.add_argument("--tiny", action="store_true",
                   help="miniature model dims (smoke mode)")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="device the stage runs on (default: the card)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the command to "
                        "DIR/trace.json")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly mode: a NaN in a backward raises")
    p.add_argument("--n_test", type=int, default=0,
                   help="cap the number of test clips stages 3/5 process "
                        "(0 = 4 with --synthetic, else the whole test "
                        "split); caption and eval take every clip on disk")
    p.add_argument("--dtype", type=str, default=None,
                   choices=["bf16", "f32"],
                   help="module compute dtype of the generation stages "
                        "(default: bf16 at full size, f32 with --tiny)")


def _add_train_args(p):
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=150)
    p.add_argument("--max_lr", type=float, default=3e-4)
    p.add_argument("--mixup_pct", type=float, default=0.33)
    p.add_argument("--prior_scale", type=float, default=30.0)
    p.add_argument("--n_blocks", type=int, default=4)
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--hidden_dim", type=int, default=4096)
    p.add_argument("--lr_scheduler_type", type=str, default="cycle",
                   choices=["cycle", "linear", "cosine"])
    p.add_argument("--ckpt_saving", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--resume_from_ckpt", action="store_true",
                   help="resume params, optimizer state and epoch from the "
                        "*_last checkpoint")


def _add_fastpath_args(p):
    """Opt-in approximate sampler fast paths; the default is exact
    sampling."""
    p.add_argument("--fast", choices=sorted(FAST_PRESETS), default=None,
                   help="named fast preset expanding to the TGATE x PAB "
                        "knobs (config.FAST_PRESETS); explicit "
                        "--tgate/--tgate_pab flags override")
    p.add_argument("--tgate", type=int, default=0, metavar="STEP",
                   help="TGATE: freeze cross-attn + collapse CFG from "
                        "this step (0 = off)")
    p.add_argument("--tgate_pab", type=int, default=0, metavar="K",
                   help="with --tgate: also broadcast spatial(/temporal) "
                        "attention in the gated phase, recomputing every "
                        "K-th step")
    p.add_argument("--encoder_reuse", type=int, default=1, metavar="K",
                   help="recompute the UNet encoder every K-th step "
                        "(1 = off)")
    p.add_argument("--pab", type=str, default=None, metavar="I1,I2[,I3]",
                   help="Pyramid Attention Broadcast recompute intervals "
                        "(stage 3: spatial,cross; stage 5: "
                        "spatial,temporal,cross); nested")
    p.add_argument("--pab_range", type=str, default=None, metavar="LO,HI",
                   help="restrict PAB broadcasting to steps [LO, HI)")
    p.add_argument("--deep_cache", type=int, default=0, metavar="N",
                   help="DeepCache (stage 3): the full UNet every N-th "
                        "step, the level-0 path in between (0 = off)")


def _parse_ints(s):
    return tuple(int(v) for v in s.split(",")) if s else None


def _apply_fast_preset(args, stage):
    """Expand --fast into the stage's knobs without overriding a knob the
    user set. Re-entrant across stages: `pipeline` reuses one namespace, so
    knobs an earlier stage's expansion set are expanded again, not taken
    for the user's."""
    name = getattr(args, "fast", None)
    if not name:
        return
    if not (getattr(args, "tiny", False) or getattr(args, "synthetic",
                                                    False)):
        print(f"--- --fast {name}: the preset's deviation budget was "
              "measured on random-weight UNets; re-score it on real "
              "weights ---", flush=True)
    preset_owned = getattr(args, "_preset_knobs", set())
    for knob, value in FAST_PRESETS[name][stage].items():
        if not getattr(args, knob, 0) or knob in preset_owned:
            setattr(args, knob, value)
            preset_owned.add(knob)
    args._preset_knobs = preset_owned


def _setup(args):
    _CMD_T0[:] = [time.perf_counter()]
    if args.tiny or args.synthetic:
        # synthetic paths may tokenize without the CLIP BPE merges file;
        # real runs raise instead (data/clip_tokenizer.py)
        os.environ.setdefault("NEURONS_TPU_ALLOW_BYTE_TOKENIZER", "1")
    if getattr(args, "debug_nans", False):
        import torch
        torch.autograd.set_detect_anomaly(True, check_nan=True)


def _configs(args, stage2: bool = False):
    from neurons_tpu_torch import config as C

    if args.tiny:
        bcfg = C.BrainModelConfig(hidden_dim=32, n_blocks=1, clip_seq_dim=16,
                                  clip_emb_dim=32, clip_txt_emb_dim=24,
                                  subjects=(args.subj,))
        pcfg = C.PriorConfig(dim=32, depth=1, dim_head=8, heads=4,
                             num_tokens=16, timesteps=5)
        dcfg = C.DecouplerConfig(n_frames=2, num_classes=51, clip_emb_dim=32,
                                 clip_txt_emb_dim=24,
                                 decoder_block_out_channels=(8, 8, 8))
    else:
        bcfg = C.BrainModelConfig(hidden_dim=args.hidden_dim,
                                  n_blocks=args.n_blocks,
                                  subjects=(args.subj,))
        pcfg = C.PriorConfig()
        dcfg = C.DecouplerConfig(n_frames=args.n_frames)
    tcfg = C.TrainConfig(
        subj=args.subj, batch_size=args.batch_size,
        num_epochs=args.num_epochs, max_lr=args.max_lr,
        mixup_pct=args.mixup_pct, prior_scale=args.prior_scale,
        lr_scheduler_type=args.lr_scheduler_type,
        neurons_decoupler=stage2, n_frames=args.n_frames, seed=args.seed,
        ckpt_saving=args.ckpt_saving,
        num_train_samples=32 if args.synthetic else 4320,
        num_test_samples=(max(16, getattr(args, "n_test", 0))
                          if args.synthetic else 1200))
    return bcfg, pcfg, dcfg, tcfg


def _gpt2_config(args):
    from neurons_tpu_torch.models.gpt2 import GPT2Config, tiny_gpt2_config
    return tiny_gpt2_config() if args.tiny else GPT2Config()


def _loop_start(stage: str) -> float:
    """Anchor a stage loop's clock and report the stage's setup time
    (artifact load, weights, model build) before its first batch."""
    t0 = time.perf_counter()
    if _CMD_T0:
        _SETUP_S[stage] = t0 - _CMD_T0[0]
        print(f"--- stage {stage}: setup {_SETUP_S[stage]:.1f}s, "
              f"loop start ---", flush=True)
    return t0


def _watchdog(stage: str, marks, done: int, el: float) -> None:
    """Call before appending a batch's mark: a batch over 5x the rolling
    median of the last 50 (and over 60 s) prints a line and is recorded
    in the stage's `stall_events`."""
    if len(marks) < 4:
        return
    tail = marks[-51:]
    recent = [b[1] - a[1] for a, b in zip(tail, tail[1:])]
    dt = el - marks[-1][1]
    med = statistics.median(recent)
    if dt <= max(60.0, 5.0 * med):
        return
    _STALL_EVENTS.setdefault(stage, []).append(
        {"clips_done": done, "batch_s": round(dt, 1),
         "rolling_median_s": round(med, 2)})
    print(f"!!! stage {stage} WATCHDOG: batch ending at clip {done} "
          f"took {dt:.1f}s (rolling median {med:.1f}s)", flush=True)


def _record_steady(stage: str, marks, batch: int, t0: float | None = None):
    """marks: [(clips done, elapsed s)] a batch, cumulative. The steady
    rate leaves out the first batch, which carries the warm-up; long runs
    also get their first- and last-100-clip rates."""
    n_done, t_total = marks[-1]
    t_first = marks[0][1]
    if n_done > batch:
        steady = (t_total - t_first) / (n_done - batch)
    else:
        steady = t_total / max(n_done, 1)
    stats = {"steady_s_per_clip": round(steady, 3), "batch": batch,
             "first_batch_s": round(t_first, 2)}
    win = 100
    if n_done - batch >= 2 * win:
        first = next(m for m in marks if m[0] >= batch + win)
        stats["first100_s_per_clip"] = round(
            (first[1] - t_first) / (first[0] - batch), 3)
        last_base = next(m for m in reversed(marks) if n_done - m[0] >= win)
        stats["last100_s_per_clip"] = round(
            (t_total - last_base[1]) / (n_done - last_base[0]), 3)
    if stage in _SETUP_S:
        stats["setup_s"] = round(_SETUP_S.pop(stage), 2)
    if stage in _STALL_EVENTS:
        stats["stall_events"] = _STALL_EVENTS.pop(stage)
    if t0 is not None:
        stats["post_loop_drain_s"] = round(
            time.perf_counter() - t0 - t_total, 2)
    _STAGE_STATS[stage] = stats
    print(f"--- stage {stage}: {json.dumps(stats)} ---", flush=True)


def _stage_dtype(args):
    import torch
    name = args.dtype or ("f32" if args.tiny else "bf16")
    return torch.bfloat16 if name == "bf16" else torch.float32


def _test_clip_count(args, available: int) -> int:
    """How many test clips a generation stage processes: --n_test when
    given; otherwise 4 in the smoke modes, or the whole split."""
    n = getattr(args, "n_test", 0)
    if not n:
        n = 4 if (args.synthetic or args.tiny) else available
    return max(1, min(n, available))


def _module(args, build, dev, dt, seed: int, params=None, strict=True):
    """A stage's module on `dev` in `dt`. With `params` (a flax-layout
    tree) it is allocated uninitialised and filled (`strict=False`: seeded
    random weights first, then the tree laid over them, the JAX package's
    `restore_into`); without, seeded random weights (`synth_params_`). At
    full width the module is built on the meta device, so no host copy of
    it is ever made."""
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.interop.from_jax import load_jax_params
    from neurons_tpu_torch.utils.synth_init import synth_params_

    if args.tiny:
        module = build(device=dev, dtype=dt).eval()
    else:
        module = LW.materialize(build, dev, dt)
    if params is None or not strict:
        synth_params_(module, seed, host=args.tiny)
    if params is not None:
        load_jax_params(module, params, strict=strict)
    return module


def _timed_load(name: str, paths, fn):
    """Run a weight bundle's loader and record its seconds, file bytes and
    the host's resident set size before it and at its peak while it ran."""
    from neurons_tpu_torch.interop import load_weights as LW
    t0 = time.perf_counter()
    with LW.RssPeak() as rss:
        out = fn()
    stats = {"seconds": round(time.perf_counter() - t0, 3),
             "bytes": LW.file_bytes(*paths),
             "rss_before_bytes": rss.before, "peak_rss_bytes": rss.peak}
    _LOAD_STATS[name] = stats
    print(f"--- loaded {name}: {stats['seconds']} s, "
          f"{stats['bytes'] / 1e9:.3f} GB of files, host RSS "
          f"{rss.before / 2**30:.2f} GiB before, peak "
          f"{rss.peak / 2**30:.2f} GiB ---", flush=True)
    return out


def _core_overlay(bcfg, tree):
    """A partial flax tree of NeuronsCore -> {core parameter name: tensor}."""
    import torch
    from neurons_tpu_torch.interop.from_jax import jax_named_tensors
    from neurons_tpu_torch.models.neurons import NeuronsCore

    if tree is None:
        return None
    with torch.device("meta"):
        core = NeuronsCore(bcfg)
    return jax_named_tensors(core, tree)


def _warm_start_overlay(args, bcfg):
    """The reference's warm-start layers of both training stages, as a
    partial NeuronsCore tree: the MindEye2 `last.pth` mixer backbone from
    --weights_dir and the frozen `coco_tokens_avg_proj.pth` clipproj from
    --root_dir; None when neither file exists."""
    from neurons_tpu_torch.interop.load_weights import _torch_load
    from neurons_tpu_torch.interop.torch_import import (
        import_coco_clipproj, import_mindeye_backbone)
    from neurons_tpu_torch.utils.checkpoint import merge_overlays

    layers = []
    mindeye = os.path.join(args.weights_dir, "last.pth")
    if os.path.exists(mindeye):
        sd = _torch_load(mindeye)
        sd = sd.get("model_state_dict", sd)
        overlay, unused = import_mindeye_backbone(sd, n_blocks=bcfg.n_blocks)
        layers.append(overlay)
        print(f"--- MindEye2 backbone warm start ({len(unused)} "
              f"unused keys) ---")
    coco = os.path.join(args.root_dir, "coco_tokens_avg_proj.pth")
    if os.path.exists(coco):
        proj, _ = import_coco_clipproj(_torch_load(coco))
        layers.append({"clipproj": proj})
        print("--- loaded coco_tokens_avg_proj clipproj ---")
    return merge_overlays(*layers)


def _load_decoupler_params(args, model, bcfg, pcfg, gcfg):
    """Overlay the trained decoupler onto `model` (a NeuronsDecoupler, in
    place): the EXP tree's stage-2 checkpoint if present
    (`utils/checkpoint.load_decoupler_params`, which raises on a mid-run
    save without its frozen core), else the reference's released torch
    ensemble `brain_model_prior_last.pth`."""
    from neurons_tpu_torch.interop.from_jax import load_jax_params
    from neurons_tpu_torch.interop.load_weights import _torch_load
    from neurons_tpu_torch.interop.torch_import import import_neurons_ensemble
    from neurons_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt_dir = os.path.join(args.exp_dir, f"exp_{args.exp}", "checkpoints")
    torch_ckpt = os.path.join(args.weights_dir, "brain_model_prior_last.pth")
    if ckpt_lib.exists(ckpt_dir, "brain_model_prior_last"):
        ckpt_lib.load_decoupler_params(ckpt_dir, model)
    elif os.path.exists(torch_ckpt):
        def load():
            sd = _torch_load(torch_ckpt)
            sd = sd.get("model_state_dict", sd.get("state_dict", sd))
            imported, unused = import_neurons_ensemble(
                sd, n_blocks=bcfg.n_blocks, prior_depth=pcfg.depth,
                gpt2_layers=gcfg.n_layer)
            load_jax_params(model, imported, strict=False)
            return unused

        unused = _timed_load("brain_model_prior_last.pth", [torch_ckpt],
                             load)
        print(f"--- imported reference torch ensemble "
              f"({len(unused)} unused keys) ---")
    return model


def _load_data(args, bcfg, tcfg, train=True):
    from neurons_tpu_torch.data import cc2017

    if args.synthetic:
        n = tcfg.num_train_samples if train else tcfg.num_test_samples
        return cc2017.synthetic_split(
            n=n, n_voxels=bcfg.voxel_counts[0], n_frames=6,
            img=32 if args.tiny else 224,
            txt_dim=bcfg.clip_txt_emb_dim, n_classes=51,
            seed=args.seed, train=train)
    return cc2017.load_split(args.root_dir, args.subj, train)


def _class_embeds(args, dcfg):
    """The [51, 1280] class-name CLIP table `class_text_embeds.npy`; random
    in the smoke modes, else its absence raises."""
    import numpy as np

    class_table = os.path.join(args.root_dir, "class_text_embeds.npy")
    if os.path.exists(class_table):
        print("--- using precomputed class text embeds ---")
        return np.load(class_table).astype(np.float32)
    if not (args.tiny or args.synthetic):
        raise FileNotFoundError(
            f"{class_table} missing; precompute the class-name table first")
    return np.random.default_rng(0).normal(
        size=(dcfg.num_classes, dcfg.clip_txt_emb_dim)).astype(np.float32)


def cmd_train_brain(args):
    """Stage 1: the core (`training/loop.py:run_stage1`)."""
    _setup(args)
    import numpy as np
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.parallel import create_mesh
    from neurons_tpu_torch.training.loop import run_stage1

    dev = resolve_device(args.platform)
    mesh = create_mesh(dev)
    bcfg, _, _, tcfg = _configs(args)
    train_split = _load_data(args, bcfg, tcfg, train=True)
    test_split = _load_data(args, bcfg, tcfg, train=False)
    if args.synthetic:
        g = np.random.default_rng(args.seed)
        ct_train = g.normal(size=(len(train_split), 6, bcfg.clip_seq_dim,
                                  bcfg.clip_emb_dim)).astype(np.float32)
        ct_test = g.normal(size=(len(test_split), 6, bcfg.clip_seq_dim,
                                 bcfg.clip_emb_dim)).astype(np.float32)
    else:
        ct_train = np.load(os.path.join(
            args.root_dir, "clip_targets_train.npy"), mmap_mode="r")
        ct_test = np.load(os.path.join(
            args.root_dir, "clip_targets_test.npy"), mmap_mode="r")
    ckpt_dir = os.path.join(args.exp_dir, f"exp_{args.exp}", "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    t0 = time.perf_counter()
    run_stage1(bcfg, tcfg, train_split, test_split, ct_train, ct_test,
               ckpt_dir=ckpt_dir, resume=args.resume_from_ckpt,
               warm_start_params=_core_overlay(
                   bcfg, _warm_start_overlay(args, bcfg)),
               host_draws=args.tiny, device=dev, mesh=mesh)
    _STAGE_STATS["1"] = {"train_s": round(time.perf_counter() - t0, 2)}
    print("=== stage 1 finished ===")


def cmd_train_decoupler(args):
    """Stage 2: the decoupler heads over the frozen core
    (`training/loop.py:run_stage2`). The core comes from stage 1's
    `brain_model` (else `brain_model_last`, else the reference's
    `brain_model.pth` in the checkpoint directory), under the warm-start
    layers; the batches from the precomputed tables under --root_dir, or
    random ones with --synthetic."""
    _setup(args)
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.interop.load_weights import _torch_load
    from neurons_tpu_torch.interop.torch_import import import_neurons_core
    from neurons_tpu_torch.parallel import create_mesh
    from neurons_tpu_torch.training.loop import (run_stage2,
                                                 synthetic_stage2_batch_builder,
                                                 table_stage2_batch_builder)
    from neurons_tpu_torch.utils import checkpoint as ckpt_lib

    dev = resolve_device(args.platform)
    mesh = create_mesh(dev)
    bcfg, pcfg, dcfg, tcfg = _configs(args, stage2=True)
    gcfg = _gpt2_config(args)
    train_split = _load_data(args, bcfg, tcfg, train=True)
    ckpt_dir = os.path.join(args.exp_dir, f"exp_{args.exp}", "checkpoints")
    core = ckpt_lib.load_stage1_core(ckpt_dir)
    torch_core = os.path.join(ckpt_dir, "brain_model.pth")
    if core is None and os.path.exists(torch_core):
        sd = _torch_load(torch_core)
        sd = sd.get("model_state_dict", sd)
        tree, unused = import_neurons_core(sd, n_blocks=bcfg.n_blocks)
        core = _core_overlay(bcfg, tree)
        print(f"--- imported torch brain_model.pth core "
              f"({len(unused)} unused keys) ---")
    # the reference's order: MindEye2 backbone, the stage-1 core over it,
    # then the frozen coco clipproj over everything
    warm = _warm_start_overlay(args, bcfg)
    if warm is not None:
        warm_t = _core_overlay(bcfg, warm)
        clipproj = {n: v for n, v in warm_t.items()
                    if n.startswith("clipproj.")}
        core = {**warm_t, **(core or {}), **clipproj}
    tables = os.path.exists(
        os.path.join(args.root_dir, "clip_targets_train.npy"))
    if tables and not args.synthetic:
        builder = table_stage2_batch_builder(args.root_dir, dcfg,
                                             gcfg.vocab_size)
        print("--- using precomputed frozen-encoder tables ---")
    else:
        builder = synthetic_stage2_batch_builder(bcfg, dcfg, gcfg.vocab_size,
                                                 args.seed)
    os.makedirs(ckpt_dir, exist_ok=True)
    t0 = time.perf_counter()
    run_stage2(bcfg, pcfg, dcfg, tcfg, gcfg, train_split, builder,
               core_params=core, ckpt_dir=ckpt_dir,
               resume=args.resume_from_ckpt, host_draws=args.tiny,
               device=dev, mesh=mesh)
    _STAGE_STATS["2"] = {"train_s": round(time.perf_counter() - t0, 2)}
    print("=== stage 2 finished ===")


def _stage3_models(args, dev, dt, bcfg, pcfg, dcfg, gcfg, ucfg, vcfg):
    """Stage 3's decoupler, unCLIP UNet and VAE on `dev` in `dt`."""
    import functools

    from neurons_tpu_torch.interop.load_weights import load_unclip_engine
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL

    unclip_ckpt = os.path.join(args.weights_dir,
                               "unclip6_epoch0_step110000.ckpt")
    if not (os.path.exists(unclip_ckpt) or args.tiny or args.synthetic):
        raise FileNotFoundError(f"{unclip_ckpt} missing")
    dec = _module(args, functools.partial(NeuronsDecoupler, bcfg, pcfg, dcfg,
                                          gcfg), dev, dt, args.seed)
    _load_decoupler_params(args, dec, bcfg, pcfg, gcfg)
    build_unet = functools.partial(UNetModel, ucfg)
    build_vae = functools.partial(AutoencoderKL, vcfg)
    if os.path.exists(unclip_ckpt):
        def load():
            up, vp, rep = load_unclip_engine(unclip_ckpt, ucfg, vcfg)
            return (_module(args, build_unet, dev, dt, args.seed + 1, up),
                    _module(args, build_vae, dev, dt, args.seed + 2, vp), rep)

        unet, vae, rep = _timed_load("unclip engine", [unclip_ckpt], load)
        print(f"--- loaded unclip engine ({rep.get('ema_swapped', 0)} EMA "
              f"tensors swapped, {len(rep['unet_unused'])} unused) ---")
    else:
        unet = _module(args, build_unet, dev, dt, args.seed + 1)
        vae = _module(args, build_vae, dev, dt, args.seed + 2)
    return dec, unet, vae


def cmd_recon(args):
    """Stage 3: keyframes, blurry videos and caption ids of the test
    clips (`pipelines/keyframe.py:reconstruct_keyframes`), saved in the
    reference's artifact dialect (recons at 256 px, blurry frames at 224
    px, torchvision-0.16 bilinear)."""
    _setup(args)
    _apply_fast_preset(args, "recon")
    import numpy as np
    import torch
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.config import SamplerConfig, UNet2DConfig, VAEConfig
    from neurons_tpu_torch.ops.resize import resize_reference
    from neurons_tpu_torch.pipelines import io
    from neurons_tpu_torch.pipelines.keyframe import (decode_blurry_video,
                                                      draw_keyframe_noise,
                                                      reconstruct_keyframes)
    from neurons_tpu_torch.utils.prng import stage_generator

    dev = resolve_device(args.platform)
    bcfg, pcfg, dcfg, tcfg = _configs(args, stage2=True)
    gcfg = _gpt2_config(args)
    test_split = _load_data(args, bcfg, tcfg, train=False)
    if args.tiny:
        ucfg = UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                            num_res_blocks=1, transformer_depth=(1, 1),
                            num_head_channels=4, context_dim=bcfg.clip_emb_dim,
                            adm_in_channels=1024, attention_resolutions=(2,))
        vcfg = VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                         norm_num_groups=4)
        scfg = SamplerConfig(unclip_steps=3, prior_steps=4)
        latent_hw = 8
    else:
        ucfg, vcfg, scfg, latent_hw = (UNet2DConfig(), VAEConfig(),
                                       SamplerConfig(), 96)
    # the files are checked before any model is built
    class_embeds = torch.from_numpy(_class_embeds(args, dcfg)).to(dev)
    dt = _stage_dtype(args)
    dec, unet, vae = _stage3_models(args, dev, dt, bcfg, pcfg, dcfg, gcfg,
                                    ucfg, vcfg)

    n_total = _test_clip_count(args, test_split.voxel.shape[0])
    bs = 4 if (args.tiny or args.synthetic) else args.batch_size
    bs = max(1, min(bs, n_total))
    f = dcfg.n_frames
    opts = dict(tgate_step=args.tgate, tgate_pab=args.tgate_pab,
                encoder_reuse=args.encoder_reuse, pab=_parse_ints(args.pab),
                pab_range=_parse_ints(args.pab_range),
                deep_cache=args.deep_cache)
    all_recons, all_blurry, all_caps = [], [], []
    marks = []
    t0 = _loop_start("3")
    for i in range(0, n_total, bs):
        vox = torch.from_numpy(np.asarray(
            test_split.voxel[i:min(i + bs, n_total), :1], np.float32))
        noise = draw_keyframe_noise(
            vox.shape[0], bcfg.clip_seq_dim, bcfg.clip_emb_dim,
            scfg.prior_steps, latent_hw, stage_generator(args.seed, "3", i))
        out = reconstruct_keyframes(
            dec, unet, vae, vox, class_text_embeds=class_embeds,
            sampler_cfg=scfg, latent_hw=latent_hw, enhance=args.enhance,
            caption_len=12 if args.tiny else 60, noise=noise,
            sampler_opts=opts, device=dev)
        blurry = decode_blurry_video(vae, out.blurry_latents, f)
        recons = out.keyframes
        if not args.tiny:
            # the reference saves recons at 256 px and blurry frames at
            # 224 px, through torchvision-0.16 bilinear (ops/resize.py)
            recons = resize_reference(recons, (256, 256))
            if blurry.shape[-1] != 224:
                blurry = resize_reference(blurry, (224, 224))
        all_recons.append(recons.float().cpu().numpy())
        all_blurry.append(blurry.float().cpu().numpy())
        all_caps.extend(f"tokens:{list(map(int, c[:8]))}"
                        for c in out.captions.cpu())
        done = min(i + bs, n_total)
        el = time.perf_counter() - t0
        _watchdog("3", marks, done, el)
        marks.append((done, el))
        print(f"--- stage 3: {done}/{n_total} clips "
              f"({el / done:.2f} s/clip) ---", flush=True)
    _record_steady("3", marks, bs, t0)

    out_dir = io.stage3_dir(args.exp_dir, args.exp, args.subj, args.enhance)
    io.save_stage3_artifacts(
        out_dir, args.subj, all_recons=np.concatenate(all_recons, 0),
        all_gts=np.asarray(test_split.images[:n_total, 2]),
        captions=all_caps, blurry_videos=np.concatenate(all_blurry, 0))
    print(f"=== stage 3 finished -> {out_dir} ===")


def cmd_caption(args):
    """Stage 4: BLIP-2 captions of the stage-3 keyframes."""
    _setup(args)
    import numpy as np
    import torch

    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.interop.torch_import import (import_blip2,
                                                        load_torch_checkpoint)
    from neurons_tpu_torch.models.blip2 import Blip2Captioner, Blip2Config
    from neurons_tpu_torch.pipelines import io
    from neurons_tpu_torch.pipelines.e2e import resize_linear
    from neurons_tpu_torch.utils.synth_init import synth_params_

    dev = resolve_device(args.platform)
    cfg = Blip2Config.tiny() if args.tiny else Blip2Config()
    hw = cfg.vision.image_size

    st3 = io.stage3_dir(args.exp_dir, args.exp, args.subj, args.enhance)
    try:
        art = io.load_stage3_artifacts(st3, args.subj)
        imgs = np.asarray(art["all_recons"], np.float32)
    except FileNotFoundError:
        if not args.synthetic:
            raise
        imgs = np.random.default_rng(args.seed).uniform(
            size=(4, 3, hw, hw)).astype(np.float32)

    # the model is allocated on the device in the stage's dtype (3.74 B
    # params at full width: 7.5 GB in bf16), never as an f32 copy
    dt = _stage_dtype(args)
    model = Blip2Captioner(cfg, device="meta", dtype=dt).to_empty(device=dev)
    wfile = os.path.join(args.weights_dir, "blip2-opt.pt")
    if os.path.exists(wfile):
        sd = torch.load(wfile, map_location="cpu")
        unused = load_torch_checkpoint(model, import_blip2,
                                       sd.get("state_dict", sd), cfg,
                                       allow_unused=True)
        if unused:
            print(f"--- blip2 import: {len(unused)} unused keys ---")
    else:
        if not (args.tiny or args.synthetic):
            raise FileNotFoundError(
                f"{wfile} not found; run with --tiny/--synthetic or place "
                "the HF blip2-opt state dict there")
        synth_params_(model, seed=args.seed, host=args.tiny)
    model.eval()

    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073],
                        device=dev).view(3, 1, 1)
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711],
                       device=dev).view(3, 1, 1)

    def _prep(chunk):  # host [b, 3, H, W] -> normalised [b, 3, hw, hw]
        x = torch.as_tensor(chunk, dtype=torch.float32, device=dev)
        if x.shape[-2:] != (hw, hw):
            x = resize_linear(x, hw)
        return ((x - mean) / std).to(dt)

    max_len = 8 if args.tiny else 30
    toks = []
    bs = 8
    t0 = _loop_start("4")
    marks = []
    n_imgs = imgs.shape[0]
    with torch.inference_mode():
        for i in range(0, n_imgs, bs):
            chunk = imgs[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:  # one batch shape: the ragged tail repeats its last image
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, 0)], 0)
            out = model.generate(_prep(chunk), max_len=max_len)
            toks.append(out.cpu().numpy()[:bs - pad])
            done = min(i + bs, n_imgs)
            el = time.perf_counter() - t0
            _watchdog("4", marks, done, el)
            marks.append((done, el))
            if done % 64 < bs or done == n_imgs:
                print(f"--- stage 4: {done}/{n_imgs} clips "
                      f"({marks[-1][1] / done:.2f} s/clip) ---", flush=True)
    toks = np.concatenate(toks, 0)
    _record_steady("4", marks, bs, t0)

    try:  # decode with the OPT tokenizer when its files are cached
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained("facebook/opt-2.7b",
                                            local_files_only=True)
        captions = [tok.decode(t, skip_special_tokens=True).strip()
                    for t in toks]
    except Exception:
        # without the tokenizer, raw ids would silently become the stage-5
        # prompts: refuse unless asked for
        if not (args.tiny or args.synthetic
                or args.allow_raw_token_captions):
            raise RuntimeError(
                "facebook/opt-2.7b tokenizer not cached: captions cannot "
                "be decoded to text. Cache the tokenizer or pass "
                "--allow_raw_token_captions to write raw 'ids:...' "
                "strings (stage 5/6 will consume them as prompts).")
        print("WARNING: no OPT tokenizer — writing raw token-id captions")
        captions = ["ids:" + ",".join(map(str, t)) for t in toks]

    io.save_caption_artifact(st3, captions)
    print(f"=== stage 4 finished -> {st3}/pred_test_caption.pt ===")


def _stage5_models(args, dev, dt, u3, vcfg, n_frames):
    """Stage 5's UNet3D, SparseCtrl and VAE on `dev` in `dt`: the
    reference's bundle (the SD-1.5 base, the motion module, the optional
    domain-adapter LoRA, SparseCtrl) when `v3_sd15_mm.ckpt` is in
    --weights_dir."""
    import functools

    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    from neurons_tpu_torch.models.vae import AutoencoderKL

    build_u = functools.partial(UNet3DModel, u3, n_frames=n_frames)
    build_c = functools.partial(SparseControlNetModel, u3, n_frames=n_frames)
    build_v = functools.partial(AutoencoderKL, vcfg)
    w = lambda f: os.path.join(args.weights_dir, f)  # noqa: E731
    mm_path = w("v3_sd15_mm.ckpt")
    if not os.path.exists(mm_path):
        # seeded random weights; the zero-initialised heads (conv_out, the
        # motion modules' proj_out) get weights too, so no eps is zero
        return (_module(args, build_u, dev, dt, args.seed + 3),
                _module(args, build_c, dev, dt, args.seed + 4),
                _module(args, build_v, dev, dt, args.seed + 5))
    base = w("realisticVisionV60B1_v51VAE.safetensors")
    if not os.path.exists(base):
        base = w("sd-v1-5.ckpt")
    lora = w("v3_sd15_adapter.ckpt")
    lora = lora if os.path.exists(lora) else None

    def load_unet():
        params, rep = LW.load_animatediff_unet3d(base, mm_path, u3,
                                                 lora_path=lora)
        return _module(args, build_u, dev, dt, args.seed + 3, params), rep

    unet, rep = _timed_load("AnimateDiff UNet3D", [base, mm_path, lora],
                            load_unet)
    print(f"--- loaded AnimateDiff UNet3D "
          f"({len(rep['spatial_unused'])}+{len(rep['motion_unused'])} "
          f"unused) ---")
    cn_path = w("v3_sd15_sparsectrl_rgb.ckpt")
    cn = _timed_load("SparseCtrl", [cn_path], lambda: _module(
        args, build_c, dev, dt, args.seed + 4,
        LW.load_sparse_controlnet(cn_path, u3)[0]))
    vae = _timed_load("SD VAE", [base], lambda: _module(
        args, build_v, dev, dt, args.seed + 5, LW.load_sd_vae(base, vcfg)[0]))
    return unet, cn, vae


def _caption_embeddings(args, dev, captions, sel):
    """The SD-1.5 CLIP text tower's last hidden states [len(sel), 77, 768]
    of the selected captions (f32, 128 prompts a chunk, on the host), or
    None when the base checkpoint is absent."""
    import functools

    import numpy as np
    import torch
    from neurons_tpu_torch.data.clip_tokenizer import tokenize
    from neurons_tpu_torch.interop.load_weights import load_sd_text_encoder
    from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower

    base = os.path.join(args.weights_dir,
                        "realisticVisionV60B1_v51VAE.safetensors")
    if not os.path.exists(base):
        base = os.path.join(args.weights_dir, "sd-v1-5.ckpt")
    if not os.path.exists(base):
        return None
    tcfg_clip = CLIPTextConfig.sd15()
    # SD's text encoder has no text_projection: the imported weights are
    # laid over seeded random ones (the unused pooled path keeps them)
    tower = _timed_load("SD text encoder", [base], lambda: _module(
        args, functools.partial(CLIPTextTower, tcfg_clip), dev,
        torch.float32, args.seed + 6,
        load_sd_text_encoder(base, tcfg_clip.layers)[0], strict=False))
    toks = np.zeros((len(sel), 77), np.int64)
    for i, c in enumerate([captions[int(s)] for s in sel]):
        t = tokenize([c], context_length=77)[0]
        toks[i, :len(t)] = t
    chunks = []
    with torch.inference_mode():
        for s in range(0, len(toks), 128):
            last, _ = tower(torch.from_numpy(toks[s:s + 128]).to(dev))
            chunks.append(last.float().cpu().numpy())
    print("--- caption text embeddings from SD CLIP text encoder ---")
    return np.concatenate(chunks, 0)


def cmd_video(args):
    """Stage 5: the 16-frame videos of the stage-3 artifacts
    (`pipelines/video.py:reconstruct_video`), 25-step DDIM through UNet3D
    and SparseCtrl, saved as GIFs beside the ground truth."""
    _setup(args)
    _apply_fast_preset(args, "video")
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.config import UNet3DConfig, VAEConfig
    from neurons_tpu_torch.ops.resize import resize_np
    from neurons_tpu_torch.parallel import distributed
    from neurons_tpu_torch.pipelines import io
    from neurons_tpu_torch.pipelines.e2e import resize_linear
    from neurons_tpu_torch.pipelines.video import reconstruct_video
    from neurons_tpu_torch.utils.prng import stage_generator

    dev = resolve_device(args.platform)
    if args.tiny:
        u3 = UNet3DConfig(block_out_channels=(8, 16, 16, 16),
                          layers_per_block=1, cross_attention_dim=12,
                          attention_head_dim=4, norm_num_groups=4,
                          motion_num_attention_heads=2,
                          motion_max_seq_length=8)
        vcfg = VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                         norm_num_groups=4)
        n_frames, steps, hw = 4, 3, 16
    else:
        u3, vcfg = UNet3DConfig(), VAEConfig()
        n_frames, steps, hw = 16, 25, 256
    lat_hw = hw // 2 ** (len(vcfg.block_out_channels) - 1)
    ctx_len, ctx_dim = (5 if args.tiny else 77), u3.cross_attention_dim
    mm_path = os.path.join(args.weights_dir, "v3_sd15_mm.ckpt")
    if not (os.path.exists(mm_path) or args.tiny or args.synthetic):
        raise FileNotFoundError(f"{mm_path} missing")

    # the stage-3 artifacts and the ground truth, checked before any model
    # is built
    st3 = io.stage3_dir(args.exp_dir, args.exp, args.subj, args.enhance)
    g = np.random.default_rng(args.seed)
    # round-robin clips: this process takes shard, shard + num_shards, ...
    shard, num_shards = args.shard, args.num_shards
    if num_shards == 1 and distributed.world_size() > 1:
        # inside a process group without --num_shards: the rank split (the
        # reference's `accelerate launch` semantics)
        shard, num_shards = distributed.rank(), distributed.world_size()
        print(f"--- stage 5: rank-scattered clips "
              f"{shard}::{num_shards} (process group) ---", flush=True)
    blurry = art = None
    try:
        art = io.load_stage3_artifacts(st3, args.subj,
                                       caption_mode=args.caption_mode)
        sel = distributed.round_robin_indices(len(art["all_recons"]),
                                              shard, num_shards)
        if args.tiny:
            sel = sel[:2]
        elif args.n_test:
            sel = sel[:args.n_test]
        keyframes = np.asarray(art["all_recons"][sel], np.float32)
        # the ground truth: the dataset's GT_test_3fps.pt (what the
        # reference composites into the GIFs), else stage 3's keyframes
        gts = None
        gt_vid = os.path.join(args.root_dir, "GT_test_3fps.pt")
        if os.path.exists(gt_vid):
            gv = torch.load(gt_vid, map_location="cpu",
                            weights_only=True).float().numpy()
            if gv.ndim == 5 and gv.shape[1] == 3 and gv.shape[2] != 3:
                gv = gv.transpose(0, 2, 1, 3, 4)  # [N,3,F,H,W] -> [N,F,3,H,W]
            gts = gv[sel]
        if gts is None and art["all_gts"] is not None:
            gts = art["all_gts"][sel]
            if gts.ndim == 4:           # [N, 3, H, W] single-frame GTs
                gts = gts[:, None]
        bv = art["blurry_videos"]
        if bv.ndim == 5 and bv.shape[2] == 3:  # pixel video [N, F, 3, H, W]
            blurry = np.asarray(bv[sel], np.float32)
    except FileNotFoundError:
        if not args.synthetic:
            raise
        keyframes, gts, sel = None, None, np.arange(2)
    if keyframes is None or keyframes.ndim != 4:
        keyframes = g.uniform(size=(2, 3, hw, hw)).astype(np.float32)
        gts = None
    if gts is None:
        if not (args.tiny or args.synthetic):
            raise RuntimeError(
                f"no GT source: neither {args.root_dir}/GT_test_3fps.pt "
                f"nor stage-3 all_gts found")
        gts = g.uniform(size=(int(keyframes.shape[0]), 6, 3, hw, hw)
                        ).astype(np.float32)
    if blurry is None:
        if not (args.tiny or args.synthetic):
            raise RuntimeError(
                "stage-3 blurry videos missing/malformed in "
                f"{st3}/recon_videos.pt - rerun stage 3")
        blurry = g.uniform(size=(int(keyframes.shape[0]), 6, 3, hw, hw)
                           ).astype(np.float32)

    dt = _stage_dtype(args)
    unet, cn, vae = _stage5_models(args, dev, dt, u3, vcfg, n_frames)

    # the prompts: the stage-3/4 captions through the SD-1.5 text encoder
    captions = art["captions"] if (art is not None
                                   and not args.synthetic) else []
    text = None
    if captions and not args.tiny:
        text = _caption_embeddings(args, dev, captions, sel)
    if text is None:
        text = (g.normal(size=(int(keyframes.shape[0]), ctx_len, ctx_dim))
                * 0.1).astype(np.float32)

    mode = "enhance" if args.enhance else "motion"
    out_dir = io.video_dir(args.exp_dir, args.exp, args.subj, mode)
    os.makedirs(out_dir, exist_ok=True)
    n_sel = int(keyframes.shape[0])
    vb = max(1, min(2 if args.tiny else 1, n_sel))
    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="gif")
    gts = np.asarray(gts)
    video_opts = dict(tgate_step=args.tgate, tgate_pab=args.tgate_pab,
                      encoder_reuse=args.encoder_reuse,
                      pab=_parse_ints(args.pab),
                      pab_range=_parse_ints(args.pab_range))
    phases = {"dispatch": [], "compute": [], "compose": []}
    marks = []
    t0 = _loop_start("5")
    for i in range(0, n_sel, vb):
        td = time.perf_counter()
        sl = slice(i, i + vb)
        blur_b = torch.as_tensor(blurry[sl], dtype=torch.float32, device=dev)
        if blur_b.shape[-2:] != (hw, hw):
            blur_b = resize_linear(blur_b, hw)
        kf_b = torch.as_tensor(keyframes[sl], dtype=torch.float32,
                               device=dev)
        if kf_b.shape[-2:] != (hw, hw):
            kf_b = resize_linear(kf_b, hw)
        txt_b = torch.as_tensor(text[sl], dtype=torch.float32, device=dev)
        b = kf_b.shape[0]
        noise = torch.randn((b, 4, n_frames, lat_hw, lat_hw),
                            generator=stage_generator(args.seed, "5", i))
        tc = time.perf_counter()
        out = reconstruct_video(
            unet, cn, vae, blur_b, kf_b, txt_b, torch.zeros_like(txt_b),
            num_steps=steps, n_frames=n_frames, noise=noise, device=dev,
            **video_opts)
        video = out.video.float().cpu().numpy()
        tm = time.perf_counter()
        if not args.tiny:
            # the reference's GIF frames: the first 4 dropped, then every
            # other one (16 -> 6, the 3 fps ground truth's count)
            video = video[:, 4:][:, ::2]
        for j in range(video.shape[0]):
            gt_i = gts[min(i + j, len(gts) - 1)][:video.shape[1]]
            if gt_i.shape[0] < video.shape[1]:
                reps = -(-video.shape[1] // gt_i.shape[0])
                gt_i = np.tile(gt_i, (reps, 1, 1, 1))[:video.shape[1]]
            gt_i = resize_np(np.asarray(gt_i, np.float32),
                             (video.shape[3], video.shape[4]))
            side = np.concatenate([gt_i[None], video[j][None]], axis=-1)
            org_idx = int(sel[i + j]) if i + j < len(sel) else i + j
            prompt = (str(captions[org_idx]) if len(captions) > org_idx
                      else "")
            pool.submit(io.save_video_grid, side, os.path.join(
                out_dir, io.gif_artifact_name(org_idx, prompt)))
        done = min(i + vb, n_sel)
        el = time.perf_counter() - t0
        phases["dispatch"].append(tc - td)
        phases["compute"].append(tm - tc)
        phases["compose"].append(time.perf_counter() - tm)
        _watchdog("5", marks, done, el)
        marks.append((done, el))
        print(f"--- stage 5: {done}/{n_sel} clips "
              f"({el / done:.2f} s/clip) ---", flush=True)
    pool.shutdown(wait=True)  # every GIF on disk before stage 6
    _record_steady("5", marks, vb, t0)
    if len(phases["compute"]) > 1:  # steady phases: the first batch left out
        _STAGE_STATS["5"]["phase_s_per_batch"] = {
            k: round(sum(v[1:]) / len(v[1:]), 3) for k, v in phases.items()}
    print(f"=== stage 5 finished -> {out_dir} ===")


def cmd_decoupled_eval(args):
    """Stage e: the decoupler heads on the test clips
    (`pipelines/decoupled_eval.py`): Dice against the test key-object
    masks and the thresholded multi-label scores."""
    _setup(args)
    import functools

    import numpy as np
    import torch
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.diffusion.prior import PriorNoise
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.pipelines.decoupled_eval import \
        generate_decoupled_outputs
    from neurons_tpu_torch.utils.prng import stage_generator

    dev = resolve_device(args.platform)
    bcfg, pcfg, dcfg, tcfg = _configs(args, stage2=True)
    gcfg = _gpt2_config(args)
    test_split = _load_data(args, bcfg, tcfg, train=False)
    bs = 4 if (args.tiny or args.synthetic) else args.batch_size
    bs = max(1, min(bs, test_split.voxel.shape[0]))
    # stage e scores against the TEST split's masks; the synthetic splits
    # carry masks on the train side only, which the smoke modes borrow
    gt_masks = test_split.key_obj_masks
    if gt_masks is None:
        if not (args.tiny or args.synthetic):
            raise FileNotFoundError(
                "masks/key_objects_masks_qwen_test.pt missing - stage e "
                "needs the test GT masks")
        gt_masks = _load_data(args, bcfg, tcfg, train=True).key_obj_masks
    class_embeds = torch.from_numpy(_class_embeds(args, dcfg))
    model = _module(args, functools.partial(NeuronsDecoupler, bcfg, pcfg,
                                            dcfg, gcfg), dev, torch.float32,
                    args.seed)
    _load_decoupler_params(args, model, bcfg, pcfg, gcfg)
    steps = 4 if args.tiny else 100
    gen = stage_generator(args.seed, "e", 0)
    tok = (bs, bcfg.clip_seq_dim, bcfg.clip_emb_dim)
    noise = PriorNoise(torch.randn(tok, generator=gen),
                       [torch.randn(tok, generator=gen)
                        for _ in range(steps)])
    t0 = _loop_start("e")
    out = generate_decoupled_outputs(
        model, torch.from_numpy(np.asarray(test_split.voxel[:bs, :1],
                                           np.float32)),
        class_embeds, n_frames=dcfg.n_frames, prior_steps=steps,
        caption_len=12 if args.tiny else 60,
        gt_masks=torch.from_numpy(np.asarray(gt_masks[:bs, :dcfg.n_frames],
                                             np.float32)),
        gt_cls=torch.from_numpy(np.asarray(test_split.cls_label[:bs],
                                           np.float32)),
        noise=noise, device=dev)
    scores = {k: float(getattr(out, k)) for k in
              ("dice", "cls_accuracy", "cls_precision", "cls_recall")}
    _STAGE_STATS["e"] = {
        **scores, "clips": bs, "s": round(time.perf_counter() - t0, 3),
        "setup_s": round(_SETUP_S.pop("e"), 2),
        "cls_pred": (torch.sigmoid(out.cls_logits) > 0.5).int().cpu()
        .tolist()}
    print(f"Dice: {scores['dice']:.4f}")
    print(f"cls accuracy: {scores['cls_accuracy']:.4f} "
          f"precision: {scores['cls_precision']:.4f} "
          f"recall: {scores['cls_recall']:.4f}")
    print("=== stage e finished ===")


def cmd_eval(args):
    """Stage 6: the metric report of the stage-5 GIFs."""
    _setup(args)
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.evaluation.runner import (build_metric_classifiers,
                                                     run_metrics)
    from neurons_tpu_torch.pipelines import io

    dev = resolve_device(args.platform)
    # the mode must match what stage 5 wrote
    mode = args.mode or ("enhance" if args.enhance else "motion")
    data_path = io.video_dir(args.exp_dir, args.exp, args.subj, mode)
    n_frames = 6
    gifs = sorted(f for f in os.listdir(data_path)
                  if f.endswith(".gif")) if os.path.isdir(data_path) else []
    if gifs:
        n_frames = io.load_gif(os.path.join(data_path, gifs[0])).shape[0]
    classifiers = build_metric_classifiers(args.weights_dir,
                                           num_frames=n_frames, device=dev)
    if classifiers is not None:
        print("--- semantic metrics enabled (imported classifiers) ---")
    t0 = _loop_start("6")
    report = run_metrics(data_path, classifiers=classifiers, device=dev)
    el = time.perf_counter() - t0
    _STAGE_STATS["6"] = {"clips": len(gifs),
                         "s_per_clip": el / max(len(gifs), 1),
                         "setup_s": round(_SETUP_S.pop("6"), 2)}
    print(f"--- stage 6: {json.dumps(_STAGE_STATS['6'])} ---", flush=True)
    out = os.path.join(io.exp_dir(args.exp_dir, args.exp, args.subj),
                       f"metrics_{mode}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"=== stage 6 finished -> {out} ===")


def _loaded_module(args, build, dev, dt, importer, state_dict, *iargs):
    """`build`'s module on `dev` in `dt` (built on the meta device at full
    width), filled from a reference state dict through `importer`
    (`load_torch_checkpoint`: strict both ways)."""
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.interop.torch_import import load_torch_checkpoint

    module = (build(device=dev, dtype=dt).eval() if args.tiny
              else LW.materialize(build, dev, dt))
    load_torch_checkpoint(module, importer, state_dict, *iargs)
    return module


def cmd_precompute(args):
    """The frozen-encoder tables stage 1 and 2 stream from disk
    (`data/precompute.py`), written under --root_dir: the CLIP-bigG vision
    tokens and the VAE latents of the train and test splits, and the
    class-name text table. The bigG towers and the VAE run in f32, their
    weights from `open_clip_bigG.pt` and `sd_vae.pt` in --weights_dir
    (seeded random ones under --tiny/--synthetic when a file is absent)."""
    _setup(args)
    import functools

    import numpy as np
    import torch
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.config import VAEConfig
    from neurons_tpu_torch.data import precompute as pc
    from neurons_tpu_torch.data.clip_tokenizer import tokenize
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.interop import torch_import as TI
    from neurons_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextTower,
                                               CLIPVisionConfig,
                                               CLIPVisionTower,
                                               preprocess_images)
    from neurons_tpu_torch.models.vae import AutoencoderKL

    dev = resolve_device(args.platform)
    f32 = torch.float32
    bcfg, _, _, tcfg = _configs(args)
    if args.tiny:
        vc, tc = CLIPVisionConfig.tiny(), CLIPTextConfig.tiny()
        vcfg = VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                         norm_num_groups=4)
    else:
        vc, tc, vcfg = (CLIPVisionConfig.bigG(), CLIPTextConfig.bigG(),
                        VAEConfig())
    build_vision = functools.partial(CLIPVisionTower, vc)
    build_text = functools.partial(CLIPTextTower, tc)
    build_vae = functools.partial(AutoencoderKL, vcfg)

    wfile = os.path.join(args.weights_dir, "open_clip_bigG.pt")
    vae_file = os.path.join(args.weights_dir, "sd_vae.pt")
    if not (os.path.exists(wfile) or args.tiny or args.synthetic):
        raise FileNotFoundError(f"{wfile} missing (open_clip bigG sd)")
    if os.path.exists(wfile):
        def load_towers():
            sd = LW._torch_load(wfile)
            return (_loaded_module(args, build_vision, dev, f32,
                                   TI.import_open_clip_vision, sd, vc.layers),
                    _loaded_module(args, build_text, dev, f32,
                                   TI.import_open_clip_text, sd, tc.layers))

        vision, text = _timed_load("open_clip bigG", [wfile], load_towers)
    else:
        vision = _module(args, build_vision, dev, f32, args.seed)
        text = _module(args, build_text, dev, f32, args.seed + 1)
    if os.path.exists(vae_file):
        vae = _timed_load("SD VAE", [vae_file], lambda: _module(
            args, build_vae, dev, f32, args.seed + 2,
            LW.load_sd_vae(vae_file, vcfg)[0]))
    else:
        vae = _module(args, build_vae, dev, f32, args.seed + 2)

    def tokens_fn(x):
        return vision(preprocess_images(x.to(dev), vc.image_size))[1]

    def text_fn(t):
        return text(t.to(dev))[1]

    def vae_fn(x):
        return vae.encode(x.to(dev)).mode()

    os.makedirs(args.root_dir, exist_ok=True)
    bs = 4 if args.tiny else 16
    tables = {}
    t0 = _loop_start("precompute")

    def timed(name, n_frames, fn, *fargs, **fkw):
        t = time.perf_counter()
        path = fn(*fargs, **fkw)
        tables[name] = {"frames": n_frames,
                        "s": round(time.perf_counter() - t, 3),
                        "bytes": os.path.getsize(path)}

    for train in (True, False):
        split = _load_data(args, bcfg, tcfg, train=train)
        tag = "train" if train else "test"
        images = np.asarray(split.images)
        frames = images.shape[0] * images.shape[1]
        timed(f"clip_targets_{tag}", frames, pc.precompute_clip_targets,
              images, tokens_fn,
              os.path.join(args.root_dir, f"clip_targets_{tag}.npy"),
              batch_size=bs)
        timed(f"vae_latents_{tag}", frames, pc.precompute_vae_latents,
              images, vae_fn,
              os.path.join(args.root_dir, f"vae_latents_{tag}.npy"),
              batch_size=bs)
    # ids modulo the tower's vocabulary: a no-op for CLIP's 49408, and the
    # tiny tower's 128 would otherwise see CLIP's start and end ids (JAX's
    # jnp.take fills those rows with NaN)
    timed("class_text_embeds", 0, pc.precompute_class_text_embeds,
          text_fn, lambda names: np.stack(
              [np.asarray(t[:tc.context_length]) for t in
               _pad_tokens(tokenize(names), tc.context_length)])
          % tc.vocab_size,
          os.path.join(args.root_dir, "class_text_embeds.npy"))
    _STAGE_STATS["precompute"] = {
        "setup_s": round(_SETUP_S.pop("precompute"), 2),
        "s": round(time.perf_counter() - t0, 3), "batch": bs,
        "tables": tables}
    print(f"--- precompute: {json.dumps(_STAGE_STATS['precompute'])} ---",
          flush=True)
    print(f"=== precompute finished -> {args.root_dir} ===")


def _pad_tokens(tok_list, length):
    import numpy as np
    out = []
    for t in tok_list:
        t = list(t)[:length]
        out.append(np.asarray(t + [0] * (length - len(t)), np.int32))
    return out


def _validate_configs(args):
    """(UNet2DConfig, UNet3DConfig, hw3, steps3, hw5, frames, steps5,
    n_tok): the JAX command's tiny widths, else the full ones at the proxy
    shapes the preset frontier was scored at (64^2 latents over 38 steps
    for stage 3, 32^2 latents of 16 frames over 25 steps for stage 5)."""
    from neurons_tpu_torch.config import UNet2DConfig, UNet3DConfig

    if args.tiny:
        ucfg = UNet2DConfig(model_channels=16, channel_mult=(1, 2),
                            num_res_blocks=1, attention_resolutions=(2,),
                            transformer_depth=(1, 1), num_head_channels=8,
                            context_dim=16, adm_in_channels=8)
        u3 = UNet3DConfig(block_out_channels=(16, 32),
                          down_block_types=("CrossAttnDownBlock3D",
                                            "DownBlock3D"),
                          up_block_types=("UpBlock3D",
                                          "CrossAttnUpBlock3D"),
                          layers_per_block=1, cross_attention_dim=16,
                          attention_head_dim=8, norm_num_groups=8,
                          motion_num_attention_heads=2)
        return ucfg, u3, 16, 4, 8, 4, 3, 8
    return UNet2DConfig(), UNet3DConfig(), 64, 38, 32, 16, 25, 256


def _randomize_proxy_heads(unet2d, unet3d, seed: int):
    """The heads a reference init leaves at zero, drawn as the JAX command
    draws them (normal x 0.1 for the UNet2D's transformer proj_outs, x 0.05
    for its out_conv, the UNet3D's conv_out and its motion modules'
    proj_outs; biases kept), on the CPU from `seed`. A module passed as
    None is left alone."""
    import torch
    from neurons_tpu_torch.models.unet2d import cross_attn_sites

    g = torch.Generator().manual_seed(seed)

    def draw(p, scale):
        p.copy_(torch.randn(p.shape, generator=g) * scale)

    with torch.no_grad():
        if unet2d is not None:
            for name, _ in cross_attn_sites(unet2d.cfg):
                draw(getattr(unet2d, name).proj_out.weight, 0.1)
            draw(unet2d.out_conv.weight, 0.05)
        if unet3d is not None:
            draw(unet3d.conv_out.weight, 0.05)
            for name, mod in unet3d.named_children():
                if "motion" in name:
                    draw(mod.proj_out.weight, 0.05)


def cmd_validate(args):
    """Re-score the --fast presets on the weights in --weights_dir: per
    preset and stage, the rms relative deviation and correlation of the
    final latents, fast against exact on the same draws
    (`pipelines/validate.py`), written to fastpath_validation.json there.
    Stage 3 takes `unclip6_epoch0_step110000.ckpt`, stage 5 the AnimateDiff
    bundle (`v3_sd15_mm.ckpt`, the SD-1.5 base, the optional LoRA and
    SparseCtrl); without them --synthetic/--tiny draws random weights (the
    random-weight proxy the presets were scored on), with the heads a
    reference init leaves at zero drawn too. Everything runs in f32."""
    _setup(args)
    import functools

    import torch
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.config import VAEConfig
    from neurons_tpu_torch.interop import load_weights as LW
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    from neurons_tpu_torch.pipelines import validate as V

    dev = resolve_device(args.platform)
    f32 = torch.float32
    ucfg, u3, hw3, steps3, hw5, frames, steps5, n_tok = \
        _validate_configs(args)
    w = lambda f: os.path.join(args.weights_dir, f)  # noqa: E731
    unclip_ckpt, mm_path = w("unclip6_epoch0_step110000.ckpt"), \
        w("v3_sd15_mm.ckpt")
    real3 = os.path.exists(unclip_ckpt) and not args.tiny
    real5 = os.path.exists(mm_path) and not args.tiny
    for real, path in ((real3, unclip_ckpt), (real5, mm_path)):
        if not (real or args.synthetic or args.tiny):
            raise FileNotFoundError(
                f"{path} missing (pass --synthetic for the random-weight "
                "proxy)")
    build_u2 = functools.partial(UNetModel, ucfg)
    build_u3 = functools.partial(UNet3DModel, u3, n_frames=frames)
    build_cn = functools.partial(SparseControlNetModel, u3, n_frames=frames)
    if real3:
        unet2d = _timed_load("unclip engine", [unclip_ckpt], lambda: _module(
            args, build_u2, dev, f32, args.seed + 1,
            LW.load_unclip_engine(unclip_ckpt, ucfg, VAEConfig())[0]))
    else:
        unet2d = _module(args, build_u2, dev, f32, args.seed + 1)
    if real5:
        base = w("realisticVisionV60B1_v51VAE.safetensors")
        if not os.path.exists(base):
            base = w("sd-v1-5.ckpt")
        lora = w("v3_sd15_adapter.ckpt")
        lora = lora if os.path.exists(lora) else None
        unet3d = _timed_load(
            "AnimateDiff UNet3D", [base, mm_path, lora], lambda: _module(
                args, build_u3, dev, f32, args.seed + 3,
                LW.load_animatediff_unet3d(base, mm_path, u3,
                                           lora_path=lora)[0]))
        cn_path = w("v3_sd15_sparsectrl_rgb.ckpt")
        cn = _timed_load("SparseCtrl", [cn_path], lambda: _module(
            args, build_cn, dev, f32, args.seed + 4,
            LW.load_sparse_controlnet(cn_path, u3)[0]))
    else:
        unet3d = _module(args, build_u3, dev, f32, args.seed + 3)
        cn = _module(args, build_cn, dev, f32, args.seed + 4)
    _randomize_proxy_heads(unet2d if not real3 else None,
                           unet3d if not real5 else None, args.seed + 7)

    inputs = V.draw_inputs(ucfg.context_dim, ucfg.adm_in_channels,
                           u3.cross_attention_dim, hw3, hw5, frames, n_tok,
                           args.seed)
    source3 = "real" if real3 else "random-proxy"
    source5 = "real" if real5 else "random-proxy"
    t0 = _loop_start("validate")
    presets, seconds = V.score_presets(
        unet2d, unet3d, cn, inputs, FAST_PRESETS, steps3=steps3, hw3=hw3,
        steps5=steps5, frames=frames, device=dev,
        log=lambda m: print(f"{m}  [{source3}/{source5} weights]",
                            flush=True))
    _STAGE_STATS["validate"] = {
        "setup_s": round(_SETUP_S.pop("validate"), 2),
        "s": round(time.perf_counter() - t0, 3),
        "run_s": {k: {o: round(v, 3) for o, v in d.items()}
                  for k, d in seconds.items()}}
    print(f"--- validate: {json.dumps(_STAGE_STATS['validate'])} ---",
          flush=True)
    results = {"weights_stage3": source3, "weights_stage5": source5,
               "shapes": {"stage3": [hw3, steps3],
                          "stage5": [hw5, frames, steps5]},
               "presets": presets}
    out_path = os.path.join(args.weights_dir, "fastpath_validation.json")
    try:
        os.makedirs(args.weights_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"=== validate finished -> {out_path} ===")
    except OSError as e:
        print(f"(could not write {out_path}: {e})")
    return results


def cmd_serve(args):
    """The HTTP server over the clip (`serving.py`): the pipeline
    bench_torch.py times, batches of --serve_batch clips. --fast expands
    into the BENCH_TGATE* knobs the pipeline reads, leaving any the
    environment already sets."""
    from neurons_tpu_torch import serving

    if args.tiny:
        os.environ["BENCH_TINY"] = "1"
    if args.fast:
        preset = FAST_PRESETS[args.fast]
        os.environ.setdefault("BENCH_TGATE", str(preset["recon"]["tgate"]))
        os.environ.setdefault("BENCH_TGATE_VIDEO",
                              str(preset["video"]["tgate"]))
        os.environ.setdefault("BENCH_TGATE_PAB",
                              str(preset["recon"]["tgate_pab"]))
    pipeline, n_vox = serving.build_bench_pipeline(args.serve_batch,
                                                   args.platform)
    cfg = serving.ServerConfig(host=args.host, port=args.port,
                               batch_size=args.serve_batch,
                               max_wait_ms=args.max_wait_ms)
    srv = serving.InferenceServer(pipeline, n_vox, cfg, device=args.platform)
    print(f"serving on http://{args.host}:{srv.port}  "
          f"(batch {cfg.batch_size}, n_voxels {n_vox})", flush=True)
    srv.serve_forever()


STAGES = {"1": cmd_train_brain, "2": cmd_train_decoupler, "3": cmd_recon,
          "4": cmd_caption, "5": cmd_video, "e": cmd_decoupled_eval,
          "6": cmd_eval}


def cmd_pipeline(args):
    """The stages of a stage string (a subset of 12345e6, in its order)
    in one process; each stage's row (seconds, its loop's stats, the
    device's peak memory) is printed, and written as JSON to
    NEURONS_TPU_PIPELINE_REPORT when that is set."""
    import torch

    for s in args.stages:
        if s not in STAGES:
            raise SystemExit(f"unknown stage '{s}' (use 12345e6)")
    cuda = args.platform == "cuda" and torch.cuda.is_available()
    rows = []
    for s in args.stages:
        print(f"=== pipeline: stage {s} ===", flush=True)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        STAGES[s](args)
        row = {"stage": s, "seconds": round(time.perf_counter() - t0, 2)}
        row.update(_STAGE_STATS.get(s, {}))
        if cuda:
            row["peak_device_gib"] = round(
                torch.cuda.max_memory_allocated() / 2**30, 3)
        rows.append(row)
        print(f"=== pipeline: stage {s} done in {row['seconds']}s"
              + (f", peak device memory {row['peak_device_gib']} GiB"
                 if "peak_device_gib" in row else "") + " ===", flush=True)
    report = os.environ.get("NEURONS_TPU_PIPELINE_REPORT")
    if report:
        with open(report, "w") as fh:
            json.dump(rows, fh, indent=1)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="neurons_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train-brain", help="stage 1")
    _add_common(p)
    _add_train_args(p)
    p.set_defaults(fn=cmd_train_brain)

    p = sub.add_parser("train-decoupler", help="stage 2")
    _add_common(p)
    _add_train_args(p)
    p.set_defaults(fn=cmd_train_decoupler)

    p = sub.add_parser("recon", help="stage 3")
    _add_common(p)
    _add_train_args(p)
    p.add_argument("--enhance", action="store_true")
    _add_fastpath_args(p)
    p.set_defaults(fn=cmd_recon)

    p = sub.add_parser("caption", help="stage 4")
    _add_common(p)
    p.add_argument("--enhance", action="store_true")
    p.add_argument("--allow_raw_token_captions", action="store_true",
                   help="without a cached OPT tokenizer, write raw "
                        "'ids:...' caption strings instead of failing")
    p.set_defaults(fn=cmd_caption)

    p = sub.add_parser("video", help="stage 5")
    _add_common(p)
    _add_train_args(p)
    p.add_argument("--enhance", action="store_true")
    p.add_argument("--caption_mode", type=str, default="auto",
                   choices=["auto", "self", "blip"],
                   help="prompt source: stage-3 GPT-2 captions ('self') or "
                        "stage-4 BLIP-2 captions ('blip'); 'auto' prefers "
                        "blip when present")
    p.add_argument("--shard", type=int, default=0,
                   help="round-robin clip shard index")
    p.add_argument("--num_shards", type=int, default=1)
    _add_fastpath_args(p)
    p.set_defaults(fn=cmd_video)

    p = sub.add_parser("decoupled-eval", help="stage e")
    _add_common(p)
    _add_train_args(p)
    p.set_defaults(fn=cmd_decoupled_eval)

    p = sub.add_parser("eval", help="stage 6")
    _add_common(p)
    p.add_argument("--mode", type=str, default=None,
                   help="gen_videos_{mode} to score; defaults to "
                        "'enhance' with --enhance else 'motion'")
    p.add_argument("--enhance", action="store_true")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("precompute", help="build the frozen-encoder tables "
                                          "(CLIP targets, VAE latents, "
                                          "class text embeds)")
    _add_common(p)
    _add_train_args(p)
    p.set_defaults(fn=cmd_precompute)

    p = sub.add_parser("validate", help="re-score the --fast presets' "
                       "deviation on the weights in --weights_dir (writes "
                       "fastpath_validation.json)")
    _add_common(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("serve", help="HTTP inference server over the "
                                     "voxel -> video pipeline "
                                     "(neurons_tpu_torch/serving.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--serve_batch", type=int, default=1,
                   help="the batch size requests coalesce into")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="device the pipeline runs on (default: the card)")
    p.add_argument("--fast", choices=sorted(FAST_PRESETS), default=None,
                   help="serve with a named fast preset (expands to the "
                        "BENCH_TGATE* knobs the pipeline reads; explicit "
                        "environment settings win)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("pipeline", help="run stages in sequence, e.g. "
                                        "'pipeline 12345e6'")
    p.add_argument("stages", type=str,
                   help="stage string: subset of 12345e6, in order")
    _add_common(p)
    _add_train_args(p)
    # the fast paths apply per stage: _apply_fast_preset is re-entrant
    _add_fastpath_args(p)
    p.add_argument("--enhance", action="store_true")
    p.add_argument("--mode", type=str, default=None)
    p.add_argument("--caption_mode", type=str, default="auto",
                   choices=["auto", "self", "blip"])
    p.add_argument("--allow_raw_token_captions", action="store_true")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.set_defaults(fn=cmd_pipeline)

    args = parser.parse_args(argv)
    # join the process group the environment asks for (torchrun's
    # variables; a single process joins none)
    from neurons_tpu_torch.parallel.distributed import initialize
    initialize(backend=("gloo" if getattr(args, "platform", "cuda") == "cpu"
                        else None))
    if getattr(args, "profile", None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.platform == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=activities) as prof:
            args.fn(args)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"--- profiler trace -> {path} ---")
        return 0
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
