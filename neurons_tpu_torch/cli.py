"""The staged CLI of the port: stage 4 (`caption`) and stage 6 (`eval`).

Counterpart of the `caption` and `eval` subcommands of neurons_tpu/cli.py,
with the same flags and the same artifacts:

  python -m neurons_tpu_torch.cli caption   BLIP-2 greedy captions of the
      stage-3 keyframes (batch 8, 30 tokens) -> pred_test_caption.pt
  python -m neurons_tpu_torch.cli eval      SSIM, PSNR, the frame and video
      2- and 50-way accuracies and CLIP-pcc of the stage-5 GIFs
      -> metrics_{mode}.json

Both run on the card; `--platform cpu` runs them on the CPU. `--synthetic
--tiny` runs a stage on random data at miniature widths; `--synthetic`
alone draws full-width weights on the device in the stage's dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_STAGE_STATS: dict = {}  # stage -> steady-state stats of its last loop
_CMD_T0: list = []       # set by _setup: the command's start
_SETUP_S: dict = {}


def _add_common(p):
    p.add_argument("--subj", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--exp", type=str, default="exp1")
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
    p.add_argument("--n_test", type=int, default=0,
                   help="cap the number of test clips stages 3/5 process "
                        "(caption and eval take every clip on disk)")
    p.add_argument("--dtype", type=str, default=None,
                   choices=["bf16", "f32"],
                   help="module compute dtype (default: bf16 at full "
                        "size, f32 with --tiny)")
    p.add_argument("--enhance", action="store_true")


def _setup(args):
    _CMD_T0[:] = [time.perf_counter()]


def _loop_start(stage: str) -> float:
    """Anchor a stage loop's clock and report the stage's setup time
    (artifact load, weights, model build) before its first batch."""
    t0 = time.perf_counter()
    if _CMD_T0:
        _SETUP_S[stage] = t0 - _CMD_T0[0]
        print(f"--- stage {stage}: setup {_SETUP_S[stage]:.1f}s, "
              f"loop start ---", flush=True)
    return t0


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
    if t0 is not None:
        stats["post_loop_drain_s"] = round(
            time.perf_counter() - t0 - t_total, 2)
    _STAGE_STATS[stage] = stats
    print(f"--- stage {stage}: {json.dumps(stats)} ---", flush=True)


def _stage_dtype(args):
    import torch
    name = args.dtype or ("f32" if args.tiny else "bf16")
    return torch.bfloat16 if name == "bf16" else torch.float32


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
        synth_params_(model, seed=args.seed)
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
            marks.append((done, time.perf_counter() - t0))
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="neurons_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("caption", help="stage 4")
    _add_common(p)
    p.add_argument("--allow_raw_token_captions", action="store_true",
                   help="without a cached OPT tokenizer, write raw "
                        "'ids:...' caption strings instead of failing")
    p.set_defaults(fn=cmd_caption)

    p = sub.add_parser("eval", help="stage 6")
    _add_common(p)
    p.add_argument("--mode", type=str, default=None,
                   help="gen_videos_{mode} to score; defaults to "
                        "'enhance' with --enhance else 'motion'")
    p.set_defaults(fn=cmd_eval)

    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
