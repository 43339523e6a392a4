#!/usr/bin/env python3
"""Time edited copies of csrc/flash_attn_fwd_sm90.cu (the bf16 wgmma flash
forward) against the checkout's own source on one CUDA card, at every
bf16 forward shape at d <= 128 of the paths, beside the register kernel
(csrc/flash_attn_fwd.cu) and the library's fused attention; or, with
--source flash_attn_fwd_wide_sm90, of the wide wgmma forward at every d
512 shape of the paths (a clip's and an SVD clip's VAE attention) beside
the column-split kernel it replaced (flash_fwd_wide_kernel) and the
library; or, with --source flash_attn_fwd_tf32_sm90, of the TF32 wgmma
forward at every f32 shape at d <= 128 of the paths (a validate run, a
scored clip, a seg panel, a precompute batch, the f32 stage-2 step's
forwards with the prior's bias and lse) beside the TF32 register kernel
it replaced (flash_fwd_tf32_kernel, called through its library on the
same tensors) and the library (TF32 products allowed).

    python3 tools/torch_flash_fwd_variants.py [--variant NAME OLD NEW ...]
        [--only svd,clip,gated,caption,step]
        [--source flash_attn_fwd_sm90|flash_attn_fwd_wide_sm90|
                  flash_attn_fwd_tf32_sm90]
        [--preset expf|block_a_unit|no_s|no_pv|no_transpose|... ...]
        [--check]

The wide kernel's variants are edits of its constants (kWideBK; kSGroup)
or of its code (S over the whole depth in each warpgroup, parts of the
tile walk removed), and the edits named in WIDE_PRESETS (--preset NAME):
"expf", the exponentials on expf in place of ex2.approx of one FFMA, and
"block_a_unit", a grid of one block a (query block, key part) unit in
place of at most one block an SM that deals the units among them in
turn; --check holds each variant's output at each shape to the f64 plain
version within 1.5x the bf16 plain version's error.

The TF32 kernel's presets (TF32_PRESETS) remove one part of the kernel at
a time, for what holds it: "no_s" (no S product: zero logits), "no_pv"
(no P V product), "no_transpose" (V^T left as the raw tile), "no_round_k"
(K not rounded), "no_exp" (no exponentials: the logits taken as P),
"no_bias" (the bias's global reads left out: zeros added), and
"one_stage_wait" (the producer waits for the consumers after each tile:
the ring's overlap taken away); their outputs are wrong by design.
Two edits keep the output: "int_rna" (the round to TF32 as two integer
ops in place of cvt.rna) and "bk128" (128-key tiles with two consumers at
DN <= 64); "cons2" takes two consumers (128 query rows) where the
kernel takes three (192 rows, 512 threads: DN <= 64 on large grids);
"pair3" gives the one-consumer blocks at DN <= 64 a third ring stage by
dropping the 1024-byte alignment slack (trapping where the shared memory
is not 1024-byte aligned). --consumers NAME=N adds a variant that runs
the checkout's source with N consumer warpgroups at every shape.
--only takes validate,scored,panel,precompute,step there.

Each variant is the checkout's source with every occurrence of the text
OLD (at least one) replaced by NEW, e.g. another tile, ring depth or
warpgroup count in `WgCfg`; a NAME given twice applies both edits. Every
source ("base" the checkout's own) is built with the package's nvcc
flags, all at once, into the git-ignored EXP/variants/ and loaded in place
of the package's library for `flash_attention_fwd`. Per shape the
variants run in turns (base, v1, ..., v1, base); each prints its device
time a call (`device_ms` of tools/torch_flash_ab.py) and whether its
output equals base's bit for bit; the register kernel (called through its
library at the same shape) and `scaled_dot_product_attention` are timed
once a shape the same way. A variant's `-Xptxas -v` registers and spills
are printed after the build; the last lines sum each variant's turns, the
register kernel and the library over an SVD clip, a clip, a caption batch
and a stage-2 step's forwards.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from torch_flash_ab import (FLASH_CLIP, FLASH_OTHER, FLASH_STEP,  # noqa: E402
                            device_ms)
from torch_flash_bwd_variants import build  # noqa: E402


# Named edits of csrc/flash_attn_fwd_wide_sm90.cu: [(OLD, NEW)], each OLD
# replaced wherever it occurs
WIDE_PRESETS = {
    "expf": [
        ("alpha[r] = ex2_approx(", "alpha[r] = expf("),
        ("const float x = ex2_approx(", "const float x = expf("),
        ("w[q] = exp2f(", "w[q] = expf("),
        ("p.scale_log2 = scale * 1.4426950408889634f;",
         "p.scale_log2 = scale;"),
    ],
    "block_a_unit": [
        ("kernel<<<(unsigned)grid,", "kernel<<<(unsigned)units,"),
    ],
}


# Named removals of parts of csrc/flash_attn_fwd_tf32_sm90.cu: [(OLD, NEW)]
TF32_PRESETS = {
    "no_s": [("    s_product<C>(sc, q_addr, kt);\n",
              "    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;\n")],
    "no_pv": [("    pv_product<C>(o, pa, kt + C::kTileBytes);\n",
               "    fence_regs<4 * C::PK>(&pa[0][0]);\n")],
    "no_transpose": [("      transpose_v<C>(kt + C::kTileBytes, tid);\n", "")],
    "no_round_k": [("      round_in_place<C::kTileBytes>(kt, tid);\n", "")],
    "no_exp": [("      const float e = lse ? expf(sc[i] - ms[r])\n"
                "                          : ex2_approx(fmaf(sc[i], c2, -mc[r]));",
                "      const float e = fmaf(sc[i], c2, -mc[r]);")],
    "no_bias": [("bv[i] = (br != nullptr && key < p.Tk) ? br[key] : 0.f;",
                 "bv[i] = 0.f;")],
    "int_rna": [("constexpr float kLog2e = 1.4426950408889634f;\n",
                 "constexpr float kLog2e = 1.4426950408889634f;\n\n"
                 "__device__ __forceinline__ uint32_t int_tf32(float x) {\n"
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                 "}\n"),
                ("to_tf32(", "int_tf32(")],
    "bk128": [("static constexpr int kBK = DN <= 64 ? 64 : 32;",
               "static constexpr int kBK = DN <= 64 ? (kCons == 2 ? 128 : 64)"
               " : 32;")],
    "cons2": [("constexpr int many_consumers(int dn) { return dn <= 64 ? 3 : 2; }",
               "constexpr int many_consumers(int dn) { return 2; }")],
    "pair3": [("static constexpr int kStages = kPair ? 2 : 3;",
               "static constexpr int kStages = 3;"),
              ("8 * (1 + 3 * kStages) + 1024;", "8 * (1 + 3 * kStages);"),
              ("  unsigned char* smem =\n"
               "      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);",
               "  unsigned char* smem = smem_raw;\n"
               "  if (smem_u32(smem_raw) & 1023) __trap();")],
    "one_stage_wait": [("      if (tid == 0 && t >= 1 && t - 1 + S < ntiles) {",
                        "      if (tid == 0) mbar_wait(empty + s, (t / S) & 1);\n"
                        "      if (tid == 0 && t >= 1 && t - 1 + S < ntiles) {")],
}

# (site, (B, H, Tq, Tk, D, kv heads), bias shape, lse, {path: launches}) of
# the f32 forward at d <= 128: a validate run (its f32 UNet2D, UNet3D and
# SparseCtrl), a scored clip (stage 6), a seg panel, a precompute batch of
# 16 frames (the bigG tower), the f32 stage-2 step's forwards (launches a
# step: the prior's 6, the decoder's 12, 8, 8 with lse and the seg panel's)
TF32_SHAPES = [
    ("validate 2x20x256", (2, 20, 256, 256, 64, 20), None, False,
     {"validate": 12120}),
    ("validate 1x20x256", (1, 20, 256, 256, 64, 20), None, False,
     {"validate": 1560}),
    ("validate 2x10x1024", (2, 10, 1024, 1024, 64, 10), None, False,
     {"validate": 1010}),
    ("validate 1x10x1024", (1, 10, 1024, 1024, 64, 10), None, False,
     {"validate": 260}),
    ("validate 2x10x1024x256", (2, 10, 1024, 256, 64, 10), None, False,
     {"validate": 1010}),
    ("validate 32x8x1024 d40", (32, 8, 1024, 1024, 40, 8), None, False,
     {"validate": 245}),
    ("validate 16x8x1024 d40", (16, 8, 1024, 1024, 40, 8), None, False,
     {"validate": 40}),
    ("validate 32x8x256 d80", (32, 8, 256, 256, 80, 8), None, False,
     {"validate": 245}),
    ("validate 16x8x256 d80", (16, 8, 256, 256, 80, 8), None, False,
     {"validate": 40}),
    ("vit-b frame", (1, 12, 197, 197, 64, 12), None, False, {"scored": 288}),
    ("videomae 6 frames", (1, 12, 588, 588, 64, 12), None, False,
     {"scored": 48}),
    ("clip vit-l 6 frames", (6, 16, 257, 257, 64, 16), None, False,
     {"scored": 24}),
    ("decoder 16x16 panel", (24, 1, 256, 256, 128, 1), None, False,
     {"panel": 3}),
    ("decoder 32x32 panel", (24, 1, 1024, 1024, 64, 1), None, False,
     {"panel": 2}),
    ("decoder 64x64 panel", (24, 1, 4096, 4096, 32, 1), None, False,
     {"panel": 2}),
    ("bigG 16 frames d104", (16, 16, 257, 257, 104, 16), None, False,
     {"precompute": 48}),
    ("prior (f32 step)", (10, 32, 513, 514, 52, 1), (32, 513, 514), True,
     {"step": 6}),
    ("decoder 16x16 (f32 step)", (60, 1, 256, 256, 128, 1), None, True,
     {"step": 12}),
    ("decoder 32x32 (f32 step)", (60, 1, 1024, 1024, 64, 1), None, True,
     {"step": 8}),
    ("decoder 64x64 (f32 step)", (60, 1, 4096, 4096, 32, 1), None, True,
     {"step": 8}),
]


def register_tf32_fwd(attn, q, k, v, bias, lse):
    """The TF32 register kernel (flash_fwd_tf32_kernel) at q's shape,
    called through its library on the same tensors (16-byte rows)."""
    import torch
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse_t = (torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
             if lse else None)
    strides = ((q.stride(0), q.stride(1), q.stride(2))
               + attn._kv_strides(k, h) + attn._kv_strides(v, h))
    bias_args = (None, 0, 0, 0)
    if bias is not None:
        b3, mode = attn._bias_slices(bias, b, h, tq, k.shape[2], q.dtype)
        bias_args = (b3.data_ptr(), *b3.stride()[:2], mode)
    err = attn._library("flash_attn_fwd").flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bias_args[0], None if lse_t is None else lse_t.data_ptr(), *strides,
        *bias_args[1:], b, h, tq, k.shape[2], d, d ** -0.5, 0, 16,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"register kernel failed: CUDA error {err}")
    return out


def run_tf32(args, sources):
    """The TF32 wgmma kernel's variants in turns at each f32 shape at d
    <= 128, beside the TF32 register kernel and the library."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn

    stem = "flash_attn_fwd_tf32_sm90"
    libs = build(sources, stem, r"flash_fwd_tf32_wgmma_kernel\w*?")
    libs = {name: attn._bind(lib, stem) for name, lib in libs.items()}
    forced = {}
    for spec in args.consumers:  # NAME=N: the base source, N consumers
        name, n = spec.split("=")
        forced[name] = int(n)
        libs[name] = libs["base"]
        sources = {**sources, name: sources["base"]}
    own, own_consumers = attn._library, attn.tf32_wgmma_consumers
    current = ["base"]

    def library(name):
        return libs[current[0]] if name == stem else own(name)

    def consumers(b, h, tq, d):
        n = forced.get(current[0]) or own_consumers(b, h, tq, d)
        return 2 if current[0] == "cons2" and n == 3 else n

    gen = torch.Generator("cuda").manual_seed(0)
    order = list(sources) + list(reversed(sources))
    only = set(args.only.split(","))
    sums = {}
    for site, (b, h, tq, tk, d, hkv), bshape, lse, paths in TF32_SHAPES:
        if not only & set(paths):
            continue
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, hkv, tk, d), generator=gen, device="cuda")
                for _ in range(2))
        bias = (torch.randn(bshape, generator=gen, device="cuda")
                if bshape else None)
        reps = 5 if b * h * tq * tk > 2e8 else 20
        times, ref = {}, None
        try:
            attn._library = library
            attn.tf32_wgmma_consumers = consumers
            for name in order:
                current[0] = name

                def fn():
                    return attn.flash_attention_fwd(q, k, v, bias=bias,
                                                    return_lse=lse)

                got = fn()
                got = got[0] if lse else got
                ref = got if ref is None else ref
                ms = device_ms(fn, reps)
                times.setdefault(name, []).append(ms)
                print(f"{site:26s} [{b},{h},{tq},{tk},{d}]"
                      f"{' bias' if bias is not None else ''}"
                      f"{' lse' if lse else ''} {name:14s} device {ms:.4f} "
                      f"ms; equal bits to base {torch.equal(got, ref)}",
                      flush=True)
        finally:
            attn._library = own
            attn.tf32_wgmma_consumers = own_consumers
        torch.backends.cuda.matmul.allow_tf32 = True
        kx = k.expand(b, h, tk, d).contiguous()
        vx = v.expand(b, h, tk, d).contiguous()
        times["register"] = [device_ms(
            lambda: register_tf32_fwd(attn, q, k, v, bias, lse), reps)]
        times["library"] = [device_ms(
            lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                   attn_mask=bias), reps)]
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"{site:26s} register kernel {times['register'][0]:.4f} ms, "
              f"library {times['library'][0]:.4f} ms", flush=True)
        for name, ms in times.items():
            for path, n in paths.items():
                sums.setdefault(path, {}).setdefault(name, 0.0)
                sums[path][name] += n * sum(ms) / len(ms) / 1e3
        del q, k, v, kx, vx, bias, ref, got
        torch.cuda.empty_cache()
    for path, by_name in sums.items():
        print(f"{path}: s of launches x device time (mean of turns): "
              + ", ".join(f"{name} {s:.4f}" for name, s in by_name.items()))
    return 0


def shapes(only):
    """[(group, site, (B, H, Tq, Tk, D), lse, {path: launches})]."""
    out = []
    for site, shape, n in FLASH_CLIP:
        if shape[-1] <= 128:
            out.append(("clip", site, shape, False, {"clip": n}))
    for site, shape, paths in FLASH_OTHER:
        group = ("svd" if site.startswith("svd") else "caption"
                 if site.startswith("blip2") else "gated")
        if shape[-1] <= 128:
            out.append((group, site, shape, False, paths))
    for site, (b, h, tq, tk, d, _), bias, n, _ in FLASH_STEP:
        if bias is None:  # the prior's biased forward has its own kernel
            out.append(("step", site + " (lse)", (b, h, tq, tk, d), True,
                        {"step": n}))
    return [s for s in out if s[0] in only]


def register_fwd(attn, q, k, v, lse):
    """The register kernel (flash_fwd_reg_kernel) at q's shape, called
    through its library: 16-byte rows, no bias."""
    import torch
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse_t = (torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
             if lse else None)
    strides = ((q.stride(0), q.stride(1), q.stride(2))
               + attn._kv_strides(k, h) + attn._kv_strides(v, h))
    err = attn._library("flash_attn_fwd").flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        None if lse_t is None else lse_t.data_ptr(), *strides, 0, 0, 0, b, h,
        tq, k.shape[2], d, d ** -0.5, 1, 16,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"register kernel failed: CUDA error {err}")
    return out


def wide_shapes(only):
    """[(group, site, (B, H, Tq, Tk, D), {path: launches})] of the d 512
    launches."""
    out = [("clip", site, shape, {"clip": n})
           for site, shape, n in FLASH_CLIP if shape[-1] > 128]
    out += [("svd", site, shape, paths) for site, shape, paths in FLASH_OTHER
            if shape[-1] > 128]
    return [s for s in out if s[0] in only]


def run_wide(args, sources):
    """The wide wgmma kernel's variants in turns at each d 512 shape, beside
    the column-split kernel and the library; per variant the kernels' own
    device times under torch.profiler too."""
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn
    from torch_flash_ab import kernel_ms

    stem = "flash_attn_fwd_wide_sm90"
    libs = build(sources, stem, r"flash_fwd_wide_\w+?_kernel\w*?")
    libs = {name: attn._bind(lib, stem) for name, lib in libs.items()}
    own = attn._library
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(sources) + list(reversed(sources))
    sums = {}
    for group, site, (b, h, tq, tk, d), paths in wide_shapes(
            set(args.only.split(","))):
        q, k, v = (torch.randn((b, h, t, d), generator=gen,
                               device="cuda").bfloat16()
                   for t in (tq, tk, tk))
        reps = 5 if tq * tk > 10_000_000 else 20
        want = plain_err = None
        if args.check:
            want = attn.attention_reference(*(x.double() for x in (q, k, v)))
            plain_err = (attn.attention_reference(q, k, v).double()
                         - want).abs().max().item()
        times = {}
        try:
            for turn, name in enumerate(order):
                attn._library = (lambda lib: lambda n: lib if n == stem
                                 else own(n))(libs[name])

                def fn():
                    return attn.flash_attention_fwd(q, k, v)

                got = fn()
                err = ""
                if want is not None and turn < len(sources):
                    e = (got.double() - want).abs().max().item()
                    err = (f"; err {e:.3e} (plain {plain_err:.3e}, "
                           f"{'OK' if e <= 1.5 * plain_err else 'FAIL'})")
                ms = device_ms(fn, reps)
                times.setdefault(name, []).append(ms)
                per = (kernel_ms(fn, reps, "flash_fwd_")
                       if turn < len(sources) else {})
                print(f"{site:28s} [{b},{h},{tq},{tk},{d}] {name:10s} device "
                      f"{ms:.4f} ms"
                      + "".join(f"; {kn.split('<')[0]} {t:.4f}"
                                for kn, t in per.items()) + err, flush=True)
        finally:
            attn._library = own
        times["column split"] = [device_ms(
            lambda: register_fwd(attn, q, k, v, False), reps)]
        times["library"] = [device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), reps)]
        print(f"{site:28s} flash_fwd_wide_kernel "
              f"{times['column split'][0]:.4f} ms, library "
              f"{times['library'][0]:.4f} ms", flush=True)
        for name, ms in times.items():
            for path, n in paths.items():
                sums.setdefault(path, {}).setdefault(name, 0.0)
                sums[path][name] += n * sum(ms) / len(ms) / 1e3
        del q, k, v, got, want
        torch.cuda.empty_cache()
    for path, by_name in sums.items():
        print(f"{path}: s of d 512 launches x device time (mean of turns): "
              + ", ".join(f"{name} {s:.4f}" for name, s in by_name.items()))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--preset", action="append", default=[],
                    choices=sorted({**WIDE_PRESETS, **TF32_PRESETS}))
    ap.add_argument("--only", default=None)
    ap.add_argument("--source", default="flash_attn_fwd_sm90",
                    choices=["flash_attn_fwd_sm90", "flash_attn_fwd_wide_sm90",
                             "flash_attn_fwd_tf32_sm90"])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--consumers", action="append", default=[],
                    metavar="NAME=N")
    args = ap.parse_args()
    wide = args.source == "flash_attn_fwd_wide_sm90"
    tf32 = args.source == "flash_attn_fwd_tf32_sm90"
    if args.only is None:
        args.only = ("clip,svd" if wide
                     else "validate,scored,panel,precompute,step" if tf32
                     else "svd,clip,gated,caption,step")
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import attention as attn
    from neurons_tpu_torch.ops import cuda_build

    base = (cuda_build.CSRC_DIR / f"{args.source}.cu").read_text()
    sources = {"base": base}
    for name, old, new in args.variant:
        src = sources.get(name, base)
        if old not in src:
            raise SystemExit(f"{name}: the text to replace is not in the "
                             f"source")
        sources[name] = src.replace(old, new)
    for name in args.preset:
        src = base
        for old, new in {**WIDE_PRESETS, **TF32_PRESETS}[name]:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            src = src.replace(old, new)
        sources[name] = src
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if wide or tf32:
        cuda_build.build(["flash_attn_fwd"])
        return (run_wide if wide else run_tf32)(args, sources)
    libs = build(sources, "flash_attn_fwd_sm90",
                 r"flash_fwd_wgmma_kernelILi\d+ELi\d+ELb[01]")
    libs = {name: attn._bind(lib, "flash_attn_fwd_sm90")
            for name, lib in libs.items()}
    own = attn._library
    cuda_build.build(["flash_attn_fwd"])
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(sources) + list(reversed(sources))
    sums = {}
    current = ["base"]

    def library(name):
        return libs[current[0]] if name == "flash_attn_fwd_sm90" else own(name)

    for group, site, (b, h, tq, tk, d), lse, paths in shapes(
            set(args.only.split(","))):
        q, k, v = (torch.randn((b, h, t, d), generator=gen,
                               device="cuda").bfloat16()
                   for t in (tq, tk, tk))
        reps = 5 if tq * tk > 10_000_000 else 20
        times = {}
        ref = None
        try:
            attn._library = library
            for turn, name in enumerate(order):
                current[0] = name

                def fn():
                    return attn.flash_attention_fwd(q, k, v, return_lse=lse)

                got = fn()
                got = got[0] if lse else got
                ref = got if ref is None else ref
                ms = device_ms(fn, reps)
                times.setdefault(name, []).append(ms)
                print(f"{site:26s} [{b},{h},{tq},{tk},{d}]{' lse' if lse else ''} "
                      f"{name:10s} device {ms:.4f} ms; equal bits to base "
                      f"{torch.equal(got, ref)}", flush=True)
        finally:
            attn._library = own
        times["register"] = [device_ms(
            lambda: register_fwd(attn, q, k, v, lse), reps)]
        times["library"] = [device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), reps)]
        print(f"{site:26s} register kernel {times['register'][0]:.4f} ms, "
              f"library {times['library'][0]:.4f} ms", flush=True)
        for name, ms in times.items():
            for path, n in paths.items():
                sums.setdefault(path, {}).setdefault(name, 0.0)
                sums[path][name] += n * sum(ms) / len(ms) / 1e3
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    for path, by_name in sums.items():
        print(f"{path}: s of launches x device time (mean of turns): "
              + ", ".join(f"{name} {s:.4f}" for name, s in by_name.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
