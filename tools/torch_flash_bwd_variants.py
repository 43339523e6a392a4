#!/usr/bin/env python3
"""Time edited copies of csrc/flash_attn_bwd.cu against the checkout's own
source on one CUDA card, at the f32 stage-2 step's backward shapes (or,
with --source flash_attn_bwd_sm90, of the bf16 wgmma backward at the bf16
step's DecoderVideo shapes; with --source flash_attn_bwd_tf32_sm90, of
the TF32 wgmma backward at the f32 step's shapes, the prior's on its
head-bias kernels).

    python3 tools/torch_flash_bwd_variants.py --variant NAME OLD NEW [...]
        [--shapes prior,decoder_16,decoder_32,decoder_64]
        [--source flash_attn_bwd|flash_attn_bwd_sm90|flash_attn_bwd_tf32_sm90]

Each variant is the checkout's source with every occurrence of the text
OLD (at least one) replaced by NEW, e.g. another ring-stage rule or
launch bound; a NAME given twice applies both edits. Every source ("base" the checkout's own) is built with the
package's nvcc flags, all at once, into the git-ignored EXP/variants/ and
loaded in place of the package's library for `flash_attention_bwd`. Per
shape the variants run in turns (base, v1, ..., v1, base); each prints
the device time of each backward kernel over 5 calls under
torch.profiler and whether its outputs equal base's bit for bit. A variant's
`-Xptxas -v` registers and spills are printed after the build.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (B, H, Tq, Tk, D, kv heads, bias shape) of the f32 stage-2 step's
# backward launches
SHAPES = {
    "prior": (10, 32, 513, 514, 52, 1, (32, 513, 514)),
    "decoder_16": (60, 1, 256, 256, 128, 1, None),
    "decoder_32": (60, 1, 1024, 1024, 64, 1, None),
    "decoder_64": (60, 1, 4096, 4096, 32, 1, None),
}


def build(sources, stem="flash_attn_bwd",
          kernel=r"flash_bwd_\w+?_tf32_kernel\w*?"):
    """Build {name: source text} into EXP/variants/lib<stem>_<name>.so at
    once, printing the registers and spills of each kernel whose mangled
    name matches `kernel` (a regex); returns {name: ctypes library}."""
    from neurons_tpu_torch.ops import cuda_build
    out = REPO / "EXP" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        (out / f"{stem}_{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC_DIR), "-o", str(out / f"lib{stem}_{name}.so"),
             str(out / f"{stem}_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    logs = {name: p.communicate()[0] for name, p in procs.items()}
    print(f"built {sorted(sources)} in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name, log in logs.items():
        if procs[name].returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log[-4000:]}")
        fn = None
        for line in log.splitlines():
            m = re.search(rf"Compiling entry function '\w*?({kernel})"
                          r"(ENS|EEEv)", line)
            if m:
                fn, spills = m.group(1), "no spill line"
            m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)",
                          line)
            if m and fn:
                spills = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"  {name} {fn}: {m.group(1)} registers, {spills}")
                fn = None
        serialized = sum("wgmma.mma_async instructions are serialized" in line
                         for line in log.splitlines())
        if serialized:  # ptxas waits after every wgmma of those kernels
            print(f"  {name}: wgmma serialized (ptxas C751x) in "
                  f"{serialized} kernels")
        libs[name] = ctypes.CDLL(str(out / f"lib{stem}_{name}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--source", default="flash_attn_bwd",
                    choices=["flash_attn_bwd", "flash_attn_bwd_sm90",
                             "flash_attn_bwd_tf32_sm90"])
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.ops import attention as attn
    from neurons_tpu_torch.ops import cuda_build

    stem = args.source
    sm90 = stem == "flash_attn_bwd_sm90"
    wgmma = stem != "flash_attn_bwd"
    dtype = torch.bfloat16 if sm90 else torch.float32
    shapes = args.shapes or ("decoder_16,decoder_32,decoder_64" if sm90
                             else ",".join(SHAPES))
    base = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
    sources = {"base": base}
    for name, old, new in args.variant:
        src = sources.get(name, base)
        if old not in src:
            raise SystemExit(f"{name}: the text to replace is not in the "
                             f"source")
        sources[name] = src.replace(old, new)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    libs = build(sources, stem, r"flash_bwd_\w+?_wgmma_kernel\w*?" if wgmma
                 else r"flash_bwd_\w+?_tf32_kernel\w*?")
    libs = {name: attn._bind(lib, stem) for name, lib in libs.items()}
    own = attn._library
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(sources) + list(reversed(sources))
    for shape in shapes.split(","):
        b, h, tq, tk, d, hkv, bshape = SHAPES[shape]
        q, g = (torch.randn((b, h, tq, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, tk, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        bias = (torch.randn(bshape, generator=gen, device="cuda").to(dtype)
                if bshape else None)
        out, lse = attn.flash_attention_fwd(q, k, v, bias=bias,
                                            return_lse=True)
        ref = None
        try:
            for name in order:
                attn._library = (lambda lib: lambda n: lib if
                                 n == stem else own(n))(libs[name])

                def fn():
                    return attn.flash_attention_bwd(q, k, v, bias, g, out,
                                                    lse, d ** -0.5)

                got = fn()
                ref = got if ref is None else ref
                same = all(a is None or torch.equal(a, r)
                           for a, r in zip(got, ref))
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                ms = {re.search(r"flash_bwd_\w+?_kernel", e.key).group(0):
                      e.self_device_time_total / 5e3
                      for e in prof.key_averages() if "flash_bwd" in e.key}
                print(f"{shape:11s} {name:12s} total {sum(ms.values()):.4f} "
                      f"ms " + " ".join(f"{kn} {t:.4f}" for kn, t in
                                        ms.items())
                      + f"; equal bits to base {same}", flush=True)
        finally:
            attn._library = own
        del q, g, k, v, bias, out, lse, ref, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
