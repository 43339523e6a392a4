#!/usr/bin/env python3
"""Time edited copies of csrc/temporal_attn_fwd.cu against the checkout's
own source on one CUDA card, at validate's f32 temporal-attention shapes.

    python3 tools/torch_temporal_variants.py --variant NAME OLD NEW [...]

Each variant is the checkout's source with every occurrence of the text
OLD (at least one) replaced by NEW, e.g. another ring-stage count or tile
size; a NAME given twice applies both edits. Every source ("base" the
checkout's own) is built with the package's nvcc flags, all at once, into
the git-ignored EXP/variants/ and loaded in place of the package's library
for `temporal_attention_fwd`. Per shape the variants run in turns (base,
v1, ..., v1, base); each prints its device time a call (`device_ms` of
tools/torch_flash_ab.py over 20 calls) and whether its output equals
base's bit for bit. A variant's `-Xptxas -v` registers and spills of
temporal_f32_kernel are printed after the build; the last line sums each
variant's turns over a validate run's launches.
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

from torch_flash_ab import TEMPORAL_F32, device_ms  # noqa: E402
from torch_flash_bwd_variants import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    args = ap.parse_args()
    import torch
    from neurons_tpu_torch.ops import cuda_build
    from neurons_tpu_torch.ops import temporal_attention as ta

    base = (cuda_build.CSRC_DIR / "temporal_attn_fwd.cu").read_text()
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
    libs = build(sources, "temporal_attn_fwd", r"temporal_f32_kernelILi\d+")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    for lib in libs.values():
        lib.temporal_attn_fwd.argtypes = ([ptr] * 4 + [i64] * 2 + [i32] * 3
                                          + [ctypes.c_float, i32, i32, ptr])
        lib.temporal_attn_fwd.restype = i32
        lib.temporal_attn_error_string.argtypes = [i32]
        lib.temporal_attn_error_string.restype = ctypes.c_char_p
    own = ta._library
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(sources) + list(reversed(sources))
    sums = {}
    for site, (bf, d, c), launches in TEMPORAL_F32:
        q, k, v = (torch.randn((bf, d, c), generator=gen, device="cuda")
                   for _ in range(3))
        scale = (c // 8) ** -0.5
        ref = None
        try:
            for turn, name in enumerate(order):
                ta._library = (lambda lib: lambda: lib)(libs[name])

                def fn():
                    return ta.temporal_attention_fwd(q, k, v, 16, 8, scale)

                got = fn()
                ref = got if ref is None else ref
                ms = device_ms(fn, 20)
                sums.setdefault((turn, name), 0.0)
                sums[(turn, name)] += launches * ms / 1e3
                print(f"{site:23s} {name:10s} device {ms:.4f} ms; equal "
                      f"bits to base {torch.equal(got, ref)}", flush=True)
        finally:
            ta._library = own
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    print("validate run, s of launches x device time, by turn: " + ", ".join(
        f"{name} {s:.4f}" for (_, name), s in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
