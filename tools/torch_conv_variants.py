#!/usr/bin/env python3
"""Time edited copies of csrc/gn_silu_conv_sm90.cu (the bf16 wgmma
GroupNorm+SiLU+3x3-conv kernel, #8) against the checkout's own source on
one CUDA card, at every shape of the fused clip, beside the staged-halo
mma.sync kernel (csrc/gn_silu_conv.cu) and the library composite.

    python3 tools/torch_conv_variants.py [--variant NAME OLD NEW ...]
        [--plan NAME KEY=VALUE[,KEY=VALUE]] [--shapes I,J,...] [--no-check]

Each variant is the checkout's source with every occurrence of the text
OLD (at least one) replaced by NEW (e.g. the activation moved after the
products' wait; the products or the activation removed, to see which of
the two sets the time), and/or the launch plan with some of its choices
overridden (`--plan NAME bn=256` or `stages=4`: the N tile and the weight
ring's depth of `fused_conv._sm90_plan`); a NAME given twice applies both.
Every source ("base" the checkout's own) is built with the package's nvcc
flags, all at once, into the git-ignored EXP/variants/ and loaded in place
of the package's library for `gn_silu_conv_fwd`; each build's registers, spills
and serialized products (ptxas C7513) are printed. Per shape the variants
run in turns (base, v1, ..., v1, base); each prints its device time a call
(`device_ms` of tools/torch_flash_ab.py), whether its output equals base's
bit for bit and (unless --no-check) its error against float64 over the bf16
plain version's; the staged-halo kernel and the library's
F.conv2d(F.silu(F.group_norm(...))) are timed once a shape the same way.
The last line sums each variant's turns, the staged-halo kernel and the
library over a fused clip's launches (CONV_CLIP).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from torch_flash_ab import CONV_CLIP, device_ms  # noqa: E402
from torch_flash_bwd_variants import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--plan", nargs=2, action="append", default=[],
                    metavar=("NAME", "KEY=VALUE,..."))
    ap.add_argument("--shapes", default=None,
                    help="comma list of CONV_CLIP indices (default all)")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from neurons_tpu_torch.ops import cuda_build
    from neurons_tpu_torch.ops import fused_conv as fc

    base = (cuda_build.CSRC_DIR / "gn_silu_conv_sm90.cu").read_text()
    sources = {"base": base}
    for name, old, new in args.variant:
        src = sources.get(name, base)
        if old not in src:
            raise SystemExit(f"{name}: the text to replace is not in the "
                             f"source")
        sources[name] = src.replace(old, new)
    overrides = {name: {} for name in sources}
    for name, spec in args.plan:
        sources.setdefault(name, base)
        kv = dict(item.split("=") for item in spec.split(","))
        overrides.setdefault(name, {}).update(
            {k: int(v) for k, v in kv.items()})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = build(sources, "gn_silu_conv_sm90",
                 r"gn_silu_conv_wgmma_kernelILi\d+")
    libs = {name: fc._bind(lib, "gn_silu_conv_sm90")
            for name, lib in libs.items()}
    own_library, own_plan, own_route = (fc._library, fc.conv_plan_sm90,
                                        fc.conv_route)
    current = ["base"]

    def library(name="gn_silu_conv"):
        return libs[current[0]] if name == "gn_silu_conv_sm90" \
            else own_library(name)

    def plan(*a):  # the checkout's plan, or one with the variant's choices
        return fc._sm90_plan(*a, **overrides[current[0]]) \
            if overrides.get(current[0]) else own_plan(*a)

    cuda_build.build(["gn_silu_conv"])
    picked = (range(len(CONV_CLIP)) if args.shapes is None
              else [int(i) for i in args.shapes.split(",")])
    order = list(sources) + list(reversed(sources))
    gen = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16
    sums = {}
    for idx in picked:
        (n, cin, h, w, cout), launches = CONV_CLIP[idx]
        x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(bf)
        gw = (1 + 0.1 * torch.randn((cin,), generator=gen,
                                    device="cuda")).to(bf)
        gb = (0.1 * torch.randn((cin,), generator=gen, device="cuda")).to(bf)
        cw = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              / (9 * cin) ** 0.5).to(bf)
        cb = (0.1 * torch.randn((cout,), generator=gen, device="cuda")).to(bf)
        call = (x, gw, gb, cw, cb, 32, 1e-5)
        shape = f"[{n},{cin},{h},{w}]->{cout}"
        times, ref = {}, None
        if not args.no_check:  # float64, and the bf16 plain version's error
            want = fc.gn_silu_conv_reference(
                *(a.double() for a in call[:5]), 32, 1e-5)
            perr = (fc.gn_silu_conv_reference(*call).double()
                    - want).abs().max().item()
        try:
            fc._library, fc.conv_plan_sm90 = library, plan
            for name in order:
                current[0] = name

                def fn():
                    return fc.gn_silu_conv_fwd(*call)

                got = fn()
                ref = got if ref is None else ref
                ms = device_ms(fn, 10)
                note = ""
                if name not in times and not args.no_check:
                    err = (got.double() - want).abs().max().item()
                    note = f"; error ratio to plain {err / perr:.3f}"
                times.setdefault(name, []).append(ms)
                print(f"{shape:26s} {name:12s} device {ms:.4f} ms; equal "
                      f"bits to base {torch.equal(got, ref)}{note}",
                      flush=True)
        finally:
            fc._library, fc.conv_plan_sm90 = own_library, own_plan
        if not args.no_check:
            del want
        try:
            fc.conv_route = lambda *a, **k: fc.HALO_CONV_ROUTE
            times["halo"] = [device_ms(lambda: fc.gn_silu_conv_fwd(*call),
                                      10)]
        finally:
            fc.conv_route = own_route
        times["library"] = [device_ms(lambda: F.conv2d(
            F.silu(F.group_norm(x, 32, gw, gb, 1e-5)), cw, cb, padding=1),
            10)]
        print(f"{shape:26s} staged-halo kernel {times['halo'][0]:.4f} ms, "
              f"library {times['library'][0]:.4f} ms", flush=True)
        for name, ms in times.items():
            sums[name] = sums.get(name, 0.0) + launches * sum(ms) / len(ms)
        del x, cw, ref, got
        torch.cuda.empty_cache()
    print("fused clip: s of launches x device time (mean of turns): "
          + ", ".join(f"{name} {s / 1e3:.4f}" for name, s in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
