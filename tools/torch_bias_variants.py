#!/usr/bin/env python3
"""Time edited copies of the head-bias wgmma kernels (the prior's biased
multi-query attention: csrc/flash_attn_fwd_bias_sm90.cu and
csrc/flash_attn_bwd_bias_sm90.cu) against the checkout's own sources on
one CUDA card, at the stage-2 step's prior shape [10, 32, 513, 514, 52]
(bf16, a contiguous [32, 513, 514] bias, scale 1), beside the register
kernels they replaced (on 108-byte rows) and the library.

    python3 tools/torch_bias_variants.py [--fwd NAME OLD NEW ...]
        [--bwd NAME OLD NEW ...] [--check]

Each variant is the checkout's source with every occurrence of the text
OLD (at least one) replaced by NEW; a NAME given twice applies both edits.
Every source ("base" the checkout's own) is built with the package's nvcc
flags, all at once, into the git-ignored EXP/variants/ and loaded in place
of the package's library. The variants run in turns (base, v1, ..., v1,
base); each prints its device time a call (`device_ms` of
tools/torch_flash_ab.py), the backward's passes by torch.profiler, and
whether its outputs equal base's bit for bit; --check holds each variant's
outputs to the float64 plain version within 1.5x the bf16 plain version's
error. A variant's `-Xptxas -v` registers and spills are printed after the
build.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from torch_flash_ab import device_ms  # noqa: E402
from torch_flash_bwd_variants import build  # noqa: E402

PRIOR = (10, 32, 513, 514, 52)
NAMES = ("out", "lse", "dq", "dk", "dv", "dbias")


def sources_of(stem, edits):
    from neurons_tpu_torch.ops import cuda_build
    base = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
    out = {"base": base}
    for name, old, new in edits:
        src = out.get(name, base)
        if old not in src:
            raise SystemExit(f"{name}: the text to replace is not in {stem}")
        out[name] = src.replace(old, new)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--bwd", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from neurons_tpu_torch.ops import attention as attn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    stems = ("flash_attn_fwd_bias_sm90", "flash_attn_bwd_bias_sm90")
    srcs = {stems[0]: sources_of(stems[0], args.fwd),
            stems[1]: sources_of(stems[1], args.bwd)}
    libs = {stem: {n: attn._bind(lib, stem) for n, lib in build(
        s, stem, r"flash_\w+?_bias_wgmma_kernel\w*?").items()}
        for stem, s in srcs.items()}
    own = attn._library

    b, h, tq, tk, d = PRIOR
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * s).bfloat16()

    q, k, v = rand(b, h, tq, d, s=0.4), rand(b, 1, tk, d, s=0.4), \
        rand(b, 1, tk, d)
    bias, g = rand(h, tq, tk), rand(b, h, tq, d)
    want = plain = None
    if args.check:
        ins = [x.double().requires_grad_() for x in (q, k, v, bias)]
        wo, wl = attn.attention_reference_lse(*ins[:3], ins[3], 1.0)
        want = [x.detach() for x in (wo, wl) + torch.autograd.grad(
            wo, ins, g.double())]
        del ins, wo, wl
        po, pl = attn.attention_reference_lse(q, k, v, bias, 1.0)
        plain = (po, pl) + tuple(attn.flash_attention_bwd_reference(
            q, k, v, bias, g, po, pl, 1.0))
        plain = [(p.double() - w).abs().max().item()
                 for p, w in zip(plain, want)]
    out, lse = attn.flash_attention_fwd(q, k, v, scale=1.0, bias=bias,
                                        return_lse=True)

    def use(stem, lib):
        attn._library = lambda n: lib if n == stem else own(n)

    for stem in stems:
        fwd = stem == stems[0]
        names = list(srcs[stem])
        order = names + list(reversed(names))
        ref = None
        try:
            for name in order:
                use(stem, libs[stem][name])

                def fn():
                    if fwd:
                        return attn.flash_attention_fwd(
                            q, k, v, scale=1.0, bias=bias, return_lse=True)
                    return attn.flash_attention_bwd(q, k, v, bias, g, out,
                                                    lse, 1.0)

                got = fn()
                ref = got if ref is None else ref
                same = all(torch.equal(a, r) for a, r in zip(got, ref))
                ms = device_ms(fn, 10)
                parts = ""
                if not fwd:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(5):
                            fn()
                        torch.cuda.synchronize()
                    for e in prof.key_averages():
                        m = re.search(r"flash_bwd_\w+?_kernel", e.key)
                        if m:
                            parts += (f" {m.group(0)} "
                                      f"{e.self_device_time_total / 5e3:.4f}")
                check = ""
                if want is not None:
                    sel = NAMES[:2] if fwd else NAMES[2:]
                    check = " error/plain" + "".join(
                        f" {n} {(x.double() - want[NAMES.index(n)]).abs().max().item() / plain[NAMES.index(n)]:.3f}"
                        for n, x in zip(sel, got))
                print(f"{'forward' if fwd else 'backward'} {name:14s} device "
                      f"{ms:.4f} ms {parts}; equal bits to base {same}"
                      f"{check}", flush=True)
        finally:
            attn._library = own

    # the register kernels (108-byte rows) and the library, once
    def pad(x):
        buf = torch.zeros(x.shape[:-1] + (x.shape[-1] + 2,), dtype=x.dtype,
                          device=x.device)
        buf[..., :x.shape[-1]] = x
        return buf[..., :x.shape[-1]]

    qp, kp, vp, gp = pad(q), pad(k), pad(v), pad(g)
    reg_f = device_ms(lambda: attn.flash_attention_fwd(
        qp, kp, vp, scale=1.0, bias=bias, return_lse=True), 5)
    reg_b = device_ms(lambda: attn.flash_attention_bwd(
        qp, kp, vp, bias, gp, out, lse, 1.0), 5)
    kx, vx = (x.expand(b, h, tk, d).contiguous() for x in (k, v))
    lib_f = device_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=bias, scale=1.0), 5)
    li = [x.detach().requires_grad_() for x in (q, kx, vx, bias)]
    lo = F.scaled_dot_product_attention(*li[:3], attn_mask=li[3], scale=1.0)
    lib_b = device_ms(lambda: torch.autograd.grad(lo, li, g,
                                                  retain_graph=True), 5)
    print(f"register kernels (108-byte rows): forward {reg_f:.4f} ms, "
          f"backward {reg_b:.4f} ms; library: forward {lib_f:.4f} ms, "
          f"backward alone {lib_b:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
