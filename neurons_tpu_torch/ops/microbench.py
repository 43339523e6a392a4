"""Kernel micro-benchmarks: the hand-written kernels against PyTorch's
library calls at the UNet's hot shapes.

Counterpart of neurons_tpu/ops/microbench.py (Pallas against XLA), on the
card:

    python -m neurons_tpu_torch.ops.microbench [--iters N]

Attention in bf16, the flash forward (csrc/flash_attn_fwd.cu, #1/#2)
against `scaled_dot_product_attention`: unCLIP UNet self- and
cross-attention at the 48x48 and 24x24 latent levels and the prior's 513
tokens of head dim 52 ([B, H, T, D]). GroupNorm+SiLU in bf16 (32 groups),
#7 (csrc/gn_silu.cu) against `group_norm` then `silu`, at the UNet's four
ResBlock shapes in NCHW. Each case prints both times (CUDA events over
`iters` launches after a warm-up), the kernel's rate (GFLOP/ms of
4 B H Tq Tk D for attention, GB/s of one read and one write for the norm)
and its largest difference from the library call. A kernel that fails
raises: nothing is caught.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch
import torch.nn.functional as F

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.ops.attention import flash_attention_fwd
from neurons_tpu_torch.ops.fused_norm import gn_silu_fwd

# (name, q shape [B, H, Tq, D], Tk)
ATTENTION_CASES = [
    ("self 48x48 (ds2)", (2, 10, 2304, 64), 2304),
    ("self 24x24 (ds4)", (2, 20, 576, 64), 576),
    ("cross 48x48->256", (2, 10, 2304, 64), 256),
    ("cross 24x24->256", (2, 20, 576, 64), 256),
    ("prior 513 tokens", (2, 32, 513, 52), 513),
]
# (name, x shape [N, C, H, W])
GROUPNORM_CASES = [
    ("unet 96x96x320", (2, 320, 96, 96)),
    ("unet 48x48x640", (2, 640, 48, 48)),
    ("unet 24x24x1280", (2, 1280, 24, 24)),
    ("unet 12x12x1280", (2, 1280, 12, 12)),
]


def time_ms(fn: Callable[[], torch.Tensor], iters: int) -> float:
    """Mean ms a call over `iters` calls after one warm-up, by CUDA
    events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_attention(iters: int, device) -> None:
    print("== attention (bf16): flash forward (#1/#2) vs "
          "scaled_dot_product_attention ==", flush=True)
    g = torch.Generator(device).manual_seed(0)
    for name, (b, h, tq, d), tk in ATTENTION_CASES:
        q = torch.randn((b, h, tq, d), generator=g, device=device,
                        dtype=torch.bfloat16)
        k = torch.randn((b, h, tk, d), generator=g, device=device,
                        dtype=torch.bfloat16)
        v = torch.randn((b, h, tk, d), generator=g, device=device,
                        dtype=torch.bfloat16)
        t_lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                        iters)
        t_kernel = time_ms(lambda: flash_attention_fwd(q, k, v), iters)
        err = (flash_attention_fwd(q, k, v).float()
               - F.scaled_dot_product_attention(q, k, v).float()
               ).abs().max().item()
        flops = 4 * b * h * tq * tk * d
        print(f"  {name}: library {t_lib:.3f} ms | kernel {t_kernel:.3f} ms "
              f"| {flops / t_kernel / 1e9:.1f} GFLOP/ms kernel | max diff "
              f"{err:.4f}", flush=True)


def bench_groupnorm(iters: int, device) -> None:
    print("== groupnorm+silu (bf16, 32 groups): #7 vs group_norm + silu ==",
          flush=True)
    g = torch.Generator(device).manual_seed(0)
    for name, shape in GROUPNORM_CASES:
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.bfloat16)
        weight = torch.ones(shape[1], device=device)
        bias = torch.zeros(shape[1], device=device)

        def library():
            return F.silu(F.group_norm(x, 32, weight.to(x.dtype),
                                       bias.to(x.dtype)))

        t_lib = time_ms(library, iters)
        t_kernel = time_ms(lambda: gn_silu_fwd(x, weight, bias, 32), iters)
        err = (gn_silu_fwd(x, weight, bias, 32).float()
               - library().float()).abs().max().item()
        gb = x.numel() * x.element_size() * 2 / 1e9
        print(f"  {name}: library {t_lib:.3f} ms | kernel {t_kernel:.3f} ms "
              f"| max diff {err:.4f} | {gb / (t_kernel * 1e-3):.0f} GB/s "
              f"kernel", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="neurons_tpu_torch.ops.microbench")
    parser.add_argument("--iters", type=int, default=20,
                        help="timed launches a case (after one warm-up)")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    bench_attention(args.iters, device)
    bench_groupnorm(args.iters, device)


if __name__ == "__main__":
    main()
