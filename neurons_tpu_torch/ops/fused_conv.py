"""GroupNorm -> SiLU -> 3x3 same-pad conv, the res blocks' norm/conv pairs:
the plain PyTorch version and the hand-written CUDA kernel.

Counterpart of neurons_tpu/ops/fused_conv.py, channels-first (x [N, Cin,
H, W], the conv weight [Cout, Cin, 3, 3] as nn.Conv2d holds it).

`gn_silu_conv` routes as the JAX package does: with
NEURONS_TPU_FUSED_GNCONV=1 (read on every call; off by default) through
`GNSiLUConvFn`, whose forward is `gn_silu_conv_fwd`, else through
`group_norm_silu` (itself routed by NEURONS_TPU_FUSED_NORM) and the conv.
`gn_silu_conv_fwd` takes a CPU tensor to `gn_silu_conv_reference` and a
CUDA tensor to csrc/gn_silu_conv.cu, which replaces the Pallas kernel
`_kernel` (neurons_tpu/ops/fused_conv.py:91); it never falls back. The JAX
package's gates (C % 128, HW >= 1024, an 8 MB sample, the v5e MXU loss at
24x24) are TPU limits and have no counterpart: every shape launches,
Cout = 4 (the UNet head), Cin = 2560 and 4x4 maps at 32 samples included.
The kernel's statistics are the centred two-pass ones of the plain
GroupNorm, not the JAX wrapper's single-pass E[x^2] - mean^2. The
backward differentiates the plain composite, recomputed from the saved
inputs, as the JAX custom VJP does.

The kernel reads the conv weight packed once to [9, Kc, Np] (tap, Cin
padded to the K chunk, Cout padded to the N tile, which depends on Cout
and the type) in x's type; the packed copy is cached per parameter and
made anew when the parameter changes (another tensor, storage or in-place
version). The bf16 kernel may split its input channels across blocks
where the grid is small; the scratch tensor then also holds the f32
partial sums, reduced in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch.ops import cuda_build
from neurons_tpu_torch.ops.attention import round_to_tf32
from neurons_tpu_torch.ops.cuda_build import LaunchCounter
from neurons_tpu_torch.ops.fused_norm import (_DTYPE_CODE,
                                              check_cuda_operand,
                                              check_group_norm_operands,
                                              group_norm_silu,
                                              group_norm_silu_reference,
                                              vjp_of_reference)

# incremented by gn_silu_conv_fwd where it launches its kernel, and nowhere
# else; keyed by (N, Cin, H, W, Cout, groups, dtype)
GN_SILU_CONV_LAUNCHES = LaunchCounter()


def fused_gnconv_enabled() -> bool:
    """NEURONS_TPU_FUSED_GNCONV=1: GN -> SiLU -> conv pairs through the
    kernel."""
    return os.environ.get("NEURONS_TPU_FUSED_GNCONV", "0") == "1"


def gn_silu_conv_reference(x: torch.Tensor, gn_weight: torch.Tensor,
                           gn_bias: torch.Tensor, conv_weight: torch.Tensor,
                           conv_bias: Optional[torch.Tensor], groups: int,
                           eps: float = 1e-5) -> torch.Tensor:
    """`group_norm_silu_reference`, then the 3x3 same-pad conv and its
    bias, x [N, Cin, H, W] -> [N, Cout, H, W]."""
    h = group_norm_silu_reference(x, gn_weight, gn_bias, groups, eps)
    return F.conv2d(h, conv_weight.to(h.dtype),
                    None if conv_bias is None else conv_bias.to(h.dtype),
                    padding=1)


def gn_silu_conv_reference_tf32(x: torch.Tensor, gn_weight: torch.Tensor,
                                gn_bias: torch.Tensor,
                                conv_weight: torch.Tensor,
                                conv_bias: Optional[torch.Tensor],
                                groups: int, eps: float = 1e-5
                                ) -> torch.Tensor:
    """The plain version at the kernel's precision on f32 input: the
    activation and the weights rounded to TF32 (the kernel's tensor-core
    operands), the conv summed in f64, f32 out."""
    h = round_to_tf32(group_norm_silu_reference(x.float(), gn_weight,
                                                gn_bias, groups, eps))
    y = F.conv2d(h.double(), round_to_tf32(conv_weight).double(),
                 None if conv_bias is None else conv_bias.double(), padding=1)
    return y.float()


def _check_operands(x, gn_weight, gn_bias, conv_weight, conv_bias, groups):
    check_group_norm_operands("gn_silu_conv", x, gn_weight, gn_bias, groups)
    if x.dim() != 4:
        raise ValueError(f"gn_silu_conv takes x [N, Cin, H, W], got "
                         f"{tuple(x.shape)}")
    cin = x.shape[1]
    if conv_weight.dim() != 4 or conv_weight.shape[1:] != (cin, 3, 3):
        raise ValueError(f"gn_silu_conv takes a [Cout, {cin}, 3, 3] conv "
                         f"weight, got {tuple(conv_weight.shape)}")
    if conv_bias is not None and conv_bias.shape != conv_weight.shape[:1]:
        raise ValueError(f"gn_silu_conv: conv bias {tuple(conv_bias.shape)} "
                         f"for {conv_weight.shape[0]} output channels")
    if conv_weight.device != x.device or (conv_bias is not None
                                          and conv_bias.device != x.device):
        raise ValueError("gn_silu_conv: operands lie on different devices")


# id(parameter) -> (weak reference, storage, version, dtype, packed copy)
_PACKED: Dict[int, Tuple] = {}


def packed_weight(conv_weight: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The conv weight [Cout, Cin, 3, 3] as the kernel reads it, [9, Kc, Np]
    in `dtype` (Kc and Np padded to the K chunk and the N tile of
    `conv_tiles(Cout, dtype)`), zero in the padding; cached until the
    parameter changes."""
    # an inference tensor keeps no version counter: it is packed anew
    cached = not conv_weight.is_inference()
    key = id(conv_weight)
    state = (conv_weight.data_ptr(), conv_weight._version if cached else -1,
             dtype)
    hit = _PACKED.get(key)
    if cached and hit is not None and hit[0]() is conv_weight \
            and hit[1:4] == state:
        return hit[4]
    cout, cin = conv_weight.shape[:2]
    _, bn, bk = conv_tiles(cout, dtype)
    kc, npad = -(-cin // bk) * bk, -(-cout // bn) * bn
    with torch.no_grad():
        packed = torch.zeros((9, kc, npad), dtype=dtype,
                             device=conv_weight.device)
        packed[:, :cin, :cout] = conv_weight.detach().permute(2, 3, 1, 0) \
            .reshape(9, cin, cout).to(dtype)
    if cached:
        ref = weakref.ref(conv_weight,
                          lambda _r, key=key: _PACKED.pop(key, None))
        _PACKED[key] = (ref,) + state + (packed,)
    return packed


def gn_silu_conv_fwd(x: torch.Tensor, gn_weight: torch.Tensor,
                     gn_bias: torch.Tensor, conv_weight: torch.Tensor,
                     conv_bias: Optional[torch.Tensor], groups: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm -> SiLU -> 3x3 same-pad conv + bias, x [N, Cin, H, W] ->
    [N, Cout, H, W] in x's type.

    CUDA tensors launch csrc/gn_silu_conv.cu (bf16 x with bf16 products,
    or f32 x with TF32 products; f32 accumulation). CPU tensors compute
    `gn_silu_conv_reference`."""
    _check_operands(x, gn_weight, gn_bias, conv_weight, conv_bias, groups)
    if x.device.type == "cpu":
        return gn_silu_conv_reference(x, gn_weight, gn_bias, conv_weight,
                                      conv_bias, groups, eps)
    check_cuda_operand("gn_silu_conv", x, gn_weight, gn_bias)
    if conv_bias is not None and conv_bias.dtype not in _DTYPE_CODE:
        raise ValueError(f"gn_silu_conv takes a bfloat16 or float32 conv "
                         f"bias, got {conv_bias.dtype}")
    x = x.contiguous()
    gn_weight, gn_bias = gn_weight.contiguous(), gn_bias.contiguous()
    if conv_bias is not None:
        conv_bias = conv_bias.contiguous()
    n, cin, h, w = x.shape
    cout = conv_weight.shape[0]
    packed = packed_weight(conv_weight, x.dtype)
    lib = _library()
    y = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    # the statistics, then (bf16, split over Cin) the f32 partial sums
    scratch = torch.empty(lib.gn_silu_conv_scratch_bytes(
        n, cin, h, w, cout, groups, _DTYPE_CODE[x.dtype]),
        dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_silu_conv(
            x.data_ptr(), gn_weight.data_ptr(), gn_bias.data_ptr(),
            packed.data_ptr(),
            None if conv_bias is None else conv_bias.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), n, cin, h, w, cout, groups,
            float(eps), packed.shape[1], packed.shape[2],
            _DTYPE_CODE[x.dtype], int(gn_weight.dtype == torch.bfloat16),
            int(conv_bias is not None and conv_bias.dtype == torch.bfloat16),
            stream)
    if err != 0:
        msg = lib.gn_silu_conv_error_string(err).decode()
        raise RuntimeError(f"gn_silu_conv failed at {tuple(x.shape)} -> "
                           f"{cout}, {groups} groups, {x.dtype}: CUDA error "
                           f"{err} ({msg})")
    GN_SILU_CONV_LAUNCHES.add((n, cin, h, w, cout, groups,
                               str(x.dtype).split(".")[-1]))
    return y


class GNSiLUConvFn(torch.autograd.Function):
    """The JAX package's custom-VJP `gn_silu_conv`: the forward is the
    kernel (`gn_silu_conv_fwd`); the backward differentiates the plain
    composite, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, gn_weight, gn_bias, conv_weight, conv_bias, groups,
                eps):
        ctx.save_for_backward(x, gn_weight, gn_bias, conv_weight, conv_bias)
        ctx.groups, ctx.eps = groups, eps
        return gn_silu_conv_fwd(x, gn_weight, gn_bias, conv_weight, conv_bias,
                                groups, eps)

    @staticmethod
    def backward(ctx, g):
        grads = vjp_of_reference(
            lambda *a: gn_silu_conv_reference(*a, ctx.groups, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:5], g)
        return grads + (None, None)


def gn_silu_conv(x: torch.Tensor, gn_weight: torch.Tensor,
                 gn_bias: torch.Tensor, conv_weight: torch.Tensor,
                 conv_bias: Optional[torch.Tensor], groups: int,
                 eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm -> SiLU -> 3x3 same-pad conv, x [N, Cin, H, W]: through
    the kernel (its autograd Function) with NEURONS_TPU_FUSED_GNCONV=1,
    else `group_norm_silu` then the conv."""
    if fused_gnconv_enabled():
        return GNSiLUConvFn.apply(x, gn_weight, gn_bias, conv_weight,
                                  conv_bias, groups, float(eps))
    h = group_norm_silu(x, gn_weight, gn_bias, groups, eps)
    return F.conv2d(h, conv_weight, conv_bias, padding=1)


def norm_silu_conv(norm: nn.Module, conv: nn.Conv2d,
                   x: torch.Tensor) -> torch.Tensor:
    """conv(norm(x)) for a GroupNormSiLU module and the 3x3 same-pad conv
    after it, routed by `gn_silu_conv`; the two modules keep their
    parameters, so the parameter tree is the same either way."""
    return gn_silu_conv(x, norm.weight, norm.bias, conv.weight, conv.bias,
                        norm.num_groups, norm.eps)


def conv_tiles(cout: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(BM, BN, BK) of the kernel's tiles for `cout` output channels in
    `dtype`: the output pixels a block owns, the N tile (the packed weights
    pad Cout to it) and the K chunk (they pad Cin to it)."""
    lib = _library()
    bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.gn_silu_conv_tiles(cout, _DTYPE_CODE[dtype], ctypes.byref(bm),
                           ctypes.byref(bn), ctypes.byref(bk))
    return bm.value, bn.value, bk.value


def conv_plan(n: int, cin: int, h: int, w: int, cout: int) -> Dict[str, int]:
    """How the bf16 kernel launches at x [n, cin, h, w] -> cout: the tile
    (samples, rows, columns of one block), the grid (pixel tiles, Cout
    tiles, splits over Cin), the N tile and whether halo rows move in
    16-byte loads."""
    lib = _library()
    out = (ctypes.c_int * 8)()
    lib.gn_silu_conv_plan(n, cin, h, w, cout, out)
    return dict(zip(("samples", "rows", "cols", "pixel_tiles", "cout_tiles",
                     "splits", "bn", "vec"), out))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("gn_silu_conv")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.gn_silu_conv.argtypes = ([ptr] * 7 + [i64] + [i32] * 5
                                 + [ctypes.c_float] + [i32] * 5 + [ptr])
    lib.gn_silu_conv.restype = i32
    lib.gn_silu_conv_tiles.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.gn_silu_conv_tiles.restype = None
    lib.gn_silu_conv_plan.argtypes = [i64] + [i32] * 4 + [ctypes.POINTER(i32)]
    lib.gn_silu_conv_plan.restype = None
    lib.gn_silu_conv_scratch_bytes.argtypes = [i64] + [i32] * 6
    lib.gn_silu_conv_scratch_bytes.restype = i64
    lib.gn_silu_conv_error_string.argtypes = [i32]
    lib.gn_silu_conv_error_string.restype = ctypes.c_char_p
    return lib
