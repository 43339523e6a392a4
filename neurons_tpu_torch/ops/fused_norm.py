"""GroupNorm and GroupNorm + SiLU on channels-first tensors: the plain
PyTorch versions and the hand-written CUDA GroupNorm+SiLU kernel.

Counterpart of neurons_tpu/ops/fused_norm.py. The statistics are two-pass:
the mean first, then the variance of the centred values (the single-pass
E[x^2] - mean^2 cancels for large-mean channels), both in f32 (f64 for f64
input); the result comes back in the input type.

`group_norm_silu` routes as the JAX package does: with
NEURONS_TPU_FUSED_NORM=1 (read on every call; off by default) through
`GroupNormSiLUFn`, whose forward is `gn_silu_fwd`, when autograd records
(straight to `gn_silu_fwd` when it does not), else through the plain
composite `group_norm_silu_reference`. `gn_silu_fwd` takes a CPU tensor to
the plain version and a CUDA tensor to csrc/gn_silu.cu, which replaces the
Pallas kernel `_kernel` (neurons_tpu/ops/fused_norm.py:102); it never
falls back. The JAX package's gate on the per-sample size (its 3 MB VMEM
cap) is a TPU limit and has no counterpart: every shape launches, the
768x768 VAE decode included. The backward recomputes the plain version
from the saved input and differentiates it, as the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from neurons_tpu_torch.ops import cuda_build
from neurons_tpu_torch.ops.cuda_build import LaunchCounter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# incremented by gn_silu_fwd where it launches its kernel, and nowhere else;
# keyed by (N, C, *spatial, groups, dtype)
GN_SILU_LAUNCHES = LaunchCounter()


def fused_norm_enabled() -> bool:
    """NEURONS_TPU_FUSED_NORM=1: GroupNorm+SiLU through the kernel."""
    return os.environ.get("NEURONS_TPU_FUSED_NORM", "0") == "1"


def _normalize_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    n, c = x.shape[:2]
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.to(acc).reshape(n, groups, -1)
    xc = xg - xg.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * weight.to(acc).reshape(shape) + bias.to(acc).reshape(shape)


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (C/G, *spatial) of x [N, C, *spatial]."""
    return _normalize_f32(x, weight, bias, groups, eps).to(x.dtype)


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then SiLU, x [N, C, *spatial]."""
    return F.silu(_normalize_f32(x, weight, bias, groups, eps)).to(x.dtype)


def check_group_norm_operands(name: str, x: torch.Tensor,
                              weight: torch.Tensor, bias: torch.Tensor,
                              groups: int):
    if x.dim() < 2:
        raise ValueError(f"{name} takes x [N, C, *spatial], got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"{name}: {c} channels do not split into {groups} "
                         "groups")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be [{c}]")
    if not (x.device == weight.device == bias.device):
        raise ValueError(f"{name}: operands lie on different devices")


def check_cuda_operand(name: str, x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor):
    """A CUDA launch takes bf16 or f32 x, and a GroupNorm weight and bias
    of one type, f32 or bf16."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes bfloat16 or float32, got {x.dtype}")
    if weight.dtype not in _DTYPE_CODE or bias.dtype != weight.dtype:
        raise ValueError(f"{name} takes a bfloat16 or float32 weight and a "
                         f"bias of its type, got {weight.dtype} and "
                         f"{bias.dtype}")


def gn_silu_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then SiLU, x [N, C, *spatial] -> same shape and type.

    CUDA tensors launch csrc/gn_silu.cu (bf16 or f32 x; weight and bias
    f32 or bf16): one cluster launch where a slab fits a cluster's shared
    memory, else statistics then apply (`gn_silu_plan`). CPU tensors
    compute `group_norm_silu_reference`."""
    check_group_norm_operands("gn_silu", x, weight, bias, groups)
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps)
    check_cuda_operand("gn_silu", x, weight, bias)
    x = x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    lanes = 16 // x.element_size()
    lib = _library()
    y = torch.empty_like(x)
    vec = int(hw % lanes == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    plan = _plan(n, c, hw, groups, _DTYPE_CODE[x.dtype], vec, x.device.index)
    # the two-launch path's per-slab (mean, 1/std); none on the cluster path
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                           device=x.device) if plan.scratch_bytes else None)
    with cuda_build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_silu(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                          y.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          n, c, hw, groups, float(eps), _DTYPE_CODE[x.dtype],
                          int(weight.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        msg = lib.gn_silu_error_string(err).decode()
        raise RuntimeError(f"gn_silu failed at {tuple(x.shape)}, {groups} "
                           f"groups, {x.dtype}: CUDA error {err} ({msg})")
    GN_SILU_LAUNCHES.add(tuple(x.shape) + (groups, _DTYPE_NAME[x.dtype]))
    return y


class GNSiLUPlan(NamedTuple):
    launches: int       # 1: one cluster kernel; 2: statistics, then apply
    cluster: int        # blocks a slab's cluster
    share: int          # elements a block
    threads: int        # a block
    scratch_bytes: int  # the two-launch path's per-slab statistics


@functools.lru_cache(maxsize=None)
def _plan(n, c, hw, groups, dtype_code, vec, device_index) -> GNSiLUPlan:
    lib = _library()
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_longlong()]
    with torch.cuda.device(device_index):
        err = lib.gn_silu_plan(n, c, hw, groups, dtype_code, vec,
                               *map(ctypes.byref, out))
    if err != 0:
        msg = lib.gn_silu_error_string(err).decode()
        raise RuntimeError(f"gn_silu cannot launch at [{n}, {c}, {hw}], "
                           f"{groups} groups: CUDA error {err} ({msg})")
    return GNSiLUPlan(*(v.value for v in out))


def gn_silu_plan(n: int, c: int, hw: int, groups: int, dtype: torch.dtype,
                 vec: int, device: torch.device) -> GNSiLUPlan:
    """How csrc/gn_silu.cu launches x [n, c, hw] on `device` (cached per
    shape: it depends only on the shape and the card)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _plan(n, c, hw, groups, _DTYPE_CODE[dtype], vec, index)


def vjp_of_reference(reference, inputs, needs, g):
    """Gradients of `reference(*inputs)` against `g`, recomputed from the
    inputs (None where `needs` is false)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, needs)]
        out = reference(*leaves)
        wrt = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
    return tuple(next(grads) if need else None for need in needs)


class GroupNormSiLUFn(torch.autograd.Function):
    """The JAX package's custom-VJP `group_norm_silu`: the forward is the
    kernel (`gn_silu_fwd`); the backward differentiates the plain version,
    recomputed from the saved input. Pure, so a checkpointed region may run
    the forward twice."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        return gn_silu_fwd(x, weight, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        grads = vjp_of_reference(
            lambda x, w, b: group_norm_silu_reference(x, w, b, ctx.groups,
                                                      ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return grads + (None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then SiLU, x [N, C, *spatial]: with
    NEURONS_TPU_FUSED_NORM=1 through the kernel, as its autograd Function
    when autograd records and as one launch with nothing saved otherwise;
    else the plain composite."""
    if fused_norm_enabled():
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, weight, bias)):
            return GroupNormSiLUFn.apply(x, weight, bias, groups, float(eps))
        return gn_silu_fwd(x, weight, bias, groups, eps)
    return group_norm_silu_reference(x, weight, bias, groups, eps)


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's parameters (scale -> weight, bias)
    and its two-pass statistics. Input [N, C, *spatial]."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_reference(x, self.weight, self.bias,
                                    self.num_groups, self.eps)


class GroupNormSiLU(GroupNorm):
    """GroupNorm followed by SiLU, one module as in the JAX package; routed
    by `group_norm_silu`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("gn_silu")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.gn_silu.argtypes = ([ptr] * 5 + [i64, i32, i64, i32, ctypes.c_float]
                            + [i32] * 3 + [ptr])
    lib.gn_silu.restype = i32
    lib.gn_silu_plan.argtypes = ([i64, i32, i64] + [i32] * 3
                                 + [ctypes.POINTER(i32)] * 4
                                 + [ctypes.POINTER(i64)])
    lib.gn_silu_plan.restype = i32
    lib.gn_silu_error_string.argtypes = [i32]
    lib.gn_silu_error_string.restype = ctypes.c_char_p
    return lib
