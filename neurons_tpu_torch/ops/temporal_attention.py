"""Temporal (per-pixel, across-frame) attention of the motion modules: the
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of neurons_tpu/ops/temporal_attention.py. q, k and v come in
the layout the motion module's projections emit, [(B F), D, C] with C
innermost (D pixels, C = H * hd); each pixel attends across its F frames,
head by head. `temporal_attention_fwd` takes a CPU tensor to
`temporal_attention_reference` and a CUDA tensor to
csrc/temporal_attn_fwd.cu, which replaces the Pallas kernel
`_temporal_kernel`: its tensor-core route for bf16 with F <= 16 and head
dims that are whole 16-byte rows (every launch of the clip), its
pipelined f32 route for f32 with F <= 16 and such head dims up to 160
(every f32 launch of validate and of the tiny CLI chain), its warp route
for the rest (`temporal_plan` says which). It never falls back.
`temporal_attention`, the entry point, runs that forward alone when
autograd does not record, and
otherwise through `TemporalAttentionFn`, the JAX package's custom VJP:
the kernel forward, and a backward that differentiates the plain version
recomputed from the saved q, k and v.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from neurons_tpu_torch.ops import cuda_build
from neurons_tpu_torch.ops.cuda_build import LaunchCounter
from neurons_tpu_torch.ops.fused_norm import vjp_of_reference

_KERNEL = "temporal_attn_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_FRAMES = 32  # motion_max_seq_length; the kernel's limit

# incremented by temporal_attention_fwd where it launches its kernel, and
# nowhere else; keyed by (B F, D, C, F, H, dtype)
TEMPORAL_ATTN_LAUNCHES = LaunchCounter()


def temporal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n_frames: int, heads: int,
                                 scale: float) -> torch.Tensor:
    """q/k/v [(B F), D, C] -> [(B F), D, C]: batched products over the
    [B, F, D, H, hd] view, f32 logits and softmax (f64 for f64 operands);
    the weights are cast to v's type before the product with v, as in the
    JAX package."""
    bf, d, c = q.shape
    b, hd = bf // n_frames, c // heads

    def split(y):
        return y.reshape(b, n_frames, d, heads, hd)

    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bidhk,bjdhk->bdhij", split(q).to(acc),
                          split(k).to(acc)) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bdhij,bjdhk->bidhk", w, split(v))
    return out.reshape(bf, d, c)


def _check_operands(q, k, v, n_frames, heads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"temporal_attention takes q, k, v of one "
                         f"[(B F), D, C] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bf, _, c = q.shape
    if n_frames < 1 or bf % n_frames or heads < 1 or c % heads:
        raise ValueError(f"{tuple(q.shape)} does not split into "
                         f"{n_frames} frames and {heads} heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def temporal_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, n_frames: int, heads: int,
                           scale: float) -> torch.Tensor:
    """Per-pixel attention across frames, q/k/v [(B F), D, C] -> same,
    outside autograd.

    CUDA tensors launch csrc/temporal_attn_fwd.cu (bf16 or f32, contiguous,
    F <= 32, any heads and head dim; `temporal_plan` gives the route).
    CPU tensors compute `temporal_attention_reference`."""
    _check_operands(q, k, v, n_frames, heads)
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, n_frames, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"temporal_attention takes bfloat16 or float32, "
                         f"got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("temporal_attention needs contiguous [(B F), D, C] "
                         "operands")
    if n_frames > MAX_FRAMES:
        raise ValueError(f"temporal_attention takes at most {MAX_FRAMES} "
                         f"frames, got {n_frames}")
    bf, d, c = q.shape
    lib = _library()
    out = torch.empty_like(q)
    lanes = 16 // q.element_size()  # elements in one 16-byte load
    vec = int((c // heads) % lanes == 0 and c % lanes == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    with cuda_build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.temporal_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), bf, d, c, n_frames, heads,
                                    float(scale), _DTYPE_CODE[q.dtype], vec,
                                    stream)
    if err != 0:
        msg = lib.temporal_attn_error_string(err).decode()
        raise RuntimeError(f"temporal_attn_fwd failed at {tuple(q.shape)}, "
                           f"F={n_frames}, H={heads}, {q.dtype}: CUDA error "
                           f"{err} ({msg})")
    TEMPORAL_ATTN_LAUNCHES.add((bf, d, c, n_frames, heads,
                                str(q.dtype).split(".")[-1]))
    return out


class TemporalAttentionFn(torch.autograd.Function):
    """The JAX package's custom-VJP `temporal_attention`: the forward is
    `temporal_attention_fwd` (the kernel on a CUDA tensor); the backward
    differentiates `temporal_attention_reference`, recomputed from the
    saved q, k and v. Pure, so a checkpointed region may run the forward
    twice."""

    @staticmethod
    def forward(ctx, q, k, v, n_frames, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.n_frames, ctx.heads, ctx.scale = n_frames, heads, scale
        return temporal_attention_fwd(q, k, v, n_frames, heads, scale)

    @staticmethod
    def backward(ctx, g):
        grads = vjp_of_reference(
            lambda q, k, v: temporal_attention_reference(
                q, k, v, ctx.n_frames, ctx.heads, ctx.scale),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return grads + (None, None, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_frames: int, heads: int,
                       scale: float) -> torch.Tensor:
    """Per-pixel attention across frames, q/k/v [(B F), D, C] -> same: the
    differentiable `TemporalAttentionFn` when autograd records, else one
    launch of `temporal_attention_fwd` with nothing saved."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return TemporalAttentionFn.apply(q, k, v, n_frames, heads,
                                         float(scale))
    return temporal_attention_fwd(q, k, v, n_frames, heads, scale)


ROUTES = {1: "tensor cores", 2: "f32 pipelined", 0: "warp"}


class TemporalPlan(NamedTuple):
    route: str  # a value of ROUTES
    warps: int  # a block
    smem: int   # bytes a block
    split: int  # warps a (pixel, head) unit, each taking 16 / split rows


def temporal_plan(n_frames: int, head_dim: int,
                  dtype: torch.dtype) -> TemporalPlan:
    """How a launch at (F, hd, dtype) runs, for 16-byte aligned operands
    (the allocator's) whose hd is a whole number of 16-byte units where
    it can be."""
    lib = _library()
    out = [ctypes.c_int() for _ in range(4)]
    vec = int(head_dim % (16 // dtype.itemsize) == 0)
    if not lib.temporal_attn_fwd_plan(n_frames, head_dim, _DTYPE_CODE[dtype],
                                      vec, *map(ctypes.byref, out)):
        raise ValueError(f"temporal_attn_fwd cannot launch at F={n_frames}, "
                         f"hd={head_dim}")
    route, warps, smem, split = (x.value for x in out)
    return TemporalPlan(ROUTES[route], warps, smem, split)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL)
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.temporal_attn_fwd.argtypes = ([ptr] * 4 + [i64] * 2 + [i32] * 3
                                      + [ctypes.c_float, i32, i32, ptr])
    lib.temporal_attn_fwd.restype = i32
    lib.temporal_attn_fwd_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 4
    lib.temporal_attn_fwd_plan.restype = i32
    lib.temporal_attn_error_string.argtypes = [i32]
    lib.temporal_attn_error_string.restype = ctypes.c_char_p
    return lib
