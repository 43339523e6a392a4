"""Attention ops: the hand-written CUDA flash-attention forward and its
plain PyTorch version.

Counterpart of neurons_tpu/ops/attention.py. One entry point,
`dot_product_attention`, serves every attention site of stage 3 in the
[B, H, T, D] layout:

  * UNet2D self-attention (2304 and 576 tokens, d=64) and cross-attention
    over the 256 CLIP tokens;
  * the DecoderVideo AttnBlock (up to 4096 tokens, one head, d=32..128);
  * the VAE mid-block attention (one head, d=512, 4096 or 9216 tokens).

Those go to `flash_attention_fwd`, whose CUDA kernel (csrc/flash_attn_fwd.cu)
replaces the Pallas kernels `_flash_kernel_smallkv` and `_flash_kernel`.
Short rows (< 128 tokens), masked attention (GPT-2's causal mask) and biased
attention (the prior's relative-position bias, which the JAX package also
keeps off its kernel at inference) take `attention_reference`.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from neurons_tpu_torch.ops import cuda_build
from neurons_tpu_torch.ops.cuda_build import LaunchCounter

_NEG_INF = -1e30
_KERNEL = "flash_attn_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# incremented by flash_attention_fwd where it launches its kernel, and
# nowhere else; keyed by (B, H, Tq, Tk, D, dtype)
FLASH_FWD_LAUNCHES = LaunchCounter()


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v with f32 logits and softmax (f64 for
    f64 operands) — the plain version of the JAX package's `xla_attention`.

    q: [..., Tq, D], k/v: [..., Tk, D]; bias/mask broadcastable to
    [..., Tq, Tk] (mask True = keep). Multi-query: rank-4 k/v may carry 1
    where q carries H on the head axis."""
    if (q.dim() == 4 and k.dim() == 4 and k.shape[1] == 1
            and q.shape[1] != 1):
        k = k.expand(q.shape[:2] + k.shape[2:])
        v = v.expand(q.shape[:2] + v.shape[2:])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(acc)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v).to(q.dtype)


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), kept in f32: what the kernel's f32 route does to each operand of
    its tensor-core products (cvt.rna.tf32.f32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def attention_reference_tf32(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The plain version at the precision of the kernel's f32 route: q, k,
    the probabilities and v rounded to TF32 before their product, the
    products summed in f64, the softmax in f32; f32 out. Shapes as
    `attention_reference` (multi-query k/v broadcast in the products)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = (round_to_tf32(x).double() for x in (q, k, v))
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    weights = round_to_tf32(torch.softmax(logits, dim=-1)).double()
    return torch.matmul(weights, v).float()


def _check_operands(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes [B, H, T, D] operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or k.shape[1] not in (1, h):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)} (k/v heads must be 1 or {h})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention, q [B, H, Tq, D], k/v [B, H or 1, Tk, D].

    CUDA tensors launch csrc/flash_attn_fwd.cu (bf16 or f32; any strides
    over batch, head and token, unit stride over D). CPU tensors compute
    `attention_reference`."""
    _check_operands(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_fwd takes bfloat16 or float32, "
                         f"got {q.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_fwd needs unit stride over D")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    esize = q.element_size()
    lanes = 16 // esize  # elements in one 16-byte load

    def kv_head(t):  # multi-query k/v: every head reads head 0
        return t.stride(1) if t.shape[1] == h else 0

    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), kv_head(k), k.stride(2),
               v.stride(0), kv_head(v), v.stride(2))
    vec = int(d % lanes == 0 and all(s % lanes == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    lib = _library()
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), *strides, b, h, tq, tk, d,
                                 float(scale), _DTYPE_CODE[q.dtype], vec,
                                 stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd failed at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}: CUDA error "
                           f"{err} ({msg})")
    FLASH_FWD_LAUNCHES.add((b, h, tq, tk, d, str(q.dtype).split(".")[-1]))
    return out


def flash_tiles(d: int, dtype: torch.dtype):
    """(BQ, BK, shared-memory bytes) the kernel picks at head dim d."""
    lib = _library()
    bq, bk, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not lib.flash_attn_fwd_tiles(d, _DTYPE_CODE[dtype], ctypes.byref(bq),
                                    ctypes.byref(bk), ctypes.byref(smem)):
        raise ValueError(f"no tile fits shared memory at head dim {d}")
    return bq.value, bk.value, smem.value


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL)
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.flash_attn_fwd.argtypes = ([ptr] * 4 + [i64] * 9 + [i32] * 5
                                   + [ctypes.c_float, i32, i32, ptr])
    lib.flash_attn_fwd.restype = i32
    lib.flash_attn_fwd_tiles.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.flash_attn_fwd_tiles.restype = i32
    lib.flash_attn_error_string.argtypes = [i32]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention entry point, [B, H, T, D] layout.

    Unmasked, unbiased attention with Tq, Tk >= 128 takes the flash kernel
    (on a CUDA tensor; its plain version on a CPU tensor). Short rows,
    masks and biases take `attention_reference`, as the JAX package routes
    them to XLA."""
    if (mask is None and bias is None and q.dim() == 4
            and q.shape[-2] >= 128 and k.shape[-2] >= 128):
        return flash_attention_fwd(q, k, v, scale=scale)
    return attention_reference(q, k, v, bias=bias, mask=mask, scale=scale)
