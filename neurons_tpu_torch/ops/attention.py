"""Attention ops: the hand-written CUDA flash-attention forward and backward
and their plain PyTorch versions.

Counterpart of neurons_tpu/ops/attention.py. One entry point,
`dot_product_attention`, serves every attention site in the [B, H, T, D]
layout, and routes as the JAX package does:

  * without autograd (inference): unmasked, unbiased attention with
    Tq, Tk >= 128 goes to `flash_attention_fwd` (csrc/flash_attn_fwd.cu,
    and for bf16 on 16-byte rows at d 32-128 csrc/flash_attn_fwd_sm90.cu,
    at 128 < d <= 512 csrc/flash_attn_fwd_wide_sm90.cu, for f32 on
    16-byte rows at 8 <= d <= 128 csrc/flash_attn_fwd_tf32_sm90.cu,
    replacing the Pallas `_flash_kernel_smallkv` and `_flash_kernel`): the
    UNet2D/UNet3D self- and cross-attention, the DecoderVideo AttnBlock, the
    VAE mid-block attention. Biased attention (the prior's relative-position
    bias) stays on the plain path, as the JAX package keeps its inference
    call on XLA;
  * when autograd records (training): the same unbiased sites, and biased
    attention with multi-query k/v (the prior), go to `flash_attention`, an
    autograd Function whose forward also writes the log-sum-exp (the biased
    forward replaces `_flash_kernel_smallkv_bias`) and whose backward is
    `flash_attention_bwd` (csrc/flash_attn_bwd.cu, and for bf16 without a
    bias at d 32, 64 and 128 on 16-byte rows csrc/flash_attn_bwd_sm90.cu,
    replacing `_flash_bwd_kernel` and `_flash_bwd_bias_kernel`);
  * short rows (< 128 tokens) and masked attention (GPT-2's causal mask)
    take `attention_reference`.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from neurons_tpu_torch.ops import cuda_build
from neurons_tpu_torch.ops.cuda_build import LaunchCounter

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# incremented by flash_attention_fwd / flash_attention_bwd where they launch
# their kernels, and nowhere else; keyed by (B, H, Tq, Tk, D, dtype,
# variant): the forward's variant is "", "lse", "bias" or "bias+lse", the
# backward's "" or "bias", with "headbias" for "bias" where the launch has
# the head-bias layout (`head_bias_layout`: the prior's); `by_route` also by
# the kernels of each launch (`flash_route`, `flash_bwd_route`)
FLASH_FWD_LAUNCHES = LaunchCounter()
FLASH_BWD_LAUNCHES = LaunchCounter()


def _logits(q, k, bias, mask, scale):
    """f32 (f64 for f64 operands) logits q k^T * scale + bias, masked;
    multi-query k broadcast over q's heads."""
    if (q.dim() == 4 and k.dim() == 4 and k.shape[1] == 1
            and q.shape[1] != 1):
        k = k.expand(q.shape[:2] + k.shape[2:])
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(acc)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    return logits


def _weighted(weights, q, v):
    if (q.dim() == 4 and v.dim() == 4 and v.shape[1] == 1
            and q.shape[1] != 1):
        v = v.expand(q.shape[:2] + v.shape[2:])
    return torch.matmul(weights.to(v.dtype), v).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v with f32 logits and softmax (f64 for
    f64 operands) — the plain version of the JAX package's `xla_attention`.

    q: [..., Tq, D], k/v: [..., Tk, D]; bias/mask broadcastable to
    [..., Tq, Tk] (mask True = keep). Multi-query: rank-4 k/v may carry 1
    where q carries H on the head axis."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, bias, mask, scale)
    return _weighted(torch.softmax(logits, dim=-1), q, v)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attention_reference` and the per-row log-sum-exp [..., Tq] of the
    scaled and biased logits, f32 (f64 for f64 operands): the plain version
    of the kernel's training forward (the JAX convention m + log(l))."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, bias, None, scale)
    out = _weighted(torch.softmax(logits, dim=-1), q, v)
    return out, torch.logsumexp(logits, dim=-1)


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), kept in f32: what the kernel's f32 route does to each operand of
    its tensor-core products (cvt.rna.tf32.f32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 and the products summed in
    f64, f32 out: one of the kernels' tensor-core products on f32 input."""
    return torch.matmul(round_to_tf32(a).double(),
                        round_to_tf32(b).double()).float()


def attention_reference_tf32(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             scale: Optional[float] = None,
                             bias: Optional[torch.Tensor] = None,
                             return_lse: bool = False):
    """The plain version at the precision of the kernel's f32 route: q, k,
    the probabilities and v rounded to TF32 before their product, the
    products summed in f64, the bias and softmax in f32; f32 out (and the
    f32 log-sum-exp with `return_lse`). Shapes as `attention_reference`
    (multi-query k/v broadcast in the products)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[1] == 1 and q.shape[1] != 1:
        k = k.expand(q.shape[:2] + k.shape[2:])
        v = v.expand(q.shape[:2] + v.shape[2:])
    logits = _tf32_matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    out = _tf32_matmul(torch.softmax(logits, dim=-1), v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor],
                                  g: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, scale: float,
                                  tf32: bool = False):
    """The plain version of the flash backward: (dq, dk, dv, dbias) from the
    forward's output and log-sum-exp, recomputing p = exp(s - lse), with the
    JAX package's roundings (neurons_tpu/ops/attention.py:318-333,
    :489-507): g cast to q's type, p cast to v's type before p^T g, ds*scale
    cast to k's type before the dk and dq products, f32 accumulation (f64
    for f64), dbias from the unscaled ds summed over the bias's broadcast
    axes and cast to its type. Multi-query k/v [B, 1, Tk, D]: the per-head
    dk/dv, in k's type, summed over heads in f32. `tf32=True` (f32 input):
    every product's operands rounded to TF32 and summed in f64, as the
    kernel's f32 route multiplies."""
    b, h = q.shape[:2]
    mq = k.shape[1] == 1 and h > 1
    acc = torch.promote_types(q.dtype, torch.float32)
    if tf32:
        mm = _tf32_matmul
    else:
        def mm(x, y):
            return torch.matmul(x.to(acc), y.to(acc))
    kx = k.expand(q.shape[:2] + k.shape[2:]) if mq else k
    vx = v.expand(q.shape[:2] + v.shape[2:]) if mq else v
    gx = g.to(q.dtype)
    s = mm(q, kx.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc)
    p = torch.exp(s - lse.to(acc)[..., None])
    delta = (g.to(acc) * out.to(acc)).sum(-1, keepdim=True)
    dv = mm(p.to(v.dtype).transpose(-1, -2), gx)
    ds_u = p * (mm(gx, vx.transpose(-1, -2)) - delta)
    ds = (ds_u * scale).to(k.dtype)
    dk = mm(ds.transpose(-1, -2), q)
    dq = mm(ds, kx)
    dbias = None
    if bias is not None:
        dbias = ds_u.sum_to_size(bias.shape).to(bias.dtype)
    if mq:
        dk = dk.to(k.dtype).to(acc).sum(1, keepdim=True)
        dv = dv.to(v.dtype).to(acc).sum(1, keepdim=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check_operands(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, T, D] operands, got "
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


def _check_cuda(q, *others):
    """The launch's common requirements: a CUDA device, bf16 or f32, unit
    stride over D."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if any(t.stride(-1) != 1 for t in (q,) + others):
        raise ValueError("flash attention needs unit stride over D")


def _bias_slices(bias: torch.Tensor, b: int, h: int, tq: int, tk: int,
                 dtype: torch.dtype):
    """The bias as [N, Tq, Tk] slices with unit stride over keys, and the
    kernels' bias mode: 1 = one slice ([Tq, Tk]), 2 = one per head
    ([H, Tq, Tk], shared over the batch), 3 = one per (b, h)."""
    if bias.dim() < 2 or bias.dim() > 4 or tuple(bias.shape[-2:]) != (tq, tk):
        raise ValueError(f"bias {tuple(bias.shape)} is not [..., {tq}, {tk}]")
    if bias.dtype != dtype or bias.device.type != "cuda":
        raise ValueError(f"bias must be a CUDA {dtype} tensor, got "
                         f"{bias.dtype} on {bias.device}")
    b4 = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    nb, nh = b4.shape[:2]
    if nb == 1 and nh == 1:
        mode = 1
    elif nb == 1 and nh == h:
        mode = 2
    elif nb == b and nh == h:
        mode = 3
    else:
        raise ValueError(f"bias {tuple(bias.shape)}: batch/head dims must "
                         f"be 1 or q's ({b}, {h}), a batch of 1 with heads")
    b3 = b4.reshape(nb * nh, tq, tk)
    if b3.stride(-1) != 1:
        b3 = b3.contiguous()
    return b3, mode


def _granule(d, esize, strides, tensors) -> int:
    """The bytes every row can move in, 16, 8 or 4 (the row's bytes, the
    token strides and the pointers all multiples of it), else 0."""
    for g in (16, 8, 4):
        if (d * esize % g == 0 and all(s * esize % g == 0 for s in strides)
                and all(t.data_ptr() % g == 0 for t in tensors)):
            return g
    return 0


def _kv_strides(t, h):  # multi-query k/v: every head reads head 0
    return (t.stride(0), t.stride(1) if t.shape[1] == h else 0, t.stride(2))


def head_bias_layout(bias3: torch.Tensor, mode: int, h: int, kv_heads: int,
                     granule: int) -> bool:
    """Whether a biased launch has the layout of the prior's, which the
    head-bias wgmma kernels take (with bf16, d <= 64 and Tk <= 576:
    `flash_route`): one bias slice a head shared over the batch (mode 2) over
    multi-query k/v, rows, strides and pointers of q, k, v (and g) on 8
    bytes, the bias rows on 4 (even strides, unit key stride, an aligned
    pointer). Decided from shapes, strides and pointers only."""
    return (mode == 2 and kv_heads == 1 and h > 1 and granule >= 8
            and bias3.stride(0) % 2 == 0 and bias3.stride(1) % 2 == 0
            and bias3.data_ptr() % 4 == 0)


def _raise_on(err, lib_error, name, q, k):
    if err != 0:
        msg = lib_error(err).decode()
        raise RuntimeError(f"{name} failed at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}: CUDA error {err} "
                           f"({msg})")


def _bias_variant(head_bias: bool) -> str:
    return "headbias" if head_bias else "bias"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None,
                        bias: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """Non-causal attention, q [B, H, Tq, D], k/v [B, H or 1, Tk, D], with
    an optional additive bias [Tq, Tk], [H, Tq, Tk] or [B, H, Tq, Tk] (after
    the scale). With `return_lse` also the log-sum-exp [B, H, Tq] f32 of the
    scaled and biased logits (the JAX convention m + log(max(l, 1e-30))).

    CUDA tensors launch the kernel `flash_route` names: bf16 unbiased on
    16-byte rows at d 32-128 csrc/flash_attn_fwd_sm90.cu (wgmma, TMA), and
    without the lse at 128 < d <= 512 csrc/flash_attn_fwd_wide_sm90.cu
    (wgmma, TMA; where `wide_wgmma_parts` splits the keys into parts, one
    launch of the route is the kernel and its combine), bf16 with the
    prior's head bias (`head_bias_layout`) at d <= 64, Tk <= 576
    csrc/flash_attn_fwd_bias_sm90.cu (wgmma, 8-byte cp.async), f32 on
    16-byte rows at 8 <= d <= 128, d % 4 == 0 (biased or not, with or
    without the lse) csrc/flash_attn_fwd_tf32_sm90.cu (TF32 wgmma, TMA;
    `tf32_wgmma_consumers` warpgroups a block by the shape),
    the rest csrc/flash_attn_fwd.cu (bf16 or f32, the bias in the same
    type; any strides over batch, head and token, unit stride over D). CPU
    tensors compute the plain version."""
    _check_operands(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if return_lse:
            return attention_reference_lse(q, k, v, bias=bias, scale=scale)
        return attention_reference(q, k, v, bias=bias, scale=scale)
    _check_cuda(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    strides = ((q.stride(0), q.stride(1), q.stride(2))
               + _kv_strides(k, h) + _kv_strides(v, h))
    bias_ptr, bias_strides, mode = None, (0, 0), 0
    vec = _granule(d, q.element_size(), strides, (q, k, v))
    head_bias = False
    if bias is not None:
        bias3, mode = _bias_slices(bias, b, h, tq, tk, q.dtype)
        bias_ptr, bias_strides = bias3.data_ptr(), bias3.stride()[:2]
        head_bias = head_bias_layout(bias3, mode, h, k.shape[1], vec)
    route = flash_route(d, q.dtype, biased=bias is not None,
                        aligned=vec == 16 and scale > 0 and _tma_strides(
                            strides, (b, h, tq) + (b, k.shape[1], tk) * 2,
                            q.element_size()),
                        lse=return_lse, head_bias=head_bias, tk=tk)
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    if route == WGMMA_ROUTE:
        lib = _library("flash_attn_fwd_sm90")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, *strides, b, h, k.shape[1], tq, tk, d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_fwd_sm90_error_string,
                  "flash_attn_fwd_sm90", q, k)
    elif route == WIDE_WGMMA_ROUTE:
        parts, part_tiles, units = wide_wgmma_parts(b, h, tq, tk)
        grid = min(units, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        scratch = wide_wgmma_scratch(b, h, tq, tk, d)
        work = (torch.empty(scratch, dtype=torch.uint8, device=q.device)
                if scratch else None)
        lib = _library("flash_attn_fwd_wide_sm90")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_fwd_wide_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(),
                0 if work is None else work.numel(), *strides, b, h,
                k.shape[1], tq, tk, d, parts, part_tiles, grid, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_fwd_wide_sm90_error_string,
                  "flash_attn_fwd_wide_sm90", q, k)
    elif route == BIAS_WGMMA_ROUTE:
        lib = _library("flash_attn_fwd_bias_sm90")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_fwd_bias_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                out.data_ptr(), lse_ptr, q.stride(0), q.stride(1),
                q.stride(2), k.stride(0), k.stride(2), v.stride(0),
                v.stride(2), *bias_strides, b, h, tq, tk, d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_fwd_bias_sm90_error_string,
                  "flash_attn_fwd_bias_sm90", q, k)
    elif route == TF32_WGMMA_ROUTE:
        lib = _library("flash_attn_fwd_tf32_sm90")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_fwd_tf32_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bias_ptr, lse_ptr, *strides, *bias_strides, mode, b, h,
                k.shape[1], tq, tk, d, tf32_wgmma_consumers(b, h, tq, d),
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_fwd_tf32_sm90_error_string,
                  "flash_attn_fwd_tf32_sm90", q, k)
    else:
        lib = _library("flash_attn_fwd")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bias_ptr, lse_ptr, *strides, *bias_strides, mode, b, h, tq,
                tk, d, float(scale), _DTYPE_CODE[q.dtype], vec,
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_error_string, "flash_attn_fwd", q, k)
    variant = "+".join([_bias_variant(head_bias)] * (bias is not None)
                       + ["lse"] * return_lse)
    FLASH_FWD_LAUNCHES.add((b, h, tq, tk, d, str(q.dtype).split(".")[-1],
                            variant), route)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], g: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, scale: float):
    """Gradients (dq, dk, dv, dbias) of `flash_attention_fwd` from its
    output and log-sum-exp; dbias is None without a bias. Multi-query k/v
    get their gradients summed over heads, in f32.

    CUDA tensors launch the kernels `flash_bwd_route` names: bf16 unbiased
    at d 32, 64 and 128 on 16-byte rows csrc/flash_attn_bwd_sm90.cu (wgmma,
    TMA), bf16 with the prior's head bias (`head_bias_layout`) at d <= 64,
    Tk <= 576 csrc/flash_attn_bwd_bias_sm90.cu (wgmma; dq, the head-summed
    dk/dv and the batch-summed dbias written by the kernels in bf16), f32
    on 16-byte rows at 8 <= d <= 128 (d % 4 == 0) unbiased, or with the
    prior's head bias at d <= 64 and Tk <= 576,
    csrc/flash_attn_bwd_tf32_sm90.cu (TF32 wgmma, TMA; the outputs of the
    bf16 wgmma kernels, in f32), the rest csrc/flash_attn_bwd.cu. For the
    register kernels delta = sum(g *
    out) is taken here in f32, as the JAX package takes it outside its
    kernel (the wgmma kernels take it in their dQ pass); the register
    kernels write dq in q's type, per-(b, h) dk/dv and dbias in f32 (the
    unbiased wgmma kernels dk and dv in q's type unless k/v are
    multi-query), which are summed and cast here. CPU tensors compute
    `flash_attention_bwd_reference`."""
    _check_operands(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, g, out, lse,
                                             scale)
    _check_cuda(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(lse.shape) != (b, h, tq) or tuple(g.shape) != (b, h, tq, d):
        raise ValueError(f"lse {tuple(lse.shape)} / g {tuple(g.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    lse = lse.float().contiguous()
    g = g.to(q.dtype).contiguous()
    out = out.contiguous()
    strides = ((q.stride(0), q.stride(1), q.stride(2))
               + _kv_strides(k, h) + _kv_strides(v, h)
               + (g.stride(0), g.stride(1), g.stride(2)))
    bias_ptr, bias_strides, mode, dbias = None, (0, 0), 0, None
    if bias is not None:
        bias3, mode = _bias_slices(bias, b, h, tq, tk, q.dtype)
        bias_ptr, bias_strides = bias3.data_ptr(), bias3.stride()[:2]
    vec = _granule(d, q.element_size(), strides, (q, k, v, g))
    hkv = k.shape[1]
    head_bias = (bias is not None and out.dtype == q.dtype
                 and out.data_ptr() % 8 == 0
                 and head_bias_layout(bias3, mode, h, hkv, vec))
    route = flash_bwd_route(
        d, q.dtype, biased=bias is not None,
        aligned=(vec == 16 and scale > 0 and out.dtype == q.dtype
                 and out.data_ptr() % 16 == 0 and _tma_strides(
                     strides, (b, h, tq) + (b, hkv, tk) * 2 + (b, h, tq),
                     q.element_size())),
        head_bias=head_bias, tk=tk)
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if route in (BWD_BIAS_WGMMA_ROUTE, TF32_BWD_BIAS_WGMMA_ROUTE):
        # the bf16 or the TF32 head-bias kernels (one C signature)
        dk, dv = (torch.empty((b, 1, tk, d), dtype=q.dtype, device=q.device)
                  for _ in range(2))
        dbias = torch.empty(bias3.shape, dtype=q.dtype, device=q.device)
        src = _WGMMA_BWD_SOURCES[route]
        name = ("flash_attn_bwd_bias_sm90" if route == BWD_BIAS_WGMMA_ROUTE
                else "flash_attn_bwd_bias_tf32_sm90")
        lib = _library(src)
        with cuda_build.on_device(q.device):
            err = getattr(lib, name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                out.data_ptr(), bias_ptr, lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dbias.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(2), v.stride(0), v.stride(2),
                g.stride(0), g.stride(1), g.stride(2), *bias_strides, b, h,
                tq, tk, d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, getattr(lib, f"{src}_error_string"), name, q, k)
    elif route in (BWD_WGMMA_ROUTE, TF32_BWD_WGMMA_ROUTE):
        # the bf16 or the TF32 unbiased kernels (one C signature)
        kv_dtype = torch.float32 if hkv != h else q.dtype
        dk, dv = (torch.empty((b, h, tk, d), dtype=kv_dtype, device=q.device)
                  for _ in range(2))
        name = _WGMMA_BWD_SOURCES[route]
        lib = _library(name)
        with cuda_build.on_device(q.device):
            err = getattr(lib, name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
                b, h, hkv, tq, tk, d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, getattr(lib, f"{name}_error_string"), name, q, k)
    else:
        torch.sum(g.float() * out.float(), -1, out=delta)
        dk, dv = (torch.empty((b, h, tk, d), dtype=torch.float32,
                              device=q.device) for _ in range(2))
        if bias is not None:
            dbias = torch.empty(bias3.shape, dtype=torch.float32,
                                device=q.device)
        lib = _library("flash_attn_bwd")
        with cuda_build.on_device(q.device):
            err = lib.flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), bias_ptr, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(),
                None if dbias is None else dbias.data_ptr(), *strides,
                *bias_strides, mode, b, h, tq, tk, d, float(scale),
                _DTYPE_CODE[q.dtype], vec,
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, lib.flash_attn_bwd_error_string, "flash_attn_bwd", q,
                  k)
    FLASH_BWD_LAUNCHES.add((b, h, tq, tk, d, str(q.dtype).split(".")[-1],
                            _bias_variant(head_bias) if bias is not None
                            else ""), route)
    if dk.shape[1] != hkv:  # multi-query: the shared row's gradient
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    if dbias is not None:
        dbias = dbias.reshape(bias.shape).to(bias.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's custom-VJP
    `flash_attention`): the forward keeps its output and log-sum-exp, the
    backward recomputes the probabilities from them. Both passes are pure
    functions of their inputs, so a checkpointed region may run the forward
    twice."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, g, out, lse,
                                                ctx.scale)
        return dq, dk, dv, dbias, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """`flash_attention_fwd` under autograd, with `flash_attention_bwd` as
    its backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bias, float(scale))


# the forward's kernels by the code `flash_attn_fwd_tiles` returns (6, the
# TF32 wgmma kernel of csrc/flash_attn_fwd_tf32_sm90.cu, by `flash_route`
# alone), and the backward's (its dK/dV and dQ passes) by
# `flash_attn_bwd_tiles`'s
FWD_ROUTES = {1: "flash_fwd_kernel", 2: "flash_fwd_reg_kernel",
              3: "flash_fwd_wide_kernel", 4: "flash_fwd_tf32_kernel",
              5: "flash_fwd_wide_tf32_kernel",
              6: "flash_fwd_tf32_wgmma_kernel"}
BWD_ROUTES = {1: "flash_bwd_dkdv_kernel+flash_bwd_dq_kernel",
              2: "flash_bwd_dkdv_reg_kernel+flash_bwd_dq_reg_kernel",
              3: ("flash_bwd_dkdv_wide_tf32_kernel"
                  "+flash_bwd_dq_wide_tf32_kernel"),
              4: "flash_bwd_dkdv_tf32_kernel+flash_bwd_dq_tf32_kernel"}


def _tiles(d, dtype, kernel):
    lib = _library(kernel)
    bq, bk, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = getattr(lib, f"{kernel}_tiles")(d, _DTYPE_CODE[dtype],
                                           ctypes.byref(bq), ctypes.byref(bk),
                                           ctypes.byref(smem))
    if not code:
        raise ValueError(f"no tile fits shared memory at head dim {d}")
    return code, (bq.value, bk.value, smem.value)


def flash_tiles(d: int, dtype: torch.dtype, kernel: str = "flash_attn_fwd"):
    """(BQ, BK, shared-memory bytes) the forward (or, with kernel=
    "flash_attn_bwd", the backward) picks at head dim d."""
    return _tiles(d, dtype, kernel)[1]


def wgmma_plan(d: int):
    """(BQ, BK, BW, NB, ring stages, shared-memory bytes) of the wgmma
    kernel's instance at head dim d, as the library reports it; None where
    no instance serves d."""
    lib = _library("flash_attn_fwd_sm90")
    out = [ctypes.c_int() for _ in range(6)]
    if not lib.flash_attn_fwd_sm90_plan(d, *map(ctypes.byref, out)):
        return None
    return tuple(o.value for o in out)


@functools.lru_cache(maxsize=None)
def flash_route(d: int, dtype: torch.dtype, biased: bool = False,
                aligned: bool = True, lse: bool = False,
                head_bias: bool = False, tk: int = 0) -> str:
    """The forward's kernel for a launch at head dim d (by default an
    unbiased one without the lse whose rows, strides and pointers are
    16-byte multiples, as every inference launch of the paths is, with a
    positive scale): bf16 at the head dims `wgmma_blocks` serves the wgmma
    kernel (csrc/flash_attn_fwd_sm90.cu), and without the lse at 128 < d
    <= 512, d a multiple of 64, the wide wgmma kernel (csrc/
    flash_attn_fwd_wide_sm90.cu); bf16 biased with the prior's layout
    (`head_bias`: `head_bias_layout`) at d <= 64 and 0 < tk <= 576 keys the
    head-bias wgmma kernel (csrc/flash_attn_fwd_bias_sm90.cu); f32 at
    8 <= d <= 128, d % 4 == 0 (biased or not, with or without the lse)
    the TF32 wgmma kernel (csrc/flash_attn_fwd_tf32_sm90.cu), off TMA's
    alignment or at d 4 the TF32 register kernel, up to 512 the TF32
    column-split one; the rest of bf16 up to 128 the register kernel
    (biased past d 96 the column-split one), up to 512 the column-split
    one (biased, with the lse, off TMA's alignment, or at a d between
    multiples of 64). The first design
    (`flash_fwd_kernel`) is left for d past 512 only."""
    if takes_head_bias_kernels(d, dtype, biased, head_bias, tk):
        return BIAS_WGMMA_ROUTE
    if dtype == torch.bfloat16 and not biased and aligned:
        if wgmma_blocks(d) is not None:
            return WGMMA_ROUTE
        if not lse and 128 < d <= 512 and d % 64 == 0:
            return WIDE_WGMMA_ROUTE
    if dtype == torch.float32 and aligned and tf32_wgmma_dn(d):
        return TF32_WGMMA_ROUTE
    if dtype == torch.bfloat16 and 96 < d <= 512 and (biased or d > 128):
        return FWD_ROUTES[3]
    if dtype == torch.float32 and 128 < d <= 512:
        return FWD_ROUTES[5]
    return FWD_ROUTES[_tiles(d, dtype, "flash_attn_fwd")[0]]


# The head-bias wgmma kernels (csrc/flash_attn_fwd_bias_sm90.cu,
# csrc/flash_attn_bwd_bias_sm90.cu; the prior's biased multi-query
# attention): one instance by DN, the N of the products over the head dim
# (d rounded up to 8: 32 up to d 32, 56 up to 56, 64 up to 64), d a multiple
# of 4 (8-byte rows); K/V (forward) and the dbias accumulator (backward)
# whole in shared memory, so at most BIAS_WGMMA_MAX_TK keys. The forward: 3
# warpgroups of 64 query rows a block (BIAS_WGMMA_BQ), key tiles of 64. The
# backward: pass 1 (dQ, delta, dbias) a block of two warpgroups a (head, 64
# queries); pass 2 (dK/dV) a block of one warpgroup a (batch row, 64 keys,
# head group), BIAS_WGMMA_GROUPS head groups a cluster, BIAS_WGMMA_MIN_BLOCKS
# blocks an SM. The card tests hold these to the library's own
# (`bias_wgmma_plan`).
BIAS_WGMMA_ROUTE = "flash_fwd_bias_wgmma_kernel"
BWD_BIAS_WGMMA_ROUTE = ("flash_bwd_dq_bias_wgmma_kernel"
                        "+flash_bwd_dkdv_bias_wgmma_kernel")
BIAS_WGMMA_BQ, BIAS_WGMMA_BK, BIAS_WGMMA_MAX_TILES = 192, 64, 9
BIAS_WGMMA_MAX_TK = BIAS_WGMMA_BK * BIAS_WGMMA_MAX_TILES
BIAS_WGMMA_GROUPS, BIAS_WGMMA_MIN_BLOCKS = 4, 3


def bias_wgmma_dn(d: int) -> int:
    """DN of the head-bias wgmma instance serving head dim d; 0 where none
    does (d past 64, or not a multiple of 4)."""
    if d <= 0 or d > 64 or d % 4:
        return 0
    return 32 if d <= 32 else 56 if d <= 56 else 64


def takes_head_bias_kernels(d: int, dtype: torch.dtype, biased: bool,
                            head_bias: bool, tk: int) -> bool:
    """Whether a launch takes the head-bias wgmma kernels (forward and
    backward alike): bf16, biased with the prior's layout (`head_bias`), d
    <= 64 a multiple of 4, 0 < tk <= BIAS_WGMMA_MAX_TK."""
    return (dtype == torch.bfloat16 and biased and head_bias
            and bias_wgmma_dn(d) > 0 and 0 < tk <= BIAS_WGMMA_MAX_TK)


def bias_wgmma_grids(b: int, h: int, tq: int, tk: int):
    """The head-bias kernels' grids at a shape: (the forward's blocks, the
    backward's pass-1 blocks, its pass-2 blocks)."""
    nq, nk = -(-tq // 64), -(-tk // 64)
    return (-(-tq // BIAS_WGMMA_BQ) * b * h, h * nq,
            b * nk * BIAS_WGMMA_GROUPS)


def bias_wgmma_smem(d: int):
    """The head-bias kernels' shared memory at head dim d, as their configs
    lay it out: (the forward's, pass 1's, pass 2's) bytes, each with the
    1024-byte alignment slack."""
    dn, tile = bias_wgmma_dn(d), 64 * 128
    fwd = (BIAS_WGMMA_BQ * 128 + 2 * BIAS_WGMMA_MAX_TILES * tile
           + 8 * BIAS_WGMMA_MAX_TILES + 1024)
    dq = BIAS_WGMMA_MAX_TILES * 32 * 128 * 4 + 8 * tile + dn // 2 * 512 + 1024
    dkdv = 2 * tile + 4 * tile + 2 * 2 * 64 * 4 + 2 * 64 * 72 * 2 + 1024
    return fwd, dq, dkdv


def bias_wgmma_plan(d: int):
    """The head-bias kernels' plans at head dim d as the libraries report
    them: ((DN, query rows a block, keys a tile, the most key tiles, threads,
    shared memory) of the forward, (DN, queries a pass-1 block, its threads,
    its shared memory, keys a pass-2 block, head groups, blocks an SM, its
    threads, its shared memory) of the backward); None where no instance
    serves d."""
    fwd = _library("flash_attn_fwd_bias_sm90")
    bwd = _library("flash_attn_bwd_bias_sm90")
    a = [ctypes.c_int() for _ in range(6)]
    c = [ctypes.c_int() for _ in range(9)]
    if not fwd.flash_attn_fwd_bias_sm90_plan(d, *map(ctypes.byref, a)):
        return None
    if not bwd.flash_attn_bwd_bias_sm90_plan(d, *map(ctypes.byref, c)):
        return None
    return tuple(x.value for x in a), tuple(x.value for x in c)


# The wgmma kernel's instances by head dim: (BW, NB), NB column blocks of
# BW bf16, each one swizzled shared-memory row of 2 BW bytes (the swizzle
# mode), the head dim padded to BW * NB (csrc/flash_attn_fwd_sm90.cu:
# column_blocks). No instance at d 56, 104 or 112 (no path launches them):
# the register kernel takes them.
WGMMA_ROUTE = "flash_fwd_wgmma_kernel"


def wgmma_blocks(d: int):
    """(BW, NB) of the wgmma instance serving head dim d, or None."""
    if d < 32 or d > 128 or d % 8:
        return None
    if d <= 32:
        return 32, 1
    if d <= 48:
        return 16, 3
    if d == 64:
        return 64, 1
    if 64 < d <= 80:
        return 16, 5
    if 80 < d <= 96:
        return 32, 3
    if d >= 120:
        return 64, 2
    return None


def wgmma_tiles(d: int):
    """(BQ, BK, ring stages) of the wgmma instance at head dim d (WgCfg): 3
    consumer warpgroups of 64 query rows up to d 64, 2 past it; 128 keys a
    tile up to d 80, 64 past it; 2 stages."""
    bw, nb = wgmma_blocks(d)
    dk = bw * nb
    return (192 if dk <= 64 else 128), (128 if dk <= 80 else 64), 2


# The TF32 wgmma kernel (csrc/flash_attn_fwd_tf32_sm90.cu: Tf32Cfg): one
# instance by DN, the head dim rounded up to 8 (8 <= d <= 128, d % 4 ==
# 0), and consumer warpgroups of 64 query rows (1, 2 or 3) a block; column
# blocks of BW floats (8 up to DN 16, 16 up to 32, else 32: at most d, as
# a TMA box must be); key tiles of 64 up to DN 64, else 32; a ring of 3
# stages, 2 with one consumer at DN <= 64, whose blocks fit two an SM. One
# consumer while its 64-row blocks fit TF32_WGMMA_WAVES waves of
# TF32_WGMMA_SMS SMs at DN <= 64 (two blocks an SM), one wave past it (one
# an SM); past that `tf32_wgmma_many(d)`: 3 at DN <= 64, 2 past it (O's
# registers). The card tests hold these to the library's own
# (`tf32_wgmma_plan`).
TF32_WGMMA_ROUTE = "flash_fwd_tf32_wgmma_kernel"
TF32_WGMMA_SMS, TF32_WGMMA_WAVES = 132, 2


def tf32_wgmma_dn(d: int) -> int:
    """DN of the TF32 wgmma instance serving head dim d (d rounded up to
    8); 0 where none does (d below 8, past 128, off a multiple of 4)."""
    if d < 8 or d > 128 or d % 4:
        return 0
    return -(-d // 8) * 8


def tf32_wgmma_many(d: int) -> int:
    """The TF32 wgmma kernel's consumers a block on large grids at head
    dim d: 3 up to DN 64 (192 query rows, 128 registers a thread), else 2
    (O's registers)."""
    return 3 if tf32_wgmma_dn(d) <= 64 else 2


@functools.lru_cache(maxsize=None)
def tf32_wgmma_consumers(b: int, h: int, tq: int, d: int) -> int:
    """Consumer warpgroups a block of the TF32 wgmma kernel at a shape,
    from the shape alone: 1 (64 query rows a block) while those blocks fit
    TF32_WGMMA_WAVES waves of the SMs at d <= 64, where two share an SM,
    or one wave past it; else `tf32_wgmma_many(d)` (one block an SM whose
    warpgroups' products and exponentials overlap). Measured at every f32
    shape of the paths with each count forced
    (tools/torch_flash_fwd_variants.py --consumers, --preset cons2)."""
    blocks = -(-tq // 64) * b * h
    per_sm = 2 if tf32_wgmma_dn(d) <= 64 else 1
    waves = TF32_WGMMA_WAVES if per_sm == 2 else 1
    if blocks <= waves * per_sm * TF32_WGMMA_SMS:
        return 1
    return tf32_wgmma_many(d)


def tf32_wgmma_tiles(d: int, cons: int):
    """(BQ, BK, BW, NB, ring stages, shared-memory bytes, blocks an SM)
    of the TF32 wgmma instance at head dim d with `cons` consumers
    (Tf32Cfg)."""
    dn = tf32_wgmma_dn(d)
    if not dn or cons not in (1, tf32_wgmma_many(d)):
        raise ValueError(f"no TF32 wgmma instance at head dim {d}, "
                         f"{cons} consumers")
    bw, nb = _tf32_columns(dn)
    bq, bk = 64 * cons, 64 if dn <= 64 else 32
    pair = cons == 1 and dn <= 64
    stages = 2 if pair else 3
    smem = (bq * bw * nb * 4 + stages * 2 * bk * bw * nb * 4
            + 8 * (1 + 3 * stages) + 1024)
    return bq, bk, bw, nb, stages, smem, 2 if pair else 1


def tf32_wgmma_plan(d: int, cons: int):
    """`tf32_wgmma_tiles` as the library reports them; None where no
    instance serves d."""
    lib = _library("flash_attn_fwd_tf32_sm90")
    out = [ctypes.c_int() for _ in range(7)]
    if not lib.flash_attn_fwd_tf32_sm90_plan(d, cons,
                                             *map(ctypes.byref, out)):
        return None
    return tuple(o.value for o in out)


# The wide wgmma kernel (csrc/flash_attn_fwd_wide_sm90.cu: WideCfg): units
# of 64 query rows in two consumer warpgroups that split O's 512 columns,
# WIDE_BK keys a tile in a 2-stage ring of 8 column blocks of 64 bf16 (128
# swizzled bytes a row), dealt to a grid of at most one block an SM; where
# the units are few the keys split into parts (`wide_wgmma_parts`, at most
# WIDE_MAX_PARTS), merged by its combine kernel. The card tests hold these to the library's own
# (`wide_wgmma_plan`).
WIDE_WGMMA_ROUTE = "flash_fwd_wide_wgmma_kernel"
WIDE_COMBINE = "flash_fwd_wide_combine_kernel"
WIDE_BQ, WIDE_BK, WIDE_STAGES, WIDE_MAX_PARTS = 64, 32, 2, 8
# the key parts' cost model: the SMs a wave of blocks fills; each part past
# the first costs 1 / WIDE_PART_COST_DEN of a wave; each part at least
# WIDE_MIN_PART_TILES key tiles
WIDE_SMS, WIDE_PART_COST_DEN, WIDE_MIN_PART_TILES = 132, 20, 8


def wide_wgmma_parts(b: int, h: int, tq: int, tk: int):
    """(parts, key tiles a part, units) of the wide wgmma kernel at a
    shape, from the shape alone (a unit: 64 query rows of one (b, h) and
    one part of the keys): one part where the query blocks fill two waves
    of 132 SMs (the parts' f32 O would cost more traffic than the last
    wave's idle SMs), else the parts P, at most 8 and each at least 8
    tiles, that minimise waves(P) / P + (P - 1) / 20 (the units over 132
    SMs rounded up, in integers times 840; the first P of equal cost),
    then the tiles a part and the parts that leave none empty. The
    wrapper passes them to the kernel, with a grid of at most one block
    an SM, and the kernel checks that they cover the keys."""
    nq = -(-tq // WIDE_BQ)
    blocks = nq * b * h
    ntiles = -(-tk // WIDE_BK)
    most = (1 if blocks >= 2 * WIDE_SMS
            else max(1, min(WIDE_MAX_PARTS, ntiles // WIDE_MIN_PART_TILES)))
    parts, best = 1, None
    for n in range(1, most + 1):
        waves = -(-blocks * n // WIDE_SMS)
        cost = 840 * WIDE_PART_COST_DEN * waves // n + 840 * (n - 1)
        if best is None or cost < best:
            parts, best = n, cost
    per = -(-ntiles // parts)
    parts = -(-ntiles // per)
    return parts, per, blocks * parts


def wide_wgmma_scratch(b: int, h: int, tq: int, tk: int, d: int) -> int:
    """The wide wgmma kernel's scratch bytes at a shape: each part's f32
    O and each row's (max, sum); 0 with one part."""
    parts = wide_wgmma_parts(b, h, tq, tk)[0]
    return 0 if parts == 1 else parts * b * h * tq * (4 * d + 8)


def wide_wgmma_plan():
    """(BQ, BK, ring stages, the most key parts, shared-memory bytes) of
    the wide wgmma kernel, as the library reports them."""
    lib = _library("flash_attn_fwd_wide_sm90")
    out = [ctypes.c_int() for _ in range(5)]
    lib.flash_attn_fwd_wide_sm90_plan(*map(ctypes.byref, out))
    return tuple(o.value for o in out)


def _tma_strides(strides, extents, esize) -> bool:
    """Every stride over batch, head and token (q's, k's, v's) a multiple
    of 16 bytes where its extent passes 1 (a TMA map's strides); the rows
    and pointers are `_granule`'s."""
    return all(st * esize % 16 == 0 or n == 1
               for st, n in zip(strides, extents))


@functools.lru_cache(maxsize=None)
def flash_bwd_route(d: int, dtype: torch.dtype, biased: bool = False,
                    aligned: bool = True, head_bias: bool = False,
                    tk: int = 0) -> str:
    """The backward's kernels for a launch at head dim d (by default an
    unbiased one whose rows, strides and pointers are 16-byte multiples,
    with a positive scale), decided from shapes and strides only: bf16
    unbiased and aligned at d 32, 64 and 128 the wgmma kernels (csrc/
    flash_attn_bwd_sm90.cu); bf16 biased with the prior's layout
    (`head_bias`: `head_bias_layout`) at d <= 64 and 0 < tk <= 576 keys the
    head-bias wgmma kernels (csrc/flash_attn_bwd_bias_sm90.cu); the rest of
    bf16 up to d = 128 the register
    kernels (a bias shared by several rows adds
    `flash_bwd_dbias_reg_kernel`); f32 up to d = 128 the TF32 register
    kernels (biased too, with `flash_bwd_dbias_tf32_kernel` for a shared
    slice), unbiased f32 at 128 < d <= 512 the TF32 column-split ones;
    f32 aligned at 8 <= d <= 128, d % 4 == 0, unbiased the TF32 wgmma
    kernels (csrc/flash_attn_bwd_tf32_sm90.cu), and biased with the prior's
    layout at d <= 64 and 0 < tk <= 576 keys their head-bias kernels (the
    other f32 bias layouts, rows off TMA's alignment and d 4 keep the TF32
    register kernels). The first design takes the rest: a biased f32
    launch past 128 and d past 512 (no path launches either)."""
    if takes_head_bias_kernels(d, dtype, biased, head_bias, tk):
        return BWD_BIAS_WGMMA_ROUTE
    if (dtype == torch.bfloat16 and not biased and aligned
            and d in WGMMA_BWD_DIMS):
        return BWD_WGMMA_ROUTE
    if dtype == torch.float32 and aligned and tf32_wgmma_dn(d):
        if not biased:
            return TF32_BWD_WGMMA_ROUTE
        if (head_bias and tf32_wgmma_dn(d) <= 64
                and 0 < tk <= TF32_BWD_BIAS_MAX_TK):
            return TF32_BWD_BIAS_WGMMA_ROUTE
    if dtype == torch.bfloat16 and 0 < d <= 128:  # flash_attn_bwd's reg_dk
        return BWD_ROUTES[2]
    if dtype == torch.float32 and biased and d > 128:
        return BWD_ROUTES[1]
    return BWD_ROUTES[_tiles(d, dtype, "flash_attn_bwd")[0]]


# The wgmma backward's instances (csrc/flash_attn_bwd_sm90.cu: BwdCfg): one
# column block of min(d, 64) bf16 at d 32 and 64, two of 64 at d 128; no
# other head dim (no backward of the paths launches one).
BWD_WGMMA_ROUTE = "flash_bwd_dkdv_wgmma_kernel+flash_bwd_dq_wgmma_kernel"
WGMMA_BWD_DIMS = (32, 64, 128)


def wgmma_bwd_tiles(d: int):
    """(keys a dK/dV block, queries a dQ block, queries a dK/dV ring tile,
    keys a dQ ring tile, BW, NB, ring stages) of the wgmma backward's
    instance at head dim d (BwdCfg): consumer warpgroups of 64 rows, 3 in
    the dK/dV pass at d 32 and in the dQ pass up to d 64, else 2 (at d 128
    both on the dK/dV block's 64 keys, one for dV, one for dK); ring tiles
    of 64 rows; 2 stages."""
    if d not in WGMMA_BWD_DIMS:
        raise ValueError(f"no wgmma backward instance at head dim {d}")
    bw = min(d, 64)
    return ({32: 192, 64: 128}.get(d, 64), 192 if d <= 64 else 128, 64, 64,
            bw, d // bw, 2)


def wgmma_bwd_plan(d: int):
    """The wgmma backward's plan at head dim d as the library reports it:
    `wgmma_bwd_tiles` and each pass's shared-memory bytes; None where no
    instance serves d."""
    lib = _library("flash_attn_bwd_sm90")
    out = [ctypes.c_int() for _ in range(9)]
    if not lib.flash_attn_bwd_sm90_plan(d, *map(ctypes.byref, out)):
        return None
    return tuple(o.value for o in out)


# The TF32 wgmma backward (csrc/flash_attn_bwd_tf32_sm90.cu), one instance
# by DN, the head dim rounded up to 8, on the TF32 forward's column blocks.
# Unbiased (BwdTf32Cfg): the dQ pass's blocks of 64 queries a consumer
# warpgroup (3 up to DN 32, else 2), key tiles of 64 (32 past DN 64: dQ's
# registers and the shared memory), 3 stages (2 past DN 64); the dK/dV
# pass's blocks of 64 keys a consumer, two consumers (past DN 64 the two
# share 64 keys, one for dV, one for dK), query tiles of 64 (32 past DN
# 64), 3 stages up to DN 32, else 2. The prior's (BiasTf32Cfg, DN
# <= 64): the dQ pass's blocks of one head's 64 queries, two consumers on
# the even and odd key tiles of 32 keys, 3 stages, the dbias accumulator of
# 64 queries x the key tiles; the dK/dV pass's blocks of one batch row's 64
# keys and one of TF32_BWD_BIAS_GROUPS head groups (a cluster), two
# consumers taking 32-query tiles in turn, 3 stages. The card tests hold
# these to the library's own (`tf32_wgmma_bwd_plan`,
# `tf32_bias_wgmma_bwd_plan`).
TF32_BWD_WGMMA_ROUTE = ("flash_bwd_dq_tf32_wgmma_kernel"
                        "+flash_bwd_dkdv_tf32_wgmma_kernel")
TF32_BWD_BIAS_WGMMA_ROUTE = ("flash_bwd_dq_bias_tf32_wgmma_kernel"
                             "+flash_bwd_dkdv_bias_tf32_wgmma_kernel")
TF32_BWD_BIAS_MAX_TK, TF32_BWD_BIAS_GROUPS = 576, 4
# the library (csrc/<name>.cu) of each wgmma backward route
_WGMMA_BWD_SOURCES = {BWD_WGMMA_ROUTE: "flash_attn_bwd_sm90",
                      BWD_BIAS_WGMMA_ROUTE: "flash_attn_bwd_bias_sm90",
                      TF32_BWD_WGMMA_ROUTE: "flash_attn_bwd_tf32_sm90",
                      TF32_BWD_BIAS_WGMMA_ROUTE: "flash_attn_bwd_tf32_sm90"}


def _tf32_columns(dn: int):
    """(BW, NB) of the TF32 wgmma kernels' column blocks at DN: BW floats
    a block (8 up to DN 16, 16 up to 32, else 32: at most d, as a TMA box
    must be), NB blocks."""
    bw = 8 if dn <= 16 else 16 if dn <= 32 else 32
    return bw, -(-dn // bw)


def tf32_wgmma_bwd_tiles(d: int):
    """(queries a dQ block, keys a dQ ring tile, dQ stages, dQ shared
    memory, keys a dK/dV block, queries a dK/dV ring tile, dK/dV stages,
    dK/dV shared memory, BW, NB) of the unbiased TF32 wgmma backward at
    head dim d (BwdTf32Cfg)."""
    dn = tf32_wgmma_dn(d)
    if not dn:
        raise ValueError(f"no TF32 wgmma backward at head dim {d}")
    bw, nb = _tf32_columns(dn)
    row = bw * nb * 4  # bytes of a tile row
    rows_q = 64 * (3 if dn <= 32 else 2)
    bk, stages_q = (64, 3) if dn <= 64 else (32, 2)
    smem_q = (2 * rows_q * row + stages_q * (2 * bk * row + dn * bk * 4)
              + 8 * (2 + 3 * stages_q) + 1024)
    rows_kv = 64 if dn > 64 else 128
    bq = 64 if dn <= 64 else 32
    stages_kv = 3 if dn <= 32 else 2
    smem_kv = (2 * rows_kv * row
               + stages_kv * (2 * bq * row + 2 * dn * bq * 4 + 2 * bq * 4)
               + 8 * (2 + 3 * stages_kv) + 1024)
    return (rows_q, bk, stages_q, smem_q, rows_kv, bq, stages_kv, smem_kv,
            bw, nb)


def tf32_bias_wgmma_bwd_tiles(d: int, tk: int):
    """(DN, keys a dQ ring tile, dQ stages, dQ shared memory at tk keys,
    head groups, queries a dK/dV ring tile, dK/dV stages, dK/dV shared
    memory) of the prior's TF32 wgmma backward (BiasTf32Cfg)."""
    dn = tf32_wgmma_dn(d)
    if not 0 < dn <= 64 or not 0 < tk <= TF32_BWD_BIAS_MAX_TK:
        raise ValueError(f"no TF32 head-bias backward at head dim {d}, "
                         f"{tk} keys")
    bw, nb = _tf32_columns(dn)
    row = bw * nb * 4
    stage1 = 2 * 32 * row + dn * 32 * 4
    smem1 = -(-tk // 32) * 32 * 64 * 4 + 3 * stage1 + 8 * 3 * 3 + 1024
    stage2 = 2 * 32 * row + 2 * dn * 32 * 4
    smem2 = (2 * 64 * row + 3 * stage2 + 3 * 2 * 32 * 4 + 8 * (2 + 3 * 3)
             + 1024)
    return dn, 32, 3, smem1, TF32_BWD_BIAS_GROUPS, 32, 3, smem2


def tf32_wgmma_bwd_plan(d: int):
    """`tf32_wgmma_bwd_tiles` as the library reports them; None where no
    instance serves d."""
    lib = _library("flash_attn_bwd_tf32_sm90")
    out = [ctypes.c_int() for _ in range(10)]
    if not lib.flash_attn_bwd_tf32_sm90_plan(d, *map(ctypes.byref, out)):
        return None
    return tuple(o.value for o in out)


def tf32_bias_wgmma_bwd_plan(d: int, tk: int):
    """`tf32_bias_wgmma_bwd_tiles` as the library reports them; None where
    no instance serves (d, tk)."""
    lib = _library("flash_attn_bwd_tf32_sm90")
    out = [ctypes.c_int() for _ in range(8)]
    if not lib.flash_attn_bwd_bias_tf32_sm90_plan(d, tk,
                                                  *map(ctypes.byref, out)):
        return None
    return tuple(o.value for o in out)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    return _bind(cuda_build.load(name), name)


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """`lib` (a build of csrc/<name>.cu) with its C functions' types set."""
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    tail = [i32] * 5 + [ctypes.c_float, i32, i32, ptr]  # B..D, scale, dtype, vec, stream
    if name in ("flash_attn_fwd_bias_sm90", "flash_attn_bwd_bias_sm90"):
        fwd = name == "flash_attn_fwd_bias_sm90"
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * (6 if fwd else 12) + [i64] * (9 if fwd else 12)
                       + [i32] * 5 + [ctypes.c_float, ptr])
        fn.restype = i32
        getattr(lib, f"{name}_error_string").argtypes = [i32]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        plan = getattr(lib, f"{name}_plan")
        plan.argtypes = [i32] + [ctypes.POINTER(i32)] * (6 if fwd else 9)
        plan.restype = i32
        return lib
    if name == "flash_attn_bwd_tf32_sm90":
        lib.flash_attn_bwd_tf32_sm90.argtypes = (
            [ptr] * 10 + [i64] * 12 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.flash_attn_bwd_bias_tf32_sm90.argtypes = (
            [ptr] * 12 + [i64] * 12 + [i32] * 5 + [ctypes.c_float, ptr])
        lib.flash_attn_bwd_tf32_sm90_plan.argtypes = (
            [i32] + [ctypes.POINTER(i32)] * 10)
        lib.flash_attn_bwd_bias_tf32_sm90_plan.argtypes = (
            [i32, i32] + [ctypes.POINTER(i32)] * 8)
        for fn in ("flash_attn_bwd_tf32_sm90", "flash_attn_bwd_bias_tf32_sm90",
                   "flash_attn_bwd_tf32_sm90_plan",
                   "flash_attn_bwd_bias_tf32_sm90_plan"):
            getattr(lib, fn).restype = i32
        lib.flash_attn_bwd_tf32_sm90_error_string.argtypes = [i32]
        lib.flash_attn_bwd_tf32_sm90_error_string.restype = ctypes.c_char_p
        return lib
    if name == "flash_attn_bwd_sm90":
        lib.flash_attn_bwd_sm90.argtypes = ([ptr] * 10 + [i64] * 12
                                            + [i32] * 6 + [ctypes.c_float, ptr])
        lib.flash_attn_bwd_sm90.restype = i32
        lib.flash_attn_bwd_sm90_error_string.argtypes = [i32]
        lib.flash_attn_bwd_sm90_error_string.restype = ctypes.c_char_p
        lib.flash_attn_bwd_sm90_plan.argtypes = [i32] + [ctypes.POINTER(i32)] * 9
        lib.flash_attn_bwd_sm90_plan.restype = i32
        return lib
    if name == "flash_attn_fwd_wide_sm90":
        lib.flash_attn_fwd_wide_sm90.argtypes = ([ptr] * 5 + [i64] * 10
                                                 + [i32] * 9
                                                 + [ctypes.c_float, ptr])
        lib.flash_attn_fwd_wide_sm90.restype = i32
        lib.flash_attn_fwd_wide_sm90_error_string.argtypes = [i32]
        lib.flash_attn_fwd_wide_sm90_error_string.restype = ctypes.c_char_p
        lib.flash_attn_fwd_wide_sm90_plan.argtypes = [ctypes.POINTER(i32)] * 5
        lib.flash_attn_fwd_wide_sm90_plan.restype = None
        return lib
    if name == "flash_attn_fwd_tf32_sm90":
        fn = lib.flash_attn_fwd_tf32_sm90
        fn.argtypes = ([ptr] * 6 + [i64] * 11 + [i32] * 8
                       + [ctypes.c_float, ptr])
        fn.restype = i32
        lib.flash_attn_fwd_tf32_sm90_error_string.argtypes = [i32]
        lib.flash_attn_fwd_tf32_sm90_error_string.restype = ctypes.c_char_p
        lib.flash_attn_fwd_tf32_sm90_plan.argtypes = (
            [i32, i32] + [ctypes.POINTER(i32)] * 7)
        lib.flash_attn_fwd_tf32_sm90_plan.restype = i32
        return lib
    if name == "flash_attn_fwd_sm90":
        lib.flash_attn_fwd_sm90.argtypes = ([ptr] * 5 + [i64] * 9 + [i32] * 6
                                            + [ctypes.c_float, ptr])
        lib.flash_attn_fwd_sm90.restype = i32
        lib.flash_attn_fwd_sm90_error_string.argtypes = [i32]
        lib.flash_attn_fwd_sm90_error_string.restype = ctypes.c_char_p
        lib.flash_attn_fwd_sm90_plan.argtypes = [i32] + [ctypes.POINTER(i32)] * 6
        lib.flash_attn_fwd_sm90_plan.restype = i32
        return lib
    if name == "flash_attn_fwd":
        lib.flash_attn_fwd.argtypes = ([ptr] * 6 + [i64] * 11 + [i32]
                                       + tail)
        lib.flash_attn_fwd.restype = i32
        lib.flash_attn_error_string.argtypes = [i32]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    else:
        lib.flash_attn_bwd.argtypes = ([ptr] * 11 + [i64] * 14 + [i32]
                                       + tail)
        lib.flash_attn_bwd.restype = i32
        lib.flash_attn_bwd_error_string.argtypes = [i32]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    tiles = getattr(lib, f"{name}_tiles")
    tiles.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
    tiles.restype = i32
    return lib


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention entry point, [B, H, T, D] layout.

    Unmasked attention with Tq, Tk >= 128 takes the flash kernels (on a
    CUDA tensor; their plain versions on a CPU tensor): without autograd
    the forward when there is no bias; when autograd records, the
    differentiable `flash_attention` when there is no bias or the k/v are
    multi-query (the JAX package's default routing, ops/attention.py:
    1105-1129). Everything else takes `attention_reference`, as the JAX
    package routes it to XLA."""
    if (mask is None and q.dim() == 4 and q.shape[-2] >= 128
            and k.shape[-2] >= 128):
        if _records_grad(q, k, v, bias):
            multi_query = k.shape[1] == 1 and q.shape[1] != 1
            if bias is None or multi_query:
                return flash_attention(q, k, v, bias=bias, scale=scale)
        elif bias is None:
            return flash_attention_fwd(q, k, v, scale=scale)
    return attention_reference(q, k, v, bias=bias, mask=mask, scale=scale)
