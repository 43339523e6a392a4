"""GroupNorm -> SiLU -> 3x3 same-pad conv, the res blocks' norm/conv pairs:
the plain PyTorch version and the hand-written CUDA kernel.

Counterpart of neurons_tpu/ops/fused_conv.py, channels-first (x [N, Cin,
H, W], the conv weight [Cout, Cin, 3, 3] as nn.Conv2d holds it).

`gn_silu_conv` routes as the JAX package does: with
NEURONS_TPU_FUSED_GNCONV=1 (read on every call; off by default) through
`GNSiLUConvFn`, whose forward is `gn_silu_conv_fwd`, else through
`group_norm_silu` (itself routed by NEURONS_TPU_FUSED_NORM) and the conv.
`gn_silu_conv_fwd` takes a CPU tensor to `gn_silu_conv_reference` and a
CUDA tensor to the kernel `conv_route` names, which replaces the Pallas
kernel `_kernel` (neurons_tpu/ops/fused_conv.py:91): bf16 maps that TMA can
address (rows of a multiple of 8 pixels, or whole samples of 8-64 pixels)
csrc/gn_silu_conv_sm90.cu (wgmma, TMA, a producer warpgroup; its launch
plan from `conv_plan_sm90`), the other bf16 maps and f32
csrc/gn_silu_conv.cu; it never falls back. The JAX
package's gates (C % 128, HW >= 1024, an 8 MB sample, the v5e MXU loss at
24x24) are TPU limits and have no counterpart: every shape launches,
Cout = 4 (the UNet head), Cin = 2560 and 4x4 maps at 32 samples included.
The kernel's statistics are the centred two-pass ones of the plain
GroupNorm, not the JAX wrapper's single-pass E[x^2] - mean^2. The
backward differentiates the plain composite, recomputed from the saved
inputs, as the JAX custom VJP does.

The kernels read the conv weight packed once to [9, Kc, Np] (tap, Cin
padded to the K chunk, Cout padded to the N tile, which depends on the
kernel, Cout and the type; the wgmma kernel's in column blocks, [Np / BW,
9, Kc, BW]) in x's type; the packed copy is cached per parameter and
made anew when the parameter changes (another tensor, storage or in-place
version). The bf16 kernels may split their input channels across blocks
where the grid is small; the scratch tensor then also holds the f32
partial sums, reduced in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref
from types import MappingProxyType
from typing import Dict, Mapping, Optional, Tuple

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
# else; keyed by (N, Cin, H, W, Cout, groups, dtype), and by route
GN_SILU_CONV_LAUNCHES = LaunchCounter()

# the kernels a launch may take (`conv_route`)
WGMMA_CONV_ROUTE = "gn_silu_conv_wgmma_kernel"  # csrc/gn_silu_conv_sm90.cu
HALO_CONV_ROUTE = "gn_silu_conv_halo_kernel"    # csrc/gn_silu_conv.cu, bf16
TF32_CONV_ROUTE = "gn_silu_conv_tf32_kernel"    # csrc/gn_silu_conv.cu, f32

# The wgmma kernel's constants (csrc/gn_silu_conv_sm90.cu): output pixels a
# tile, the input channels a K chunk, its N tiles, the deepest weight ring
# (stages of 3 taps: two chunks, where shared memory allows), the taps a
# stage holds, the 227 KB of shared memory a block may use, the staged
# output row's floats, and the order of the plan's ints (its kPlan* enum).
SM90_BM = 128
SM90_CHUNK = 32
SM90_BNS = (16, 160, 256)
SM90_MAX_STAGES = 6
SM90_TAPS_PER_GROUP = 3
SM90_SMEM_LIMIT = 232448
SM90_EPI_LD = 68
SM90_PLAN_KEYS = ("bn", "stages", "mode", "samples", "rb", "wr", "rr",
                  "mtiles", "ntiles", "splits", "cps", "blocks", "smem")


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


def packed_weight(conv_weight: torch.Tensor, dtype: torch.dtype,
                  bn: Optional[int] = None, bw: int = 0) -> torch.Tensor:
    """The conv weight [Cout, Cin, 3, 3] as the kernels read it, [9, Kc, Np]
    in `dtype` (Kc padded to the 32-channel K chunk, Np to the N tile `bn`,
    by default that of `conv_tiles(Cout, dtype)`), zero in the padding; with
    `bw` (the wgmma kernel) in column blocks, [Np / bw, 9, Kc, bw]. Cached
    until the parameter changes."""
    cout, cin = conv_weight.shape[:2]
    if bn is None:
        bn = conv_tiles(cout, dtype)[1]
    # an inference tensor keeps no version counter: it is packed anew
    cached = not conv_weight.is_inference()
    key = id(conv_weight)
    state = (conv_weight.data_ptr(), conv_weight._version if cached else -1,
             dtype, bn, bw)
    hit = _PACKED.get(key)
    if cached and hit is not None and hit[0]() is conv_weight \
            and hit[1:6] == state:
        return hit[6]
    bk = SM90_CHUNK
    kc, npad = -(-cin // bk) * bk, -(-cout // bn) * bn
    with torch.no_grad():
        packed = torch.zeros((9, kc, npad), dtype=dtype,
                             device=conv_weight.device)
        packed[:, :cin, :cout] = conv_weight.detach().permute(2, 3, 1, 0) \
            .reshape(9, cin, cout).to(dtype)
        if bw:
            packed = packed.reshape(9, kc, npad // bw, bw).permute(
                2, 0, 1, 3).contiguous()
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

    CUDA tensors launch the kernel `conv_route` names: bf16 on wgmma
    (csrc/gn_silu_conv_sm90.cu) where TMA can address the map, else the
    staged-halo mma.sync kernel; f32 the TF32 kernel (csrc/gn_silu_conv.cu);
    f32 accumulation throughout. CPU tensors compute
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
    sms = _sm_count(x.device)
    route = conv_route(n, cin, h, w, cout, x.dtype, sms,
                       aligned=x.data_ptr() % 16 == 0)
    y = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    gn_bf16 = int(gn_weight.dtype == torch.bfloat16)
    bias_bf16 = int(conv_bias is not None
                    and conv_bias.dtype == torch.bfloat16)
    bias_ptr = None if conv_bias is None else conv_bias.data_ptr()
    with cuda_build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == WGMMA_CONV_ROUTE:
            plan = conv_plan_sm90(n, cin, h, w, cout, sms)
            bw = sm90_column_block(plan["bn"])
            packed = packed_weight(conv_weight, x.dtype, plan["bn"], bw)
            lib = _library("gn_silu_conv_sm90")
            # the statistics, then (split over Cin) the f32 partial sums
            scratch = torch.empty(lib.gn_silu_conv_sm90_scratch_bytes(
                n, cin, h, w, cout, groups, plan["splits"]),
                dtype=torch.uint8, device=x.device)
            ints = (ctypes.c_int * len(SM90_PLAN_KEYS))(
                *(plan[k] for k in SM90_PLAN_KEYS))
            err = lib.gn_silu_conv_sm90(
                x.data_ptr(), gn_weight.data_ptr(), gn_bias.data_ptr(),
                packed.data_ptr(), bias_ptr, y.data_ptr(),
                scratch.data_ptr(), n, cin, h, w, cout, groups, float(eps),
                packed.shape[2], packed.shape[0] * bw, gn_bf16, bias_bf16,
                ints, stream)
            error_string = lib.gn_silu_conv_sm90_error_string
        else:
            packed = packed_weight(conv_weight, x.dtype)
            lib = _library()
            scratch = torch.empty(lib.gn_silu_conv_scratch_bytes(
                n, cin, h, w, cout, groups, _DTYPE_CODE[x.dtype]),
                dtype=torch.uint8, device=x.device)
            err = lib.gn_silu_conv(
                x.data_ptr(), gn_weight.data_ptr(), gn_bias.data_ptr(),
                packed.data_ptr(), bias_ptr, y.data_ptr(),
                scratch.data_ptr(), n, cin, h, w, cout, groups, float(eps),
                packed.shape[1], packed.shape[2], _DTYPE_CODE[x.dtype],
                gn_bf16, bias_bf16, stream)
            error_string = lib.gn_silu_conv_error_string
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"gn_silu_conv ({route}) failed at "
                           f"{tuple(x.shape)} -> {cout}, {groups} groups, "
                           f"{x.dtype}: CUDA error {err} ({msg})")
    GN_SILU_CONV_LAUNCHES.add((n, cin, h, w, cout, groups,
                               str(x.dtype).split(".")[-1]), route)
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
    """(BM, BN, BK) of the staged-halo (bf16) or TF32 kernel's tiles for
    `cout` output channels in `dtype` (csrc/gn_silu_conv.cu): the output
    pixels a block owns, the N tile (the packed weights pad Cout to it) and
    the K chunk (they pad Cin to it)."""
    lib = _library()
    bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.gn_silu_conv_tiles(cout, _DTYPE_CODE[dtype], ctypes.byref(bm),
                           ctypes.byref(bn), ctypes.byref(bk))
    return bm.value, bn.value, bk.value


def conv_plan(n: int, cin: int, h: int, w: int, cout: int) -> Dict[str, int]:
    """How the staged-halo bf16 kernel launches at x [n, cin, h, w] ->
    cout: the tile (samples, rows, columns of one block), the grid (pixel
    tiles, Cout tiles, splits over Cin), the N tile and whether halo rows
    move in 16-byte loads."""
    lib = _library()
    out = (ctypes.c_int * 8)()
    lib.gn_silu_conv_plan(n, cin, h, w, cout, out)
    return dict(zip(("samples", "rows", "cols", "pixel_tiles", "cout_tiles",
                     "splits", "bn", "vec"), out))


def sm90_column_block(bn: int) -> int:
    """The wgmma kernel's weight column block for N tile `bn` (ConvCfg::BW):
    the widest of 64, 32, 16 that divides it, one swizzled row of 2 BW
    bytes."""
    return 64 if bn % 64 == 0 else 32 if bn % 32 == 0 else 16


def sm90_smem_bytes(bn: int, stages: int, act_bytes: int,
                    raw_bytes: int) -> int:
    """Shared memory of a wgmma launch (csrc/gn_silu_conv_sm90.cu:
    smem_bytes): the weight ring (3 taps of 32 x BN a stage), two activated
    and two raw halo tiles, the two warpgroups' [channel][pixel] staging,
    the mbarriers and the 1024-byte alignment slack."""
    epi = min(bn, 32)
    return (stages * SM90_TAPS_PER_GROUP * SM90_CHUNK * bn * 2
            + 2 * act_bytes + 2 * raw_bytes
            + 2 * epi * SM90_EPI_LD * 4 + 8 * (2 * stages + 4) + 1024)


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def _sm90_geometry(n: int, h: int, w: int):
    """The tile geometry of a map, or None where TMA cannot address it:
    "samples" mode (1) for maps of 8-64 pixels that divide the 128-pixel
    tile (whole samples, a 3-D box (HW, 32, S)); "rows" mode (0) for rows
    of a multiple of 8 pixels (128 consecutive pixels of one sample a tile;
    a 4-D box of W columns x the rb rows any tile's halo spans, from row
    max(y0 - 1, 0), no taller than the map). Returns (mode, S, rb, wr, rr,
    mtiles)."""
    hw = h * w
    if hw < SM90_BM and SM90_BM % hw == 0 and hw % 8 == 0:
        s = SM90_BM // hw
        return 1, s, h + 2, hw, 1, -(-n // s)
    if w % 8 == 0 and w <= 256:
        tps = -(-hw // SM90_BM)
        rows = max((min(hw, p0 + SM90_BM) - 1) // w - p0 // w + 3
                   for p0 in range(0, tps * SM90_BM, SM90_BM))
        if rows <= h:
            return 0, 1, rows, w, rows, n * tps
    return None


# The modelled time of one (tile, chunk) step of the wgmma kernel, in s: a
# fixed part (the activation, the raw halo, the barriers) and a part per
# output channel of the N tile (its weights and products), fitted to the
# variants of tools/torch_conv_variants.py on an NVIDIA H100 80GB HBM3 at
# 700 W (N tiles 160 and 256 at the fused clip's shapes; PERF.md).
SM90_STEP_S = 2.7e-6
SM90_STEP_S_PER_N = 9.3e-9


def _sm90_grid(mtiles: int, cout: int, nchunks: int, out_bytes: int,
               sms: int, bn: Optional[int] = None):
    """(N tile, splits, chunks a split) with the least modelled time: the
    waves of the persistent grid x a split's chunks x a step's time
    (SM90_STEP_S + SM90_STEP_S_PER_N x BN), plus the f32 workspace of a
    split written and read at 2.5 TB/s; ties to fewer splits. The N tile is
    16 up to Cout 16 (the UNet head's 4), else 160, or 256 where its best
    modelled time is at least 10% under 160's (the model's margin: at the
    measured shapes it picked the faster tile so); `bn` fixes it."""
    best = {}
    for n_tile in ((bn,) if bn else (16,) if cout <= 16 else (160, 256)):
        tiles = mtiles * -(-cout // n_tile)
        step = SM90_STEP_S + SM90_STEP_S_PER_N * n_tile
        for want in range(1, min(nchunks, 16) + 1):
            cps = -(-nchunks // want)
            splits = -(-nchunks // cps)
            cost = -(-tiles * splits // sms) * cps * step
            if splits > 1:
                cost += 2 * splits * out_bytes / 2.5e12
            if n_tile not in best or cost < best[n_tile][0] * (1 - 1e-9):
                best[n_tile] = (cost, n_tile, splits, cps)
    pick = best.get(160) or next(iter(best.values()))
    if 256 in best and best[256][0] < 0.9 * pick[0]:
        pick = best[256]
    return pick[1:]


def _sm90_plan(n: int, cin: int, h: int, w: int, cout: int, sms: int,
               bn: Optional[int] = None,
               stages: int = SM90_MAX_STAGES) -> Optional[Mapping[str, int]]:
    """`conv_plan_sm90` with the N tile fixed to `bn` (one of the kernel's
    instances, SM90_BNS) and the weight ring at most `stages` deep: the
    plans that tools/torch_conv_variants.py times and the emulation tests
    replay beside the chosen one."""
    geo = _sm90_geometry(n, h, w)
    if geo is None:
        return None
    mode, samples, rb, wr, rr, mtiles = geo
    nchunks = -(-cin // SM90_CHUNK)
    bn, splits, cps = _sm90_grid(mtiles, cout, nchunks, n * cout * h * w * 4,
                                 sms, bn)
    act_bytes = _round_up(samples * rb * (w + 2) * SM90_CHUNK * 2, 1024)
    raw_bytes = _round_up(samples * SM90_CHUNK * rr * wr * 2, 1024)
    fixed = sm90_smem_bytes(bn, 0, act_bytes, raw_bytes)
    stages = min(stages, (SM90_SMEM_LIMIT - fixed)
                 // (SM90_TAPS_PER_GROUP * SM90_CHUNK * bn * 2 + 16))
    if stages < 2:
        return None
    ntiles = -(-cout // bn)
    plan = dict(bn=bn, stages=stages, mode=mode, samples=samples, rb=rb,
                wr=wr, rr=rr, mtiles=mtiles, ntiles=ntiles, splits=splits,
                cps=cps, blocks=min(mtiles * ntiles * splits, sms),
                smem=sm90_smem_bytes(bn, stages, act_bytes, raw_bytes))
    assert plan["smem"] <= SM90_SMEM_LIMIT
    return MappingProxyType(plan)


@functools.lru_cache(maxsize=None)
def conv_plan_sm90(n: int, cin: int, h: int, w: int, cout: int,
                   sms: int = 132) -> Optional[Mapping[str, int]]:
    """How the wgmma kernel launches at x [n, cin, h, w] -> cout on a card
    of `sms` SMs, or None where it cannot (the map, or shared memory): the
    N tile and the split over Cin (`_sm90_grid`), the weight ring's stages
    (3 taps each, as many as shared memory holds, up to 6), the tile geometry
    (`_sm90_geometry`: mode, samples a tile, activated halo rows a sample,
    the raw box's row length and rows), the grid (pixel tiles, N tiles,
    splits over Cin and chunks a split, persistent blocks) and the shared
    memory, as a read-only mapping (the cache shares it). The C entry point
    takes these ints in SM90_PLAN_KEYS order and refuses a plan its own
    arithmetic does not reproduce."""
    return _sm90_plan(n, cin, h, w, cout, sms)


def conv_route(n: int, cin: int, h: int, w: int, cout: int,
               dtype: torch.dtype, sms: int = 132,
               aligned: bool = True) -> str:
    """The kernel a CUDA launch at x [n, cin, h, w] -> cout takes (by
    default with x on a 16-byte boundary, as a contiguous tensor is): f32
    the TF32 kernel; bf16 the wgmma kernel wherever `conv_plan_sm90` has a
    plan (every launch of the fused clip: rows of 8-96 pixels, and the 4x4
    maps as whole samples), else the staged-halo mma.sync kernel."""
    if dtype != torch.bfloat16:
        return TF32_CONV_ROUTE
    if aligned and conv_plan_sm90(n, cin, h, w, cout, sms) is not None:
        return WGMMA_CONV_ROUTE
    return HALO_CONV_ROUTE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library(name: str = "gn_silu_conv") -> ctypes.CDLL:
    return _bind(cuda_build.load(name), name)


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """`lib` (a build of csrc/<name>.cu) with its C functions' types set."""
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    if name == "gn_silu_conv_sm90":
        lib.gn_silu_conv_sm90.argtypes = ([ptr] * 7 + [i64] + [i32] * 5
                                          + [ctypes.c_float] + [i32] * 4
                                          + [ctypes.POINTER(i32), ptr])
        lib.gn_silu_conv_sm90.restype = i32
        lib.gn_silu_conv_sm90_scratch_bytes.argtypes = [i64] + [i32] * 6
        lib.gn_silu_conv_sm90_scratch_bytes.restype = i64
        lib.gn_silu_conv_sm90_error_string.argtypes = [i32]
        lib.gn_silu_conv_sm90_error_string.restype = ctypes.c_char_p
        return lib
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
