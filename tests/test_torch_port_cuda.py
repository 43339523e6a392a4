"""Card-only tests of the port's CUDA kernels (marker `cuda`; each skips
without a CUDA card). This file imports no JAX, so it also runs where JAX
is absent, with the JAX-importing conftest left out:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

The flash kernel's oracle: its max error against an f32 result is no worse
than 1.5x the plain version's own error at the kernel's precision: with
bf16 operands, `attention_reference` on the bf16 tensors; with f32
inputs, which the kernel multiplies in TF32, `attention_reference_tf32`
(its operands rounded to TF32 as the kernel rounds them), so the rule
does not hang on which precision cuBLAS picks for a TF32-allowed GEMM.

The temporal kernel's oracle: its max error against the float64 result on
the same (bf16- or f32-valued) inputs is no worse than 1.5x the plain
version's at that dtype, on both routes (tensor cores, warp). The
GroupNorm+SiLU and GroupNorm+SiLU+conv kernels are held the same way, #7 on
each of its paths (one cluster launch, statistics then apply); the plain conv on f32 input is
`gn_silu_conv_reference_tf32` (the kernel multiplies in TF32)."""

import pytest
import torch

from neurons_tpu_torch.ops import attention as attn
from neurons_tpu_torch.ops import fused_conv as fc
from neurons_tpu_torch.ops import fused_norm as fn
from neurons_tpu_torch.ops import temporal_attention as ta


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32_conv = torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = tf32_conv


def _check(q, k, v, dtype, scale=None):
    want = attn.attention_reference(q, k, v, scale=scale)
    qx, kx, vx = q.to(dtype), k.to(dtype), v.to(dtype)
    got = attn.flash_attention_fwd(qx, kx, vx, scale=scale).float()
    if dtype == torch.float32:
        plain = attn.attention_reference_tf32(q, k, v, scale=scale)
    else:
        plain = attn.attention_reference(qx, kx, vx, scale=scale).float()
    err = (got - want).abs().max().item()
    plain_err = (plain - want).abs().max().item()
    # shown with -s: the measured ratio against the rule's 1.5
    print(f"{dtype} {tuple(q.shape)} k {tuple(k.shape)}: err {err:.3e}, "
          f"plain {plain_err:.3e}, ratio {err / plain_err:.3f}")
    assert err <= 1.5 * plain_err, err


# (B, H, Tq, Tk, D, Hkv): ragged Tq/Tk, head dims off the multiple of 16
# (40, 52) and the stage-5 ones (40, 80, 160), multi-query, d=512
SHAPES = [(2, 3, 200, 333, 64, 3), (1, 4, 130, 257, 40, 1),
          (1, 2, 129, 514, 52, 1), (2, 2, 150, 160, 80, 2),
          (1, 2, 140, 150, 160, 2), (1, 1, 300, 290, 512, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, dtype, shape):
    b, h, tq, tk, d, hkv = shape
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((b, h, tq, d), generator=g, device="cuda")
    k = torch.randn((b, hkv, tk, d), generator=g, device="cuda")
    v = torch.randn((b, hkv, tk, d), generator=g, device="cuda")
    _check(q, k, v, getattr(torch, dtype), scale=0.11)


# every head dim the paths launch (the bf16 register kernel's instances at
# d <= 128, the shared-memory kernel at 512), ragged Tq/Tk, two kv heads
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 40, 52, 64, 80, 128, 512])
def test_kernel_at_every_head_dim(cuda, d):
    g = torch.Generator("cuda").manual_seed(d)
    q = torch.randn((1, 2, 200, d), generator=g, device="cuda")
    k, v = (torch.randn((1, 2, 333, d), generator=g, device="cuda")
            for _ in range(2))
    _check(q, k, v, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_at_the_prior_rows(cuda):
    # 513 x 514 tokens, d = 52 (104-byte rows: 8-byte copies), multi-query
    g = torch.Generator("cuda").manual_seed(9)
    q = torch.randn((2, 4, 513, 52), generator=g, device="cuda")
    k, v = (torch.randn((2, 1, 514, 52), generator=g, device="cuda")
            for _ in range(2))
    _check(q, k, v, torch.bfloat16)


# rows that move in 8, 4 or 2 bytes: d = 52 and 50 contiguous, and d = 52
# read from rows of 53 (an odd token stride: element loads)
@pytest.mark.cuda
@pytest.mark.parametrize("d,row", [(52, 52), (50, 50), (52, 53)])
def test_kernel_takes_rows_off_16_bytes(cuda, d, row):
    g = torch.Generator("cuda").manual_seed(10)
    q, k, v = (torch.randn((2, 3, 150, row), generator=g,
                           device="cuda")[..., :d] for _ in range(3))
    assert attn._granule(d, 2, (q.stride(2),), (q,)) == {
        (52, 52): 8, (50, 50): 4, (52, 53): 0}[(d, row)]
    _check(q, k, v, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_takes_strided_head_views(cuda):
    # the UNet's split: [B, T, H*D] viewed as [B, H, T, D], not contiguous
    g = torch.Generator("cuda").manual_seed(1)
    b, t, h, d = 2, 300, 5, 64
    x = torch.randn((3, b, t, h * d), generator=g, device="cuda")
    q, k, v = (y.reshape(b, t, h, d).transpose(1, 2) for y in x)
    assert not q.is_contiguous()
    _check(q, k, v, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_counts_launches_and_refuses_fp16(cuda):
    q = torch.randn((1, 1, 128, 32), device="cuda", dtype=torch.bfloat16)
    before = attn.FLASH_FWD_LAUNCHES.total
    attn.dot_product_attention(q, q, q)
    assert attn.FLASH_FWD_LAUNCHES.total == before + 1
    with pytest.raises(ValueError):
        attn.flash_attention_fwd(q.half(), q.half(), q.half())


# SVD's launches at 14 frames, CFG doubled to 28 rows, 576 x 1024 (latents
# 72 x 128): the VideoUNet's spatial self-attention at ds 2, 4 and the mid
# block (heads of 64), and the temporal decoder's mid attention on a chunk
# of 7 frames (d 512, 9216 tokens)
SVD_SHAPES = [(28, 10, 2304, 64), (28, 20, 576, 64), (28, 20, 144, 64),
              (7, 1, 9216, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SVD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_at_the_svd_shapes(cuda, shape):
    b, h, t, d = shape
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
               for _ in range(3))
    _check(q, k, v, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_at_the_svd_full_resolution_rows(cuda):
    """[28, 5, 9216, 64] (ds 1): the kernel runs the whole launch; the plain
    version, whose f32 logits would take 47 GB, is held on rows 0 and 27."""
    g = torch.Generator("cuda").manual_seed(12)
    q, k, v = (torch.randn((28, 5, 9216, 64), generator=g, device="cuda")
               for _ in range(3))
    qx, kx, vx = (t.to(torch.bfloat16) for t in (q, k, v))
    got = attn.flash_attention_fwd(qx, kx, vx).float()
    for r in (0, 27):
        want = attn.attention_reference(q[r:r + 1], k[r:r + 1], v[r:r + 1])
        plain = attn.attention_reference(qx[r:r + 1], kx[r:r + 1],
                                         vx[r:r + 1]).float()
        err = (got[r:r + 1] - want).abs().max().item()
        plain_err = (plain - want).abs().max().item()
        print(f"svd row {r}: err {err:.3e}, plain {plain_err:.3e}")
        assert err <= 1.5 * plain_err, err


def _check_temporal(bf, d, c, f, h, dtype, seed=2):
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((bf, d, c), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    scale = (c // h) ** -0.5
    want = ta.temporal_attention_reference(q.double(), k.double(),
                                           v.double(), f, h, scale)
    before = ta.TEMPORAL_ATTN_LAUNCHES.total
    got = ta.temporal_attention(q, k, v, f, h, scale)
    torch.cuda.synchronize()
    assert ta.TEMPORAL_ATTN_LAUNCHES.total == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    plain = ta.temporal_attention_reference(q, k, v, f, h, scale)
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    print(f"temporal {dtype} [{bf},{d},{c}] F={f} H={h}: err {err:.3e}, "
          f"plain {plain_err:.3e}, ratio {err / plain_err:.3f}")
    assert err <= 1.5 * plain_err, err


# F in {4, 16} with the tiny config's and the path's head dims; D = 7
# pixels is no multiple of the 4 units a block takes
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [4, 8, 40, 80, 160])
@pytest.mark.parametrize("f,h", [(4, 2), (16, 8)])
def test_temporal_kernel_matches_plain(cuda, dtype, hd, f, h):
    _check_temporal(2 * f, 7, h * hd, f, h, getattr(torch, dtype))


@pytest.mark.cuda
def test_temporal_kernel_at_a_path_shape(cuda):
    # the UNet3D's 16x16 motion modules, CFG batch: [(2 x 16), 256, 640]
    _check_temporal(32, 256, 640, 16, 8, torch.bfloat16)


# (F, hd, dtype) -> route: bf16 with F <= 16 and 16-byte head rows takes
# the tensor cores; f32, F = 24 and hd = 4 keep the warp route
TEMPORAL_ROUTES = [(16, 8, "bfloat16", "tensor cores"),
                   (16, 40, "bfloat16", "tensor cores"),
                   (16, 80, "bfloat16", "tensor cores"),
                   (16, 160, "bfloat16", "tensor cores"),
                   (4, 40, "bfloat16", "tensor cores"),
                   (16, 40, "float32", "warp"),
                   (24, 40, "bfloat16", "warp"),
                   (24, 40, "float32", "warp"),
                   (16, 4, "bfloat16", "warp")]


@pytest.mark.cuda
@pytest.mark.parametrize("f,hd,dtype,route", TEMPORAL_ROUTES, ids=str)
def test_temporal_routes(cuda, f, hd, dtype, route):
    # D = 7 pixels and H = 2: tiles of 4 units cross batch rows
    dt = getattr(torch, dtype)
    assert ta.temporal_plan(f, hd, dt).route == route
    _check_temporal(2 * f, 7, 2 * hd, f, 2, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [(32, 1024, 320), (32, 64, 1280),
                                   (32, 16, 1280)], ids=str)
def test_temporal_kernel_at_the_other_path_levels(cuda, level):
    # the UNet3D's 32x32, 8x8 and 4x4 motion modules (CFG batch, 16
    # frames, 8 heads): many tiles a persistent block, so the copy ring
    # wraps; the 4x4 level has fewer tiles than resident blocks
    _check_temporal(*level, 16, 8, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_temporal_gradient_through_the_kernel(cuda, dtype):
    # under autograd the entry point launches the kernel once and records
    # its Function; the gradients (the plain version's VJP, recomputed)
    # are held to float64 autograd of the reference on the same inputs,
    # within 1.5x the plain path's error (plain forward and autograd)
    dt = getattr(torch, dtype)
    bf, d, c, f, h = 32, 7, 640, 16, 8
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v, go = (torch.randn((bf, d, c), generator=g, device="cuda").to(dt)
                   for _ in range(4))
    scale = (c // h) ** -0.5
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ta.TEMPORAL_ATTN_LAUNCHES.total
    out = ta.temporal_attention(*ins, f, h, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, go)
    assert ta.TEMPORAL_ATTN_LAUNCHES.total == before + 1
    ins64 = [x.double().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        ta.temporal_attention_reference(*ins64, f, h, scale), ins64,
        go.double())
    pins = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = torch.autograd.grad(
        ta.temporal_attention_reference(*pins, f, h, scale), pins, go)
    for name, a, p_, w in zip("qkv", got, plain, want):
        assert a.dtype == dt and a.shape == q.shape
        _report(f"temporal grad d{name} {dtype}",
                (a.double() - w).abs().max().item(),
                (p_.double() - w).abs().max().item())


@pytest.mark.cuda
def test_temporal_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn((8, 5, 16), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.temporal_attention(q.half(), q.half(), q.half(), 4, 2, 0.5)
    with pytest.raises(ValueError):
        t = q.transpose(0, 1).contiguous().transpose(0, 1)
        ta.temporal_attention(t, t, t, 4, 2, 0.5)
    with pytest.raises(ValueError):
        big = torch.randn((33, 5, 16), device="cuda", dtype=torch.bfloat16)
        ta.temporal_attention(big, big, big, 33, 2, 0.5)


# The training kernels: the biased forward with lse (#3, and #1/#2 with
# lse) and the backward (#4, #5). Oracle: float64 autograd of
# `attention_reference` on the same (bf16- or f32-valued) inputs. The
# kernel path (kernel forward, then kernel backward from its out and lse)
# must be within 1.5x of the plain path's error (plain forward, then
# `flash_attention_bwd_reference` at the kernel's precision: bf16 roundings
# as the JAX package's, or TF32 products for f32) for out, lse, dq, dk, dv
# and dbias. The backward sums in a fixed order (no atomics), so a rerun
# gives the same bits.
def _check_train(b, h, tq, tk, d, hkv, bias_shape, dtype, seed=3, row=None):
    # row: q, k, v and the output gradient are read from token rows of
    # `row` elements (the first d of each), so the kernels' row copies
    # take 8-, 4-byte or element loads
    g = torch.Generator("cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def rows(*shape):
        return rand(*shape[:-1], row or d)[..., :d]

    q, k, v = rows(b, h, tq, d), rows(b, hkv, tk, d), rows(b, hkv, tk, d)
    bias = rand(*bias_shape) if bias_shape else None
    go = rows(b, h, tq, d)
    scale = d ** -0.5
    ins = [x.double().requires_grad_() for x in (q, k, v)]
    bias64 = bias.double().requires_grad_() if bias is not None else None
    want_out = attn.attention_reference(*ins, bias=bias64, scale=scale)
    want_lse = torch.logsumexp(attn._logits(ins[0], ins[1], bias64, None,
                                            scale), -1)
    wrt = ins + ([bias64] if bias is not None else [])
    want = dict(zip(("dq", "dk", "dv", "dbias"),
                    torch.autograd.grad(want_out, wrt, go.double())))
    want.update(out=want_out.detach(), lse=want_lse.detach())

    fwd0, bwd0 = attn.FLASH_FWD_LAUNCHES.total, attn.FLASH_BWD_LAUNCHES.total
    out, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                        return_lse=True)
    got = dict(zip(("dq", "dk", "dv", "dbias"), attn.flash_attention_bwd(
        q, k, v, bias, go, out, lse, scale)), out=out, lse=lse)
    torch.cuda.synchronize()
    assert attn.FLASH_FWD_LAUNCHES.total == fwd0 + 1
    assert attn.FLASH_BWD_LAUNCHES.total == bwd0 + 1
    again = attn.flash_attention_bwd(q, k, v, bias, go, out, lse, scale)
    assert all(torch.equal(a, got[n]) for a, n in zip(again, got)
               if a is not None)

    tf32 = dtype == torch.float32
    if tf32:
        pout, plse = attn.attention_reference_tf32(q, k, v, scale, bias,
                                                   return_lse=True)
    else:
        pout, plse = attn.attention_reference_lse(q, k, v, bias, scale)
    plain = dict(zip(("dq", "dk", "dv", "dbias"),
                     attn.flash_attention_bwd_reference(
                         q, k, v, bias, go, pout, plse, scale, tf32=tf32)),
                 out=pout, lse=plse)
    for name in want:
        if bias is None and name == "dbias":
            continue
        assert got[name].dtype == (torch.float32 if name == "lse" else dtype)
        assert got[name].shape == want[name].shape, name
        err = (got[name].double() - want[name]).abs().max().item()
        plain_err = (plain[name].double() - want[name]).abs().max().item()
        print(f"{dtype} [{b},{h},{tq},{tk},{d}] kv heads {hkv} bias "
              f"{bias_shape} {name}: err {err:.3e}, plain {plain_err:.3e}, "
              f"ratio {err / plain_err:.3f}")
        assert err <= 1.5 * plain_err, (name, err, plain_err)


# (B, H, Tq, Tk, D, Hkv, bias shape): the prior's layout at a few heads
# (multi-query, per-head bias, ragged 129 x 130, d = 52), a shared and a
# per-(b, h) bias, and the decoder's unbiased single head at d = 32, 64, 128
TRAIN_SHAPES = [
    (2, 4, 129, 130, 52, 1, (4, 129, 130)),
    (2, 3, 70, 200, 40, 3, (70, 200)),
    (2, 2, 100, 90, 64, 2, (2, 2, 100, 90)),
    (3, 1, 256, 256, 32, 1, None),
    (2, 1, 200, 150, 64, 1, None),
    (2, 1, 130, 130, 128, 1, None),
]
# the autoencoder trainer's VAE mid attention (one head at d 512 over 1024
# tokens, batch 4 at 256 px) and a ragged d 512, in f32 as the trainer runs
# (bf16 at d 512 writes its lse at 2.0-2.4x the plain version's error, at
# f32 level: tensor-core accumulation over 512 products; no path launches
# it)
VAE_TRAIN_SHAPES = [(4, 1, 1024, 1024, 512, 1, None),
                    (2, 1, 300, 190, 512, 1, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])))
def test_train_kernels_match_plain(cuda, dtype, shape):
    _check_train(*shape, getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VAE_TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])))
def test_train_kernels_at_the_vae_shapes_f32(cuda, shape):
    _check_train(*shape, torch.float32)


# the bias modes with lse in bf16: one slice, one per head, one per (b, h)
# at d = 80, and a biased d = 128 (the column-split kernel's launch)
@pytest.mark.cuda
@pytest.mark.parametrize("d,bias_shape", [(80, (150, 140)),
                                          (80, (3, 150, 140)),
                                          (80, (2, 3, 150, 140)),
                                          (128, (3, 150, 140))],
                         ids=["shared", "per_head", "per_bh", "per_head_d128"])
def test_forward_bias_modes_with_lse(cuda, d, bias_shape):
    _check_train(2, 3, 150, 140, d, 3, bias_shape, torch.bfloat16)


# the bf16 backward's register instances (head dims padded to 32, 64, 96,
# 128) at head dims off them, unbiased and with a per-head bias over
# multi-query k/v, ragged Tq and Tk
@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True], ids=["nobias", "per_head"])
@pytest.mark.parametrize("d", [16, 40, 80, 96])
def test_backward_at_every_head_dim(cuda, d, biased):
    _check_train(2, 3, 150, 190, d, 1 if biased else 3,
                 (3, 150, 190) if biased else None, torch.bfloat16, seed=d)


# rows that move in 8, 4 or 2 bytes (d = 52 and 50 contiguous, d = 52
# from rows of 53), and an odd Tk, whose bias rows move element by element
@pytest.mark.cuda
@pytest.mark.parametrize("d,row,tk", [(52, 52, 140), (50, 50, 140),
                                      (52, 53, 140), (40, 40, 131)])
def test_backward_takes_rows_off_16_bytes(cuda, d, row, tk):
    _check_train(2, 2, 77, tk, d, 1, (2, 77, tk), torch.bfloat16, seed=12,
                 row=row)


@pytest.mark.cuda
def test_train_kernels_at_the_prior_shape(cuda):
    # the prior's [10, 32, 513, 514, 52] multi-query with its per-head bias
    _check_train(10, 32, 513, 514, 52, 1, (32, 513, 514), torch.bfloat16)


@pytest.mark.cuda
def test_dispatcher_takes_the_autograd_function_under_grad(cuda):
    q = torch.randn((1, 2, 128, 16), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn((1, 1, 130, 16), device="cuda", dtype=torch.bfloat16)
    bias = torch.randn((2, 128, 130), device="cuda", dtype=torch.bfloat16)
    fwd0, bwd0 = attn.FLASH_FWD_LAUNCHES.total, attn.FLASH_BWD_LAUNCHES.total
    attn.dot_product_attention(q, kv, kv, bias=bias).sum().backward()
    assert attn.FLASH_FWD_LAUNCHES.total == fwd0 + 1
    assert attn.FLASH_BWD_LAUNCHES.total == bwd0 + 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():  # inference keeps biased attention plain
        attn.dot_product_attention(q, kv, kv, bias=bias)
    assert attn.FLASH_FWD_LAUNCHES.total == fwd0 + 1


# The GroupNorm+SiLU kernel (#7) and the GroupNorm+SiLU+3x3-conv kernel
# (#8) against float64 on the same (bf16- or f32-valued) inputs, within
# 1.5x the plain version's error at that dtype.
def _gn_inputs(n, c, h, w, mean, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    x = mean + torch.randn((n, c, h, w), generator=g, device="cuda")
    gw = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
    gb = 0.2 * torch.randn((c,), generator=g, device="cuda")
    return x, gw, gb, g


def _report(what, err, plain_err):
    print(f"{what}: err {err:.3e}, plain {plain_err:.3e}, ratio "
          f"{err / plain_err:.3f}")
    assert err <= 1.5 * plain_err, err


def _check_gn_silu(n, c, h, w, groups, dtype, mean=0.0, seed=4):
    x, gw, gb, _ = _gn_inputs(n, c, h, w, mean, seed)
    x, gw, gb = x.to(dtype), gw.to(dtype), gb.to(dtype)
    want = fn.group_norm_silu_reference(x.double(), gw.double(), gb.double(),
                                        groups, 1e-5)
    before = fn.GN_SILU_LAUNCHES.total
    got = fn.gn_silu_fwd(x, gw, gb, groups, 1e-5)
    torch.cuda.synchronize()
    assert fn.GN_SILU_LAUNCHES.total == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    plain = fn.group_norm_silu_reference(x, gw, gb, groups, 1e-5)
    _report(f"gn_silu {dtype} [{n},{c},{h},{w}] G={groups} mean {mean}",
            (got.double() - want).abs().max().item(),
            (plain.double() - want).abs().max().item())


def _check_gn_silu_conv(n, cin, h, w, cout, groups, dtype, mean=0.0, seed=5):
    x, gw, gb, g = _gn_inputs(n, cin, h, w, mean, seed)
    cw = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") \
        / (9 * cin) ** 0.5
    cb = 0.1 * torch.randn((cout,), generator=g, device="cuda")
    x, gw, gb, cw, cb = (t.to(dtype) for t in (x, gw, gb, cw, cb))
    want = fc.gn_silu_conv_reference(*(t.double() for t in (x, gw, gb, cw,
                                                             cb)),
                                      groups, 1e-5)
    before = fc.GN_SILU_CONV_LAUNCHES.total
    got = fc.gn_silu_conv_fwd(x, gw, gb, cw, cb, groups, 1e-5)
    torch.cuda.synchronize()
    assert fc.GN_SILU_CONV_LAUNCHES.total == before + 1
    assert got.dtype == dtype and got.shape == (n, cout, h, w)
    if dtype == torch.float32:
        plain = fc.gn_silu_conv_reference_tf32(x, gw, gb, cw, cb, groups,
                                               1e-5)
    else:
        plain = fc.gn_silu_conv_reference(x, gw, gb, cw, cb, groups, 1e-5)
    _report(f"gn_silu_conv {dtype} [{n},{cin},{h},{w}] -> {cout} "
            f"G={groups} mean {mean}",
            (got.double() - want).abs().max().item(),
            (plain.double() - want).abs().max().item())


# (N, C, H, W, groups): HW not a multiple of the 16-byte lanes, the 4x4
# level at 32 samples, 960 channels at a small map, groups < 32, a slab of
# 25 statistics chunks
GN_SHAPES = [(2, 64, 7, 9, 32), (32, 1280, 4, 4, 32), (2, 960, 6, 6, 32),
             (2, 32, 33, 31, 8), (1, 128, 160, 160, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", GN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gn_silu_kernel_matches_plain(cuda, dtype, shape):
    _check_gn_silu(*shape, getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_silu_kernel_large_mean(cuda, dtype):
    _check_gn_silu(2, 64, 24, 24, 32, getattr(torch, dtype), mean=100.0)


# One shape on each of #7's paths (`gn_silu_plan`): a cluster of one
# block (many tiny slabs), a cluster of 8 blocks (a small grid spread over
# more SMs), and the two-launch path (a 4 MB bf16 slab, over what one
# cluster's shared memory holds)
GN_PATHS = {"one block": ((32, 1280, 4, 4, 32), 1, 1),
            "cluster": ((1, 128, 160, 160, 32), 1, 8),
            "two launches": ((1, 8, 512, 512, 1), 2, None)}


def _gn_plan(shape, dtype):
    n, c, h, w, groups = shape
    return fn.gn_silu_plan(n, c, h * w, groups, dtype, 1,
                           torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("path", sorted(GN_PATHS))
def test_gn_silu_paths(cuda, dtype, path):
    shape, launches, cluster = GN_PATHS[path]
    dt = getattr(torch, dtype)
    plan = _gn_plan(shape, dt)
    print(f"gn_silu {path} {dtype} {shape}: {plan}")
    assert plan.launches == launches
    if cluster is not None:
        assert plan.cluster == cluster
    _check_gn_silu(*shape, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(GN_PATHS))
def test_gn_silu_rerun_gives_equal_bits(cuda, path):
    # the statistics merge in a fixed order (no atomics) on every path
    shape, _, _ = GN_PATHS[path]
    x, gw, gb, _ = _gn_inputs(*shape[:4], 0.0, 9)
    x = x.to(torch.bfloat16)
    first = fn.gn_silu_fwd(x, gw, gb, shape[4], 1e-5)
    again = fn.gn_silu_fwd(x, gw, gb, shape[4], 1e-5)
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_silu_two_launch_large_mean(cuda, dtype):
    # the large-mean case on the two-launch path (test_gn_silu_kernel_
    # large_mean holds the one-launch path)
    shape = GN_PATHS["two launches"][0]
    assert _gn_plan(shape, getattr(torch, dtype)).launches == 2
    _check_gn_silu(*shape, getattr(torch, dtype), mean=100.0)


# (N, Cin, H, W, Cout, groups): the UNet head's Cout = 4 at an odd map,
# 4x4 at 32 samples, Cin = 960 at a small map, Cin and Cout off the tiles
# with groups < 32, a map larger than one M tile per sample
CONV_SHAPES = [(2, 64, 7, 9, 4, 32), (32, 1280, 4, 4, 1280, 32),
               (2, 960, 6, 6, 320, 32), (2, 40, 13, 11, 24, 8),
               (1, 64, 40, 36, 96, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gn_silu_conv_kernel_matches_plain(cuda, dtype, shape):
    _check_gn_silu_conv(*shape, getattr(torch, dtype))


# The bf16 kernel's tiles: every map width of the UNet paths (4 and 8 as
# whole samples at 32 samples, 16-96 as whole rows), each N tile (Cout = 4,
# 64 and 320 on the 256-pixel tile, 128 and 640), the head's Cout = 4 at
# 96x96, Cin off the 32-channel chunk (80) at N = 1 and groups of 16
CONV_TILE_SHAPES = [(32, 64, 4, 4, 128, 32), (32, 64, 8, 8, 128, 32),
                    (4, 64, 16, 16, 128, 32), (2, 96, 24, 24, 320, 32),
                    (2, 64, 32, 32, 64, 32), (1, 64, 48, 48, 640, 32),
                    (2, 320, 96, 96, 4, 32), (1, 80, 20, 20, 64, 16),
                    (32, 64, 8, 8, 320, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_TILE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gn_silu_conv_kernel_tiles(cuda, shape):
    _check_gn_silu_conv(*shape, torch.bfloat16)


@pytest.mark.cuda
def test_gn_silu_conv_split_is_deterministic(cuda):
    # the 4x4 level splits its input channels across blocks; the 32x32
    # level fills the card without; a split call gives the same bits twice
    assert fc.conv_plan(32, 1280, 4, 4, 1280)["splits"] > 1
    assert fc.conv_plan(32, 320, 32, 32, 320)["splits"] == 1
    x, gw, gb, g = _gn_inputs(32, 1280, 4, 4, 0.0, 8)
    cw = torch.randn((1280, 1280, 3, 3), generator=g, device="cuda") / 107.0
    cb = 0.1 * torch.randn((1280,), generator=g, device="cuda")
    args = [t.to(torch.bfloat16) for t in (x, gw, gb, cw, cb)]
    first = fc.gn_silu_conv_fwd(*args, 32, 1e-5)
    again = fc.gn_silu_conv_fwd(*args, 32, 1e-5)
    assert torch.equal(first, again)
    _check_gn_silu_conv(32, 1280, 4, 4, 1280, 32, torch.bfloat16, seed=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_silu_conv_kernel_large_mean(cuda, dtype):
    _check_gn_silu_conv(2, 64, 12, 12, 64, 32, getattr(torch, dtype),
                        mean=100.0)


@pytest.mark.cuda
def test_gn_autograd_functions_on_the_card(cuda):
    # forward through the kernels, backward through the plain composites:
    # gradients as float64 autograd of the plain versions, to f32 level
    x, gw, gb, g = _gn_inputs(2, 32, 9, 7, 0.0, 6)
    cw = 0.1 * torch.randn((16, 32, 3, 3), generator=g, device="cuda")
    cb = 0.1 * torch.randn((16,), generator=g, device="cuda")
    dy = torch.randn((2, 16, 9, 7), generator=g, device="cuda")
    for fused, ref, args in (
            (lambda *a: fn.GroupNormSiLUFn.apply(*a, 8, 1e-5),
             lambda *a: fn.group_norm_silu_reference(*a, 8, 1e-5),
             (x, gw, gb)),
            (lambda *a: fc.GNSiLUConvFn.apply(*a, 8, 1e-5),
             lambda *a: fc.gn_silu_conv_reference(*a, 8, 1e-5),
             (x, gw, gb, cw, cb))):
        ins = [a.clone().requires_grad_() for a in args]
        out = fused(*ins)
        g_out = dy if out.shape == dy.shape else torch.ones_like(out)
        got = torch.autograd.grad(out, ins, g_out)
        ins64 = [a.double().requires_grad_() for a in args]
        want = torch.autograd.grad(ref(*ins64), ins64, g_out.double())
        for a, b in zip(got, want):
            assert (a.double() - b).abs().max().item() \
                <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_switches_send_cuda_tensors_to_the_kernels(cuda, monkeypatch):
    x, gw, gb, g = _gn_inputs(2, 64, 8, 8, 0.0, 7)
    cw = 0.1 * torch.randn((32, 64, 3, 3), generator=g, device="cuda")
    cb = torch.zeros((32,), device="cuda")
    monkeypatch.setenv("NEURONS_TPU_FUSED_NORM", "1")
    monkeypatch.setenv("NEURONS_TPU_FUSED_GNCONV", "1")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fn, "group_norm_silu_reference", plain)
    monkeypatch.setattr(fc, "gn_silu_conv_reference", plain)
    n7, n8 = fn.GN_SILU_LAUNCHES.total, fc.GN_SILU_CONV_LAUNCHES.total
    fn.group_norm_silu(x, gw, gb, 32)
    assert fn.GN_SILU_LAUNCHES.total == n7 + 1
    fc.gn_silu_conv(x, gw, gb, cw, cb, 32)
    assert fc.GN_SILU_CONV_LAUNCHES.total == n8 + 1
    assert fn.GN_SILU_LAUNCHES.total == n7 + 1  # the conv's norm is fused
    with pytest.raises(ValueError):
        fn.gn_silu_fwd(x.half(), gw.half(), gb.half(), 32)
    with pytest.raises(ValueError):
        fc.gn_silu_conv_fwd(x.half(), gw, gb, cw.half(), cb, 32)


@pytest.mark.cuda
def test_packed_conv_weight_is_cached_until_it_changes(cuda):
    cw = torch.randn((8, 16, 3, 3), device="cuda")
    p1 = fc.packed_weight(cw, torch.bfloat16)
    assert fc.packed_weight(cw, torch.bfloat16) is p1
    cw.mul_(2.0)  # an in-place update moves the version counter
    p2 = fc.packed_weight(cw, torch.bfloat16)
    assert p2 is not p1
    _, bn, bk = fc.conv_tiles(8, torch.bfloat16)
    assert p2.shape == (9, bk, bn)
    assert torch.equal(p2[:, :16, :8].float(),
                       cw.permute(2, 3, 1, 0).reshape(9, 16, 8)
                       .to(torch.bfloat16).float())
    assert not p2[:, 16:].any() and not p2[:, :, 8:].any()


# ------------------------------------------------ stage 1 and resume ----

def _tiny_stage1(device, seed=0):
    """A tiny f32 stage-1 state on `device`, the weights drawn on the CPU
    (the same on either device)."""
    from neurons_tpu_torch import config
    from neurons_tpu_torch.training import train_brain as tb
    bcfg = config.BrainModelConfig(hidden_dim=64, n_blocks=2, clip_seq_dim=8,
                                   clip_emb_dim=32, clip_txt_emb_dim=16,
                                   subjects=(3,))
    tcfg = config.TrainConfig(batch_size=4, num_epochs=2, max_lr=1e-3,
                              bf16_autocast=False)
    _, cpu_state, _ = tb.init_stage1(bcfg, tcfg, 2, seed=seed, device="cpu")
    core, state, schedule = tb.init_stage1(bcfg, tcfg, 2, device=device)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(cpu_state.params[n])
    return bcfg, tcfg, core, state, schedule


@pytest.mark.cuda
def test_stage1_step_card_against_cpu(cuda):
    """One f32 stage-1 step with the same weights, batch and draws on the
    card and on the CPU: the loss terms within 1e-4 relative, and each
    updated tensor within 1e-3 x lr of the CPU's where the gradient is well
    above rounding noise (the rest, and the tensors whose gradients vanish,
    within Adam's bound); clipproj bitwise unchanged on both."""
    from neurons_tpu_torch.training import train_brain as tb
    runs = {}
    for device in ("cpu", "cuda"):
        bcfg, tcfg, core, state, schedule = _tiny_stage1(device)
        gen = torch.Generator().manual_seed(1)
        voxel = torch.randn(4, 1, bcfg.voxel_counts[0], generator=gen)
        target = torch.randn(4, 8, 32, generator=gen)
        text = torch.randn(4, 16, generator=gen)
        draws = tb.draw_stage1(bcfg, voxel, torch.Generator().manual_seed(2))
        old = {n: p.detach().cpu().clone() for n, p in state.params.items()}
        state, metrics = tb.make_stage1_train_step(core, schedule, tcfg)(
            state, draws, voxel.to(device), target.to(device),
            text.to(device))
        runs[device] = (old, {n: p.detach().cpu() for n, p in
                              state.params.items()},
                        {n: p.grad.cpu() for n, p in state.params.items()
                         if p.grad is not None}, metrics, schedule(0))
    old, cpu, cgrad, cm, lr = runs["cpu"]
    _, card, _, gm, _ = runs["cuda"]
    for k, v in cm.items():
        assert abs(float(gm[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    for n, p in cpu.items():
        if n.startswith("clipproj."):
            assert torch.equal(card[n], old[n]) and torch.equal(p, old[n])
            continue
        d = ((card[n] - old[n]) - (p - old[n])).abs()
        assert d.max() <= 2 * lr * (1 + 1e-3), n  # Adam's bound, both ways
        # with seq_len 1 the mix1 path and the mix2 LayerNorm scales get
        # gradients that vanish in exact arithmetic: rounding noise on
        # either device, which Adam's first step turns into +-lr
        if ".mix1_" in n or ".mix2_ln_" in n:
            continue
        gr = cgrad[n].abs()
        sharp = gr >= max(1e-2 * gr.max(), 1e-6)
        if sharp.any():  # (the mix2 MLPs' gradients are exact zeros)
            assert d[sharp].max() <= 1e-3 * lr, n


@pytest.mark.cuda
def test_stage1_resume_on_the_card(cuda, tmp_path):
    """Save a stepped state, restore it into a fresh one on the card: equal
    bits, copied in place, and the allocator's peak during the restore at
    most one tensor above the live state."""
    from neurons_tpu_torch.training import loop
    from neurons_tpu_torch.training import train_brain as tb
    from neurons_tpu_torch.utils import checkpoint as ckpt
    bcfg, tcfg, core, state, schedule = _tiny_stage1("cuda")
    state = tb.make_stage1_train_step(core, schedule, tcfg)(
        state, torch.Generator().manual_seed(0),
        torch.randn(4, 1, bcfg.voxel_counts[0], device="cuda"),
        torch.randn(4, 8, 32, device="cuda"),
        torch.randn(4, 16, device="cuda"))[0]
    ckpt.save_ckpt(str(tmp_path), "brain_model_last", params=state.params,
                   opt_state=state.optimizer.state_dict(), step=state.step,
                   epoch=0)
    _, _, _, fresh, _ = _tiny_stage1("cuda", seed=5)
    new, start, _ = loop._restore_state(str(tmp_path), "brain_model_last",
                                        fresh)
    assert (new.step, start) == (1, 1)
    for n, p in new.params.items():
        assert torch.equal(p, state.params[n]), n
    stats = loop.LAST_RESTORE_STATS
    largest = max(p.numel() * 4 for p in state.params.values())
    assert stats["peak_extra_bytes"] == 0
    assert 0 <= stats["device_peak_extra_bytes"] <= largest, stats


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(257, 257), (200, 333)])
def test_kernel_at_head_dim_88_from_fused_qkv(cuda, tq, tk):
    # BLIP-2's vision tower: 16 heads of 88 (the d = 96 instance with 8
    # padded columns) split from one fused qkv projection, so q, k and v
    # are strided views with a token stride of 3 x 1408
    g = torch.Generator("cuda").manual_seed(88)
    b, h, d = 2, 16, 88
    qkv = torch.randn((b, max(tq, tk), 3 * h * d), generator=g, device="cuda")
    q, k, v = qkv.chunk(3, dim=-1)
    q = q[:, :tq].reshape(b, tq, h, d).transpose(1, 2)
    k, v = (y[:, :tk].reshape(b, tk, h, d).transpose(1, 2) for y in (k, v))
    assert q.stride(2) == 3 * h * d and not k.is_contiguous()
    assert attn._granule(d, 2, (q.stride(2), k.stride(2)), (q, k, v)) == 16
    _check(q, k, v, torch.bfloat16)


# The f32 route: the TF32 register kernel (flash_fwd_tf32_kernel) at d <=
# 128, the first design past it. Stage 6 in f32 (ViT-B a frame, VideoMAE
# over 6 frames, CLIP ViT-L) and the DecoderVideo of stage e and the seg
# panels (d 128 at 256 tokens, 64 at 1024, 32 at 4096) at 2 rows
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d", [(1, 12, 197, 64), (1, 12, 588, 64),
                                     (6, 16, 257, 64), (2, 1, 256, 128),
                                     (2, 1, 1024, 64), (2, 1, 4096, 32)])
def test_f32_route_at_the_metric_shapes(cuda, b, h, t, d):
    g = torch.Generator("cuda").manual_seed(t)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
               for _ in range(3))
    _check(q, k, v, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 40, 52, 64, 80, 96, 128, 160, 512])
def test_f32_route_by_head_dim(cuda, d):
    # the TF32 register kernel's instances pad d to 32, 64 or 128 (64 or 32
    # keys a tile, rows of d + 4 floats, a 3-stage K/V ring)
    route = attn.flash_route(d, torch.float32)
    if d <= 128:
        dk = 32 if d <= 32 else 64 if d <= 64 else 128
        bk = 64 if dk <= 64 else 32
        assert route == "flash_fwd_tf32_kernel"
        assert attn.flash_tiles(d, torch.float32) == (
            64, bk, 3 * 2 * bk * (dk + 4) * 4)
    else:
        assert route == "flash_fwd_kernel"
    assert attn.flash_route(d, torch.bfloat16) != "flash_fwd_tf32_kernel"


# ragged rows: Tq and Tk of 1, 16 k + 1 and 197 (a tail tile of one key or
# one query row, and a block with a single valid row)
@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(1, 1), (1, 197), (197, 1), (17, 65),
                                   (65, 17), (197, 197)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_f32_route_takes_ragged_rows(cuda, tq, tk, d):
    g = torch.Generator("cuda").manual_seed(tq * 1000 + tk)
    q = torch.randn((2, 3, tq, d), generator=g, device="cuda")
    k, v = (torch.randn((2, 3, tk, d), generator=g, device="cuda")
            for _ in range(2))
    _check(q, k, v, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [52, 64])
def test_f32_route_takes_strided_head_views(cuda, d):
    # ViT's fused qkv: [B, T, 3 H D] split into strided [B, H, T, D] views
    g = torch.Generator("cuda").manual_seed(d)
    b, t, h = 2, 197, 12
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda")
    q, k, v = (y.reshape(b, t, h, d).transpose(1, 2)
               for y in qkv.chunk(3, dim=-1))
    assert q.stride(2) == 3 * h * d and not k.is_contiguous()
    _check(q, k, v, torch.float32)


def _check_f32_lse(q, k, v, bias, scale):
    """The f32 forward with lse against float64 `attention_reference_lse`,
    each within 1.5x the TF32 plain version's error; a rerun gives equal
    bits."""
    b64 = None if bias is None else bias.double()
    want, want_lse = attn.attention_reference_lse(q.double(), k.double(),
                                                  v.double(), b64, scale)
    got, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                        return_lse=True)
    again, again_lse = attn.flash_attention_fwd(q, k, v, scale=scale,
                                                bias=bias, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    plain, plain_lse = attn.attention_reference_tf32(q, k, v, scale, bias,
                                                     return_lse=True)
    for name, x, px, w in (("out", got, plain, want),
                           ("lse", lse, plain_lse, want_lse)):
        assert bool(torch.isfinite(x).all()), name
        err = (x.double() - w).abs().max().item()
        plain_err = (px.double() - w).abs().max().item()
        print(f"f32 {tuple(q.shape)} k {tuple(k.shape)} bias "
              f"{None if bias is None else tuple(bias.shape)} {name}: err "
              f"{err:.3e}, plain {plain_err:.3e}")
        assert err <= 1.5 * plain_err, (name, err, plain_err)


# the prior's f32 check: multi-query k/v at d = 52 with a shared, a
# per-head and a per-(b, h) bias, and without one, with the lse
@pytest.mark.cuda
@pytest.mark.parametrize("bias_shape", [None, (129, 130), (4, 129, 130),
                                        (2, 4, 129, 130)],
                         ids=["none", "shared", "per_head", "per_bh"])
def test_f32_route_multi_query_bias_modes_with_lse(cuda, bias_shape):
    g = torch.Generator("cuda").manual_seed(52)
    q = torch.randn((2, 4, 129, 52), generator=g, device="cuda")
    k, v = (torch.randn((2, 1, 130, 52), generator=g, device="cuda")
            for _ in range(2))
    bias = (torch.randn(bias_shape, generator=g, device="cuda")
            if bias_shape else None)
    _check_f32_lse(q, k, v, bias, 52 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_f32_route_fully_masked_tiles(cuda, d):
    # a bias of -inf over the whole first key tile and over the tail tile
    # (keys 128, 129): the running max starts at -inf and a tile adds
    # nothing, without a NaN
    g = torch.Generator("cuda").manual_seed(d)
    q = torch.randn((1, 2, 150, d), generator=g, device="cuda")
    k, v = (torch.randn((1, 2, 130, d), generator=g, device="cuda")
            for _ in range(2))
    bias = torch.randn((2, 150, 130), generator=g, device="cuda")
    bias[..., :64] = float("-inf")
    bias[..., 128:] = float("-inf")
    _check_f32_lse(q, k, v, bias, d ** -0.5)


@pytest.mark.cuda
def test_f32_route_rerun_gives_equal_bits(cuda):
    g = torch.Generator("cuda").manual_seed(7)
    q, k, v = (torch.randn((1, 12, 588, 64), generator=g, device="cuda")
               for _ in range(3))
    first = attn.flash_attention_fwd(q, k, v)
    assert all(torch.equal(first, attn.flash_attention_fwd(q, k, v))
               for _ in range(3))


@pytest.mark.cuda
def test_native_gif_codec_builds_into_the_package(cuda):
    import numpy as np

    from neurons_tpu_torch import native_io

    assert native_io.available()
    assert native_io.library_path().exists()
    assert native_io.library_path().parent == native_io.BUILD_DIR
    rng = np.random.default_rng(0)
    frames = np.repeat(rng.integers(0, 256, (6, 16, 24, 1), dtype=np.uint8)
                       // 64 * 64, 3, axis=-1)
    data = native_io.encode_gif(frames)
    assert data[:6] == b"GIF89a"
    assert np.array_equal(native_io.decode_gif(data), frames)


class _GradRecorder(torch.optim.Optimizer):
    """Keeps each parameter's .grad at `step`; moves nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = []

    def step(self, closure=None):
        self.grads = [p.grad.detach().cpu().clone()
                      for g in self.param_groups for p in g["params"]]


@pytest.mark.cuda
def test_autoencoder_steps_card_against_cpu(cuda):
    """One generator and one discriminator step of the full-width trainer
    (`VAEConfig()`, LPIPS VGG16, the 3-layer PatchGAN, f32 without TF32
    but the flash kernels' own, 128 px so that
    the VAE's mid attention runs 256 tokens at d 512 through the flash
    kernels) on the card and on the CPU from the same weights, images and
    posterior noise, with a gradient recorder in place of Adam: losses and
    logs within 2e-3 relative, every gradient within 2e-2 of its module's
    largest, the discriminator's running statistics within 1e-3 of max;
    the flash launches as counted (2 forwards with lse and 2 backwards a
    generator step, 2 plain forwards a discriminator step)."""
    from neurons_tpu_torch.interop.torch_export import jax_tree
    from neurons_tpu_torch.training import train_autoencoder as tta
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as the CPU
    cfg = tta.AutoencoderTrainConfig(disc_start=0)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((2, 3, 128, 128), generator=gen) * 2 - 1
    noise = torch.randn((2, 4, 16, 16), generator=gen)
    torch.manual_seed(0)
    cpu_eng = tta.AutoencodingEngine(cfg)
    states = {"cpu": cpu_eng.init("cpu")}
    engines = {"cpu": cpu_eng, "cuda": tta.AutoencodingEngine(
        cfg, lpips_params=jax_tree(cpu_eng.lpips))}
    states["cuda"] = engines["cuda"].init("cuda")
    for name in ("vae", "disc"):
        getattr(states["cuda"], name).load_state_dict(
            getattr(states["cpu"], name).state_dict())
    runs = {}
    for dev, st in states.items():
        st.opt_g = _GradRecorder(st.gen_params())
        st.opt_d = _GradRecorder(list(st.disc.parameters()))
        eng = engines[dev]
        fwd0, bwd0 = (attn.FLASH_FWD_LAUNCHES.total,
                      attn.FLASH_BWD_LAUNCHES.total)
        st, gl, glog = eng.make_generator_step()(st, x.to(dev),
                                                 noise.to(dev))
        g_launches = (attn.FLASH_FWD_LAUNCHES.total - fwd0,
                      attn.FLASH_BWD_LAUNCHES.total - bwd0)
        ggrads = st.opt_g.grads
        st, dl, dlog = eng.make_discriminator_step()(st, x.to(dev),
                                                     noise.to(dev))
        d_launches = attn.FLASH_FWD_LAUNCHES.total - fwd0 - g_launches[0]
        runs[dev] = dict(
            logs={**{k: float(v) for k, v in glog.items()},
                  **{k: float(v) for k, v in dlog.items()}},
            ggrads=ggrads, dgrads=st.opt_d.grads,
            stats={k: v.cpu() for k, v in st.disc.state_dict().items()
                   if "running" in k},
            launches=(g_launches, d_launches))
    cpu, card = runs["cpu"], runs["cuda"]
    assert cpu["launches"] == ((0, 0), 0)
    assert card["launches"] == ((2, 2), 2)
    assert cpu["logs"]["scalars/d_weight"] > 0
    for k, v in cpu["logs"].items():
        assert abs(card["logs"][k] - v) <= 2e-3 * max(abs(v), 1e-6), k
    for which in ("ggrads", "dgrads"):
        scale = max(float(g.abs().max()) for g in cpu[which])
        assert scale > 0
        for i, (a, b) in enumerate(zip(card[which], cpu[which])):
            assert float((a - b).abs().max()) <= 2e-2 * scale, (which, i)
    for k, v in cpu["stats"].items():
        assert float((card["stats"][k] - v).abs().max()) <= 1e-3 * float(
            v.abs().max()), k
