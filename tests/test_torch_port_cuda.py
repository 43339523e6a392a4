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
version's at that dtype, on each route (tensor cores, f32 pipelined,
warp). The GroupNorm+SiLU and GroupNorm+SiLU+conv kernels are held the
same way, #7 on each of its paths (one cluster launch, statistics then apply); the plain conv on f32 input is
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


# The bf16 wgmma route (csrc/flash_attn_fwd_sm90.cu): every launched shape
# class of the paths (B and H cut where the class stays the same: the
# per-(b, h) work and its ragged last query block and key tile are kept),
# with lse at the stage-2 step's sites; the route each launch took, its
# error (1.5x the plain version's), a rerun's bits
WGMMA_SHAPES = [
    # (B, H, Tq, Tk, D, lse)
    (2, 2, 2304, 2304, 64, False),   # UNet self 48x48, SVD 36x64
    (2, 2, 2304, 256, 64, False),    # UNet cross 48x48
    (2, 3, 576, 576, 64, False),     # UNet self 24x24, SVD 18x32
    (2, 3, 576, 256, 64, False),     # UNet cross 24x24
    (4, 3, 144, 144, 64, False),     # SVD mid 9x16
    (6, 1, 256, 256, 128, False),    # DecoderVideo 16x16
    (6, 1, 1024, 1024, 64, False),   # DecoderVideo 32x32
    (6, 1, 4096, 4096, 32, False),   # DecoderVideo 64x64
    (4, 2, 1024, 1024, 40, False),   # UNet3D 32x32
    (4, 2, 256, 256, 80, False),     # UNet3D 16x16
    (2, 4, 257, 257, 88, False),     # BLIP-2's vision tower
    (6, 1, 256, 256, 128, True),     # the stage-2 step's forward
    (6, 1, 1024, 1024, 64, True),
    (6, 1, 4096, 4096, 32, True),
    # ragged rows and keys at the narrow column blocks, a single row
    (1, 3, 130, 257, 40, False), (2, 2, 257, 300, 88, True),
    (1, 2, 1, 5, 64, False), (1, 2, 200, 129, 128, True),
]


def _route_of_last_launch(before):
    grown = [r for (r, key), n in attn.FLASH_FWD_LAUNCHES.by_route.items()
             if n != before.get((r, key), 0)]
    assert len(grown) == 1, grown
    return grown[0]


def _check_wgmma(q, k, v, lse=False):
    before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
    got = attn.flash_attention_fwd(q, k, v, return_lse=lse)
    torch.cuda.synchronize()
    assert _route_of_last_launch(before) == attn.WGMMA_ROUTE
    again = attn.flash_attention_fwd(q, k, v, return_lse=lse)
    out, out2 = (got[0], again[0]) if lse else (got, again)
    assert torch.equal(out, out2) and (not lse or torch.equal(got[1], again[1]))
    args = [x.double() for x in (q, k, v)]
    want, want_lse = attn.attention_reference_lse(*args)
    plain, plain_lse = attn.attention_reference_lse(q, k, v)
    err = (out.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    print(f"wgmma {tuple(q.shape)} k {tuple(k.shape)} lse {lse}: err "
          f"{err:.3e}, plain {plain_err:.3e}, ratio "
          f"{err / max(plain_err, 1e-30):.3f}")
    assert err <= 1.5 * plain_err, err
    if lse:
        err = (got[1].double() - want_lse).abs().max().item()
        plain_err = (plain_lse.double() - want_lse).abs().max().item()
        print(f"  lse: err {err:.3e}, plain {plain_err:.3e}")
        assert err <= 1.5 * plain_err, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_route_at_every_launched_shape_class(cuda, shape):
    b, h, tq, tk, d, lse = shape
    g = torch.Generator("cuda").manual_seed(tq + tk + d)
    q = torch.randn((b, h, tq, d), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, h, tk, d), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    _check_wgmma(q, k, v, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 88])
def test_wgmma_route_reads_split_views_in_place(cuda, d):
    # the models' split: [B, T, 3 H D] chunked and viewed as [B, H, T, D]
    # (token stride 3 H D, head stride D): the tensor maps read the view
    g = torch.Generator("cuda").manual_seed(d)
    b, t, h = 2, 300, 3
    x = torch.randn((b, t, 3 * h * d), generator=g, device="cuda").bfloat16()
    q, k, v = (y.reshape(b, t, h, d).transpose(1, 2) for y in x.chunk(3, -1))
    assert not q.is_contiguous() and q.stride(2) == 3 * h * d
    _check_wgmma(q, k, v)


@pytest.mark.cuda
def test_wgmma_route_takes_multi_query_kv(cuda):
    # k/v with one head: a head extent of 1 read at coordinate 0
    g = torch.Generator("cuda").manual_seed(3)
    q = torch.randn((2, 4, 300, 64), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((2, 1, 270, 64), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    _check_wgmma(q, k, v, lse=True)


@pytest.mark.cuda
def test_flash_route_names_the_kernel_each_launch_takes(cuda):
    g = torch.Generator("cuda").manual_seed(4)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    rows52 = rand(1, 2, 150, 56)[..., :52]  # 104-byte rows: not TMA's
    rows512 = rand(1, 1, 150, 516)[..., :512]  # 1032-byte rows: not TMA's
    cases = [
        # (q, k, v, bias, route[, lse])
        (rand(1, 2, 150, 64),) * 3 + (None, attn.WGMMA_ROUTE),
        (rand(1, 2, 150, 88),) * 3 + (None, attn.WGMMA_ROUTE),
        (rows52,) * 3 + (None, "flash_fwd_reg_kernel"),
        (rand(1, 2, 150, 56),) * 3 + (None, "flash_fwd_reg_kernel"),
        (rand(1, 2, 150, 64),) * 3 + (rand(2, 150, 150),
                                      "flash_fwd_reg_kernel"),
        (rand(1, 2, 150, 64, dtype=torch.float32),) * 3
        + (None, attn.TF32_WGMMA_ROUTE),
        (rand(1, 2, 150, 64, dtype=torch.float32),) * 3
        + (rand(2, 150, 150, dtype=torch.float32), attn.TF32_WGMMA_ROUTE,
           True),
        (rand(1, 2, 150, 65, dtype=torch.float32)[..., :64],) * 3
        + (None, "flash_fwd_tf32_kernel"),
        (rand(1, 2, 150, 4, dtype=torch.float32),) * 3
        + (None, "flash_fwd_tf32_kernel"),
        (rand(1, 1, 150, 512),) * 3 + (None, attn.WIDE_WGMMA_ROUTE),
        (rand(1, 1, 150, 512),) * 3 + (None, "flash_fwd_wide_kernel", True),
        (rand(1, 1, 150, 512),) * 3 + (rand(150, 150),
                                       "flash_fwd_wide_kernel"),
        (rows512,) * 3 + (None, "flash_fwd_wide_kernel"),
        (rand(1, 1, 150, 136),) * 3 + (None, "flash_fwd_wide_kernel"),
        (rand(1, 1, 150, 512, dtype=torch.float32),) * 3
        + (None, "flash_fwd_wide_tf32_kernel"),
    ]
    for q, k, v, bias, route, *lse in cases:
        lse = bool(lse and lse[0])
        before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
        attn.flash_attention_fwd(q, k, v, bias=bias, return_lse=lse)
        took = _route_of_last_launch(before)
        aligned = attn._granule(q.shape[-1], q.element_size(),
                                (q.stride(2),), (q,)) == 16
        assert took == route == attn.flash_route(
            q.shape[-1], q.dtype, biased=bias is not None, aligned=aligned,
            lse=lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 40, 48, 64, 72, 80, 88, 96, 120, 128])
def test_wgmma_plan_matches_the_python_tables(cuda, d):
    bw, nb = attn.wgmma_blocks(d)
    bq, bk, stages = attn.wgmma_tiles(d)
    plan = attn.wgmma_plan(d)
    assert plan[:5] == (bq, bk, bw, nb, stages)
    assert plan[5] <= 232448
    assert attn.wgmma_plan(56) is None and attn.wgmma_plan(24) is None


def _check_wide(q, k, v):
    # the wide wgmma route (csrc/flash_attn_fwd_wide_sm90.cu): its launch,
    # equal bits on a rerun (the parts' combine in a fixed order), and the
    # 1.5x rule against f64 beside the bf16 plain version
    before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
    got = attn.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert _route_of_last_launch(before) == attn.WIDE_WGMMA_ROUTE
    assert torch.equal(got, attn.flash_attention_fwd(q, k, v))
    want = attn.attention_reference(*(x.double() for x in (q, k, v)))
    plain = attn.attention_reference(q, k, v)
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    print(f"wide wgmma {tuple(q.shape)} k {tuple(k.shape)} parts "
          f"{attn.wide_wgmma_parts(*q.shape[:3], k.shape[2])[0]}: err "
          f"{err:.3e}, plain {plain_err:.3e}, ratio "
          f"{err / max(plain_err, 1e-30):.3f}")
    assert bool(torch.isfinite(got).all())
    assert err <= 1.5 * plain_err, err


# every d 512 shape class the paths launch on the wide wgmma route (the
# VAE's mid attention: 96^2 in 4 key parts, 64^2 in 2, the video decode's
# 16 rows of 32^2 in one, the keyframe's 32^2 in 4, SVD's temporal decoder
# in one over 7.6 waves)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 9216), (1, 4096), (16, 1024),
                                   (1, 1024), (7, 9216)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_wide_wgmma_at_every_launched_shape_class(cuda, shape):
    b, t = shape
    g = torch.Generator("cuda").manual_seed(t + b)
    q, k, v = (torch.randn((b, 1, t, 512), generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    _check_wide(q, k, v)


# ragged rows and keys (a partial query block, a last key tile of 1 to 31
# keys, several parts), head
# dims between 128 and 512 (multiples of 64: column blocks past D never
# loaded), and multi-query k/v
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,d", [
    (1, 1, 1, 200, 333, 512), (1, 1, 1, 130, 1000, 512),
    (2, 1, 1, 64, 257, 512), (1, 2, 1, 150, 600, 512),
    (1, 1, 1, 150, 500, 192), (2, 2, 2, 140, 300, 320),
    (1, 1, 1, 100, 700, 384)])
def test_wide_wgmma_ragged_and_narrower(cuda, b, h, hkv, tq, tk, d):
    g = torch.Generator("cuda").manual_seed(tq * tk + d)
    q = torch.randn((b, h, tq, d), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, hkv, tk, d), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    _check_wide(q, k, v)


@pytest.mark.cuda
def test_wide_wgmma_reads_the_models_views_in_place(cuda):
    # the VAE's q, k, v: one nn.Linear output [B, T, 3 * 512] split and
    # viewed as [B, 1, T, 512] ([:, None]), read through its strides
    g = torch.Generator("cuda").manual_seed(11)
    x = torch.randn((2, 1100, 3 * 512), generator=g,
                    device="cuda").bfloat16()
    q, k, v = (y[:, None] for y in x.split(512, dim=-1))
    assert not q.is_contiguous() and q.stride(2) == 3 * 512
    _check_wide(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 9216, 9216), (1, 1, 4096, 4096),
                                   (16, 1, 1024, 1024), (1, 1, 1024, 1024),
                                   (7, 1, 9216, 9216), (2, 1, 9216, 9216),
                                   (1, 1, 130, 1000), (3, 2, 777, 5000)])
def test_wide_wgmma_plan_matches_the_python_tables(cuda, shape):
    # the library's constants are the host's; the kernel takes the host's
    # parts and grid, gives equal bits whatever grid deals the units, and
    # refuses parts that leave keys out or a part empty, or a grid past
    # the units
    plan = attn.wide_wgmma_plan()
    assert plan[:4] == (attn.WIDE_BQ, attn.WIDE_BK, attn.WIDE_STAGES,
                        attn.WIDE_MAX_PARTS)
    assert plan[4] <= 232448
    b, h, tq, tk = shape
    parts, per, units = attn.wide_wgmma_parts(*shape)
    ntiles = -(-tk // attn.WIDE_BK)
    assert 1 <= parts <= attn.WIDE_MAX_PARTS
    assert (parts - 1) * per < ntiles <= parts * per
    assert units == -(-tq // attn.WIDE_BQ) * b * h * parts
    lib = attn._library("flash_attn_fwd_wide_sm90")
    g = torch.Generator("cuda").manual_seed(tq + tk)
    x = torch.randn((b, h, max(tq, tk), 512), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    work = torch.empty(max(attn.wide_wgmma_scratch(*shape, 512), 16),
                       dtype=torch.uint8, device="cuda")
    strides = (x.stride(0), x.stride(1), x.stride(2)) * 3

    def launch(n, per_part, grid, out):
        return lib.flash_attn_fwd_wide_sm90(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(),
            work.data_ptr(), work.numel(), *strides, b, h, h, tq, tk, 512,
            n, per_part, grid, 0.05, torch.cuda.current_stream().cuda_stream)

    outs = []
    for grid in sorted({1, min(units, 132), units}):
        outs.append(torch.empty((b, h, tq, 512), device="cuda",
                                dtype=torch.bfloat16))
        assert launch(parts, per, grid, outs[-1]) == 0
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    out = outs[0]
    assert launch(parts, per - 1, units, out) != 0      # keys left out
    assert launch(parts + 1, per, units, out) != 0      # the last part empty
    assert launch(attn.WIDE_MAX_PARTS + 1, 1, units, out) != 0
    assert launch(parts, per, units + 1, out) != 0
    assert launch(parts, per, 0, out) != 0


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_temporal_kernel_at_a_path_shape(cuda, dtype):
    # the UNet3D's 16x16 motion modules, CFG batch: [(2 x 16), 256, 640]
    # (the clip in bf16, validate in f32)
    _check_temporal(32, 256, 640, 16, 8, getattr(torch, dtype))


# (F, hd, dtype) -> route: bf16 with F <= 16 and 16-byte head rows takes
# the tensor cores; f32 with F <= 16 and 16-byte head rows up to hd 160
# (validate's and the tiny chain's) the pipelined f32 route; F = 24, hd 4
# in bf16 and hd 2 or 168 in f32 keep the warp route
TEMPORAL_ROUTES = [(16, 8, "bfloat16", "tensor cores"),
                   (16, 40, "bfloat16", "tensor cores"),
                   (16, 80, "bfloat16", "tensor cores"),
                   (16, 160, "bfloat16", "tensor cores"),
                   (4, 40, "bfloat16", "tensor cores"),
                   (16, 40, "float32", "f32 pipelined"),
                   (16, 80, "float32", "f32 pipelined"),
                   (16, 160, "float32", "f32 pipelined"),
                   (4, 4, "float32", "f32 pipelined"),
                   (4, 8, "float32", "f32 pipelined"),
                   (12, 44, "float32", "f32 pipelined"),
                   (24, 40, "bfloat16", "warp"),
                   (24, 40, "float32", "warp"),
                   (16, 4, "bfloat16", "warp"),
                   (16, 2, "float32", "warp"),
                   (16, 168, "float32", "warp")]


@pytest.mark.cuda
@pytest.mark.parametrize("f,hd,dtype,route", TEMPORAL_ROUTES, ids=str)
def test_temporal_routes(cuda, f, hd, dtype, route):
    # D = 7 pixels and H = 2: tiles of 4 units cross batch rows
    dt = getattr(torch, dtype)
    assert ta.temporal_plan(f, hd, dt).route == route
    _check_temporal(2 * f, 7, 2 * hd, f, 2, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("level", [(32, 1024, 320), (32, 64, 1280),
                                   (32, 16, 1280), (16, 16, 1280)], ids=str)
def test_temporal_kernel_at_the_other_path_levels(cuda, level, dtype):
    # the UNet3D's 32x32, 8x8 and 4x4 motion modules (CFG batch, 16
    # frames, 8 heads; the clip in bf16, validate in f32) and the 4x4
    # level of one clip: many tiles a persistent block, so the copy ring
    # wraps; the 4x4 levels have fewer tiles than resident blocks
    _check_temporal(*level, 16, 8, getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [(32, 1024, 320), (32, 256, 640),
                                   (32, 16, 1280), (16, 64, 8)], ids=str)
def test_temporal_f32_route_reruns_bitwise(cuda, level):
    # validate's levels and the tiny chain's [16, 64, 8] (F 4, 2 heads):
    # each output's sums run in a fixed order, so a rerun gives equal bits
    bf, d, c = level
    f, h = (4, 2) if c == 8 else (16, 8)
    assert ta.temporal_plan(f, c // h, torch.float32).route == "f32 pipelined"
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v = (torch.randn((bf, d, c), generator=g, device="cuda")
               for _ in range(3))
    scale = (c // h) ** -0.5
    first = ta.temporal_attention_fwd(q, k, v, f, h, scale)
    again = ta.temporal_attention_fwd(q, k, v, f, h, scale)
    assert torch.equal(first, again)


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
def _check_train(b, h, tq, tk, d, hkv, bias_shape, dtype, seed=3, row=None,
                 route=None):
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
    _check_train_on(q, k, v, bias, go, route)


def _check_train_on(q, k, v, bias, go, route=None):
    # the kernels' forward and backward on these tensors against the plain
    # path, both against float64 autograd; `route`: the backward's kernels
    # the launch must take
    (b, h, tq, d), (hkv, tk) = q.shape, k.shape[1:3]
    bias_shape = None if bias is None else tuple(bias.shape)
    dtype = q.dtype
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
    routes0 = dict(attn.FLASH_BWD_LAUNCHES.by_route)
    out, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                        return_lse=True)
    got = dict(zip(("dq", "dk", "dv", "dbias"), attn.flash_attention_bwd(
        q, k, v, bias, go, out, lse, scale)), out=out, lse=lse)
    torch.cuda.synchronize()
    assert attn.FLASH_FWD_LAUNCHES.total == fwd0 + 1
    assert attn.FLASH_BWD_LAUNCHES.total == bwd0 + 1
    (took,) = [r for (r, key), n in attn.FLASH_BWD_LAUNCHES.by_route.items()
               if n != routes0.get((r, key), 0)]
    assert route is None or took == route, (took, route)
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


# the backward's register instances (bf16: head dims padded to 32, 64,
# 96, 128; f32, the TF32 ones: 32, 64, 128) at head dims off them,
# unbiased and with a per-head bias over multi-query k/v, ragged Tq and Tk
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("biased", [False, True], ids=["nobias", "per_head"])
@pytest.mark.parametrize("d", [16, 40, 52, 80, 96, 128])
def test_backward_at_every_head_dim(cuda, d, biased, dtype):
    _check_train(2, 3, 150, 190, d, 1 if biased else 3,
                 (3, 150, 190) if biased else None, getattr(torch, dtype),
                 seed=d)


# rows that move in 16, 8, 4 or (bf16) 2 bytes (d = 52 and 50 contiguous,
# d = 52 from rows of 53 or 54), and an odd Tk, whose bias rows move
# element by element (bf16) or in 4-byte copies (f32)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,row,tk", [(52, 52, 140), (50, 50, 140),
                                      (52, 53, 140), (52, 54, 140),
                                      (40, 40, 131)])
def test_backward_takes_rows_off_16_bytes(cuda, d, row, tk, dtype):
    _check_train(2, 2, 77, tk, d, 1, (2, 77, tk), getattr(torch, dtype),
                 seed=12, row=row)


# the prior's [10, 32, 513, 514, 52] multi-query with its per-head bias,
# in bf16 and in f32 (stage 2's f32 step)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_kernels_at_the_prior_shape(cuda, dtype):
    _check_train(10, 32, 513, 514, 52, 1, (32, 513, 514),
                 getattr(torch, dtype))


# the f32 backward with a bias slice shared by several rows (its dbias
# summed over them by the dbias pass in row order) and per (b, h) gives
# equal bits on every rerun
@pytest.mark.cuda
@pytest.mark.parametrize("bias_shape", [(129, 130), (4, 129, 130),
                                        (3, 4, 129, 130)],
                         ids=["shared", "per_head", "per_bh"])
def test_f32_backward_rerun_gives_equal_bits_with_a_bias(cuda, bias_shape):
    g = torch.Generator("cuda").manual_seed(129)
    q, go = (torch.randn((3, 4, 129, 52), generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((3, 1, 130, 52), generator=g, device="cuda")
            for _ in range(2))
    bias = torch.randn(bias_shape, generator=g, device="cuda")
    out, lse = attn.flash_attention_fwd(q, k, v, bias=bias, return_lse=True)
    first = attn.flash_attention_bwd(q, k, v, bias, go, out, lse, 52 ** -0.5)
    assert all(bool(torch.isfinite(x).all()) for x in first)
    for _ in range(3):
        again = attn.flash_attention_bwd(q, k, v, bias, go, out, lse,
                                         52 ** -0.5)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# The bf16 wgmma backward (csrc/flash_attn_bwd_sm90.cu): the stage-2 step's
# DecoderVideo sites (B cut: the per-(b, h) work and its blocks stay), a
# ragged multi-query case, Tq != Tk at each head dim, each held by
# `_check_train` (1.5x the plain version's error against float64, a
# rerun's bits) on the route it took
WGMMA_BWD_SHAPES = [
    # (B, H, Tq, Tk, D, kv heads)
    (6, 1, 256, 256, 128, 1),    # DecoderVideo 16x16
    (4, 1, 1024, 1024, 64, 1),   # DecoderVideo 32x32
    (2, 1, 4096, 4096, 32, 1),   # DecoderVideo 64x64
    (2, 4, 513, 514, 64, 1),     # ragged, multi-query
    (1, 3, 300, 200, 128, 3),
    (2, 2, 70, 130, 32, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_backward_at_every_launched_shape_class(cuda, shape):
    _check_train(*shape, None, torch.bfloat16, seed=sum(shape),
                 route=attn.BWD_WGMMA_ROUTE)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_wgmma_backward_reads_split_views_in_place(cuda, d):
    # the models' split: [B, T, 3 H D] chunked and viewed as [B, H, T, D]
    # (token stride 3 H D, head stride D): the tensor maps read the views
    g = torch.Generator("cuda").manual_seed(d)
    b, t, h = 2, 300, 2
    x, go = (torch.randn((b, t, n * h * d), generator=g, device="cuda")
             .bfloat16() for n in (3, 1))
    q, k, v = (y.reshape(b, t, h, d).transpose(1, 2) for y in x.chunk(3, -1))
    assert not q.is_contiguous() and q.stride(2) == 3 * h * d
    _check_train_on(q, k, v, None, go.reshape(b, t, h, d).transpose(1, 2),
                    route=attn.BWD_WGMMA_ROUTE)


@pytest.mark.cuda
@pytest.mark.parametrize("d,row", [(64, 68), (32, 36), (96, 96)])
def test_backward_off_tma_takes_the_register_kernels(cuda, d, row):
    # 136- and 72-byte token strides (8-byte granules: no TMA map) and d 96
    # (no wgmma instance) keep the register kernels
    _check_train(2, 2, 150, 190, d, 2, None, torch.bfloat16, seed=row,
                 row=row, route="flash_bwd_dkdv_reg_kernel+"
                 "flash_bwd_dq_reg_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_wgmma_bwd_plan_matches_the_python_tables(cuda, d):
    plan = attn.wgmma_bwd_plan(d)
    assert plan[:7] == attn.wgmma_bwd_tiles(d)
    assert max(plan[7:]) <= 232448
    # the host's rule for the register kernels (flash_bwd_route, off the
    # wgmma route) is the library's
    assert attn._tiles(d, torch.bfloat16, "flash_attn_bwd")[0] == 2


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
    # the 4x4 level splits its input channels across the wgmma kernel's
    # blocks; the 32x32 level fills the card without; a split call gives
    # the same bits twice
    sms = fc._sm_count(torch.device("cuda"))
    assert fc.conv_route(32, 1280, 4, 4, 1280, torch.bfloat16, sms) \
        == fc.WGMMA_CONV_ROUTE
    assert fc.conv_plan_sm90(32, 1280, 4, 4, 1280, sms)["splits"] > 1
    assert fc.conv_plan_sm90(32, 320, 32, 32, 320, sms)["splits"] == 1
    x, gw, gb, g = _gn_inputs(32, 1280, 4, 4, 0.0, 8)
    cw = torch.randn((1280, 1280, 3, 3), generator=g, device="cuda") / 107.0
    cb = 0.1 * torch.randn((1280,), generator=g, device="cuda")
    args = [t.to(torch.bfloat16) for t in (x, gw, gb, cw, cb)]
    first = fc.gn_silu_conv_fwd(*args, 32, 1e-5)
    again = fc.gn_silu_conv_fwd(*args, 32, 1e-5)
    assert torch.equal(first, again)
    _check_gn_silu_conv(32, 1280, 4, 4, 1280, 32, torch.bfloat16, seed=8)


@pytest.mark.cuda
def test_halo_conv_split_is_deterministic(cuda):
    # the staged-halo kernel (36-pixel samples: no wgmma plan) splits 960
    # input channels over its blocks and reduces them in a fixed order
    shape = (2, 960, 6, 6, 320)
    assert fc.conv_route(*shape, torch.bfloat16) == fc.HALO_CONV_ROUTE
    assert fc.conv_plan(*shape)["splits"] > 1
    assert _conv_route_launches(shape, fc.HALO_CONV_ROUTE, seed=9) == 1
    x, gw, gb, g = _gn_inputs(*shape[:4], 0.0, 9)
    cw = torch.randn((320, 960, 3, 3), generator=g, device="cuda") / 93.0
    args = [t.to(torch.bfloat16) for t in (x, gw, gb, cw)] + [None]
    assert torch.equal(fc.gn_silu_conv_fwd(*args, 32, 1e-5),
                       fc.gn_silu_conv_fwd(*args, 32, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 16, 16, 64),
                                   (32, 1280, 4, 4, 1280)],
                         ids=lambda s: "x".join(map(str, s)))
def test_halo_conv_takes_x_off_16_bytes(cuda, shape):
    # a wgmma-route map with x one element past a 16-byte boundary (TMA
    # cannot address it) launches the staged-halo kernel, within 1.5x the
    # plain version's error against float64 and bitwise on a rerun
    n, cin, h, w, cout = shape
    x, gw, gb, g = _gn_inputs(n, cin, h, w, 0.0, 14)
    cw = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") \
        / (9 * cin) ** 0.5
    cb = 0.1 * torch.randn((cout,), generator=g, device="cuda")
    x, gw, gb, cw, cb = (t.to(torch.bfloat16) for t in (x, gw, gb, cw, cb))
    off = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")[
        1:1 + x.numel()].view(x.shape).copy_(x)
    assert off.data_ptr() % 16 != 0
    assert fc.conv_route(*shape, torch.bfloat16, aligned=False) \
        == fc.HALO_CONV_ROUTE
    key = (fc.HALO_CONV_ROUTE, shape + (32, "bfloat16"))
    before = fc.GN_SILU_CONV_LAUNCHES.by_route[key]
    got = fc.gn_silu_conv_fwd(off, gw, gb, cw, cb, 32, 1e-5)
    torch.cuda.synchronize()
    assert fc.GN_SILU_CONV_LAUNCHES.by_route[key] == before + 1
    assert torch.equal(got, fc.gn_silu_conv_fwd(off, gw, gb, cw, cb, 32,
                                                1e-5))
    want = fc.gn_silu_conv_reference(*(t.double() for t in (x, gw, gb, cw,
                                                             cb)), 32, 1e-5)
    plain = fc.gn_silu_conv_reference(x, gw, gb, cw, cb, 32, 1e-5)
    _report(f"staged-halo gn_silu_conv, x off 16 bytes, {shape}",
            (got.double() - want).abs().max().item(),
            (plain.double() - want).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_silu_conv_kernel_large_mean(cuda, dtype):
    _check_gn_silu_conv(2, 64, 12, 12, 64, 32, getattr(torch, dtype),
                        mean=100.0)


# The wgmma kernel (csrc/gn_silu_conv_sm90.cu) at every shape of the fused
# clip, on the route conv_route names, with a rerun giving equal bits
CONV_CLIP_SHAPES = [
    (2, 320, 48, 48, 640), (2, 320, 96, 96, 4), (2, 320, 96, 96, 320),
    (2, 640, 24, 24, 1280), (2, 640, 48, 48, 640), (2, 640, 96, 96, 320),
    (2, 960, 48, 48, 640), (2, 960, 96, 96, 320), (2, 1280, 24, 24, 1280),
    (2, 1280, 48, 48, 640), (2, 1920, 24, 24, 1280), (2, 1920, 48, 48, 640),
    (2, 2560, 24, 24, 1280), (32, 320, 16, 16, 640), (32, 320, 32, 32, 320),
    (32, 640, 8, 8, 1280), (32, 640, 16, 16, 640), (32, 640, 32, 32, 320),
    (32, 960, 16, 16, 640), (32, 960, 32, 32, 320), (32, 1280, 4, 4, 1280),
    (32, 1280, 8, 8, 1280), (32, 1280, 16, 16, 640), (32, 1920, 8, 8, 1280),
    (32, 1920, 16, 16, 640), (32, 2560, 4, 4, 1280), (32, 2560, 8, 8, 1280)]


def _conv_route_launches(shape, route, groups=32, **kw):
    key = (route, tuple(shape) + (groups, "bfloat16"))
    before = fc.GN_SILU_CONV_LAUNCHES.by_route[key]
    _check_gn_silu_conv(*shape, groups, torch.bfloat16, **kw)
    return fc.GN_SILU_CONV_LAUNCHES.by_route[key] - before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_CLIP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_conv_clip_shapes(cuda, shape):
    assert fc.conv_route(*shape, torch.bfloat16) == fc.WGMMA_CONV_ROUTE
    assert _conv_route_launches(shape, fc.WGMMA_CONV_ROUTE) == 1
    x, gw, gb, g = _gn_inputs(*shape[:4], 0.0, 12)
    cw = torch.randn((shape[4], shape[1], 3, 3), generator=g,
                     device="cuda") / (9 * shape[1]) ** 0.5
    args = [t.to(torch.bfloat16) for t in (x, gw, gb, cw)] + [None]
    assert torch.equal(fc.gn_silu_conv_fwd(*args, 32, 1e-5),
                       fc.gn_silu_conv_fwd(*args, 32, 1e-5))


# One shape each side of the wgmma route's boundaries: rows of 8 pixels
# (rows mode, a tile 16 rows) against whole samples of 64 pixels, and a
# map of 16 rows of 8 (the halo box would be taller than the map) on the
# staged-halo kernel; rows of 12 and 20 pixels (TMA cannot address them)
# and 36-pixel samples (they do not divide the tile) on it too; Cout 24 on
# the N tile of 160 and 170 on the one of 256; Cin off the 32-channel
# chunk; an odd count of pixel tiles in either mode (5 tiles of a 24x24 map,
# one tile of 3 of its 8 samples at 4x4: the persistent grid's last tile
# partial)
CONV_ROUTE_SHAPES = [
    ((1, 64, 32, 8, 64), fc.WGMMA_CONV_ROUTE),
    ((1, 64, 16, 8, 64), fc.HALO_CONV_ROUTE),
    ((4, 64, 8, 8, 64), fc.WGMMA_CONV_ROUTE),
    ((2, 64, 12, 12, 64), fc.HALO_CONV_ROUTE),
    ((1, 64, 20, 20, 64), fc.HALO_CONV_ROUTE),
    ((2, 64, 6, 6, 64), fc.HALO_CONV_ROUTE),
    ((2, 80, 24, 24, 24), fc.WGMMA_CONV_ROUTE),
    ((3, 40, 16, 16, 170), fc.WGMMA_CONV_ROUTE),
    ((1, 64, 24, 24, 64), fc.WGMMA_CONV_ROUTE),
    ((3, 64, 4, 4, 64), fc.WGMMA_CONV_ROUTE),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_ROUTE_SHAPES,
                         ids=lambda c: "x".join(map(str, c[0])))
def test_wgmma_conv_route_boundaries(cuda, case):
    shape, route = case
    assert fc.conv_route(*shape, torch.bfloat16) == route
    assert _conv_route_launches(shape, route, groups=8) == 1


@pytest.mark.cuda
def test_wgmma_conv_large_mean(cuda):
    # the centred statistics on the wgmma route
    shape = (2, 64, 16, 16, 64)
    assert fc.conv_route(*shape, torch.bfloat16) == fc.WGMMA_CONV_ROUTE
    assert _conv_route_launches(shape, fc.WGMMA_CONV_ROUTE, mean=100.0) == 1


@pytest.mark.cuda
def test_wgmma_conv_refuses_a_plan_that_does_not_fit(cuda, monkeypatch):
    # the C entry point recomputes the plan's shared memory and tiles and
    # returns an error where the wrapper's plan disagrees: a raise, not a
    # launch; so does the wrapper for a weight of the wrong shape
    x, gw, gb, g = _gn_inputs(2, 64, 16, 16, 0.0, 13)
    cw = 0.1 * torch.randn((64, 64, 3, 3), generator=g, device="cuda")
    args = [t.to(torch.bfloat16) for t in (x, gw, gb, cw)] + [None]
    good = fc.conv_plan_sm90(2, 64, 16, 16, 64, fc._sm_count(x.device))
    for key, value in (("smem", good["smem"] + 16), ("rb", good["rb"] - 1),
                       ("cps", 0)):
        bad = dict(good, **{key: value})
        monkeypatch.setattr(fc, "conv_plan_sm90", lambda *a, **k: bad)
        before = fc.GN_SILU_CONV_LAUNCHES.total
        with pytest.raises(RuntimeError, match="gn_silu_conv_wgmma_kernel"):
            fc.gn_silu_conv_fwd(*args, 32, 1e-5)
        assert fc.GN_SILU_CONV_LAUNCHES.total == before
    # a conv weight of the wrong shape is refused before any launch
    monkeypatch.undo()
    bad_w = torch.zeros((64, 63, 3, 3), device="cuda", dtype=torch.bfloat16)
    before = fc.GN_SILU_CONV_LAUNCHES.total
    with pytest.raises(ValueError, match="conv weight"):
        fc.gn_silu_conv_fwd(args[0], args[1], args[2], bad_w, None, 32, 1e-5)
    assert fc.GN_SILU_CONV_LAUNCHES.total == before


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


# The f32 route: the TF32 wgmma kernel (flash_fwd_tf32_wgmma_kernel) at d
# <= 128 on 16-byte rows, the TF32 column-split kernel past it. Stage 6 in
# f32 (ViT-B a frame, VideoMAE
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
    # on 16-byte rows the TF32 wgmma kernel (DN = d rounded up to 8); off
    # them the TF32 register kernel, whose instances pad d to 32, 64 or 128
    # (64 or 32 keys a tile, rows of d + 4 floats, a 3-stage K/V ring); past
    # 128 the TF32 column-split kernel (32 rows, 16 keys a tile)
    route = attn.flash_route(d, torch.float32)
    if d <= 128:
        dk = 32 if d <= 32 else 64 if d <= 64 else 128
        bk = 64 if dk <= 64 else 32
        assert route == attn.TF32_WGMMA_ROUTE
        assert attn.tf32_wgmma_dn(d) == -(-d // 8) * 8
        assert attn.flash_route(d, torch.float32, aligned=False) == (
            "flash_fwd_tf32_kernel")
        assert attn.flash_tiles(d, torch.float32) == (
            64, bk, 3 * 2 * bk * (dk + 4) * 4)
    else:
        assert route == "flash_fwd_wide_tf32_kernel"
    assert attn.flash_route(d, torch.bfloat16) not in (
        "flash_fwd_tf32_kernel", "flash_fwd_wide_tf32_kernel")


# The f32 route past d 128: the TF32 column-split forward
# (flash_fwd_wide_tf32_kernel) and, unbiased, backward
# (flash_bwd_{dkdv,dq}_wide_tf32_kernel) up to d 512; the first design past
# it. Shared memory: a 3-stage ring of 16-row tiles of 516 floats, 8 warps'
# partials of S (and dP) and P (and dS)
@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 256, 512, 576])
def test_f32_wide_routes_by_head_dim(cuda, d):
    fwd = attn.flash_route(d, torch.float32)
    bwd = attn.flash_bwd_route(d, torch.float32)
    if d <= 512:
        assert fwd == "flash_fwd_wide_tf32_kernel"
        assert bwd == ("flash_bwd_dkdv_wide_tf32_kernel"
                       "+flash_bwd_dq_wide_tf32_kernel")
        ring = 3 * 2 * 16 * 516
        assert attn.flash_tiles(d, torch.float32) == (
            32, 16, 4 * (ring + 8 * 32 * 24 + 32 * 24 + 64))
        assert attn.flash_tiles(d, torch.float32, "flash_attn_bwd") == (
            16, 16, 4 * (ring + 3 * 32 + 2 * 8 * 16 * 24 + 2 * 16 * 24))
    else:
        assert fwd == "flash_fwd_kernel"
        assert bwd == "flash_bwd_dkdv_kernel+flash_bwd_dq_kernel"
    assert attn.flash_bwd_route(64, torch.float32) == (
        attn.TF32_BWD_WGMMA_ROUTE)
    assert attn.flash_bwd_route(64, torch.float32, aligned=False) == (
        "flash_bwd_dkdv_tf32_kernel+flash_bwd_dq_tf32_kernel")
    assert attn.flash_bwd_route(64, torch.bfloat16) == attn.BWD_WGMMA_ROUTE
    assert attn.flash_bwd_route(64, torch.bfloat16, aligned=False) == (
        "flash_bwd_dkdv_reg_kernel+flash_bwd_dq_reg_kernel")


def _tf32_bwd_smem(dk, biased):
    # shared memory of the TF32 register backward's kernels at instance dk
    # (csrc/flash_attn_bwd.cu, Tf32Cfg): [64][dk + 4] f32 tiles, a bias
    # block [64][68], the ring stages chosen by tf32_stages
    tile, bias = 4 * 64 * (dk + 4), 4 * 64 * 68 if biased else 0

    def stages(fixed, stage):
        half, full = 115712, 232448
        return (2 if fixed + 2 * stage <= half else
                1 if fixed + stage <= half else
                2 if fixed + 2 * stage <= full else 1)

    s1 = 2 * tile + 512 + bias
    s2 = 2 * tile + bias
    s3 = 4 * tile + 512
    out = [2 * tile + stages(2 * tile, s1) * s1,
           2 * tile + stages(2 * tile, s2) * s2]
    if biased:
        out.append(4 * 64 * 68 + stages(4 * 64 * 68, s3) * s3)
    return out


# The f32 backward up to d 128 on rows off 16 bytes (rows of d + 1 floats,
# which TMA cannot address) is the TF32 register design at every head dim,
# biased or not: the route and tiles, and the kernels a launch runs (under
# torch.profiler), none of them the first design's
@pytest.mark.cuda
@pytest.mark.parametrize("bias_shape", [None, (150, 140), (3, 150, 140),
                                        (2, 3, 150, 140)],
                         ids=["none", "shared", "per_head", "per_bh"])
@pytest.mark.parametrize("d", [16, 52, 64, 128])
def test_f32_backward_routes_and_tiles_by_head_dim(cuda, d, bias_shape):
    from torch.profiler import ProfilerActivity, profile
    assert attn.flash_bwd_route(d, torch.float32, aligned=False) == (
        "flash_bwd_dkdv_tf32_kernel+flash_bwd_dq_tf32_kernel")
    dk = 32 if d <= 32 else 64 if d <= 64 else 128
    smem = max(_tf32_bwd_smem(dk, True) + _tf32_bwd_smem(dk, False))
    assert attn.flash_tiles(d, torch.float32, "flash_attn_bwd") == (
        64, 64, smem)
    assert smem <= 232448
    g = torch.Generator("cuda").manual_seed(d)
    q, go = (_off_16_bytes(torch.randn((2, 3, 150, d), generator=g,
                                       device="cuda")) for _ in range(2))
    k, v = (_off_16_bytes(torch.randn((2, 1, 140, d), generator=g,
                                      device="cuda")) for _ in range(2))
    bias = (torch.randn(bias_shape, generator=g, device="cuda")
            if bias_shape else None)
    out, lse = attn.flash_attention_fwd(q, k, v, bias=bias, return_lse=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attn.flash_attention_bwd(q, k, v, bias, go, out, lse, d ** -0.5)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "flash_bwd" in e.key}
    want = {"flash_bwd_dkdv_tf32_kernel", "flash_bwd_dq_tf32_kernel"}
    if bias_shape is not None and len(bias_shape) < 4:  # a shared slice
        want.add("flash_bwd_dbias_tf32_kernel")
    if names:  # the profiler traced the card
        assert {n for w in want for n in names if w in n} == names, names
        assert all(any(w in n for n in names) for w in want), names


@pytest.mark.cuda
def test_f32_wide_forward_at_the_precompute_shape(cuda):
    # precompute's VAE encoder: 16 frames of 784 tokens at d 512, no grad
    g = torch.Generator("cuda").manual_seed(784)
    q, k, v = (torch.randn((16, 1, 784, 512), generator=g, device="cuda")
               for _ in range(3))
    _check(q, k, v, torch.float32)


# ragged head dims past 128 (a warp's 64 columns partly past D, the warps
# past it idle): the forward with lse and the unbiased backward, and the
# backward with multi-query k/v (per-head dk/dv summed by the wrapper)
@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 256, 384])
def test_f32_wide_train_kernels_at_ragged_head_dims(cuda, d):
    _check_train(2, 2, 150, 190, d, 2, None, torch.float32, seed=d)


@pytest.mark.cuda
def test_f32_wide_backward_multi_query(cuda):
    _check_train(2, 3, 130, 140, 256, 1, None, torch.float32, seed=5)


# the forward with lse past d 128 over multi-query k/v at d = 200, without
# a bias and with each bias mode (a biased backward past 128 keeps the
# first design; no path launches one)
@pytest.mark.cuda
@pytest.mark.parametrize("bias_shape", [None, (150, 140), (3, 150, 140),
                                        (2, 3, 150, 140)],
                         ids=["none", "shared", "per_head", "per_bh"])
def test_f32_wide_forward_multi_query_bias_modes_with_lse(cuda, bias_shape):
    g = torch.Generator("cuda").manual_seed(200)
    q = torch.randn((2, 3, 150, 200), generator=g, device="cuda")
    k, v = (torch.randn((2, 1, 140, 200), generator=g, device="cuda")
            for _ in range(2))
    bias = (torch.randn(bias_shape, generator=g, device="cuda")
            if bias_shape else None)
    _check_f32_lse(q, k, v, bias, 200 ** -0.5)


@pytest.mark.cuda
def test_f32_wide_backward_rerun_gives_equal_bits(cuda):
    # the autoencoder step's launch: two passes, no atomics
    g = torch.Generator("cuda").manual_seed(1024)
    q, k, v, go = (torch.randn((4, 1, 1024, 512), generator=g, device="cuda")
                   for _ in range(4))
    out, lse = attn.flash_attention_fwd(q, k, v, return_lse=True)
    first = attn.flash_attention_bwd(q, k, v, None, go, out, lse,
                                     512 ** -0.5)
    for _ in range(2):
        again = attn.flash_attention_bwd(q, k, v, None, go, out, lse,
                                         512 ** -0.5)
        assert all(torch.equal(a, b) for a, b in zip(first[:3], again[:3]))


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
@pytest.mark.parametrize("d", [52, 64, 130, 131])
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
@pytest.mark.parametrize("d", [64, 128, 256])
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


# --- parallel/: the pinned prefetch and a world-1 NCCL group ----------------

@pytest.mark.cuda
def test_prefetch_to_device_on_the_card(cuda, monkeypatch):
    """`prefetch_to_device` yields the tensors a plain copy gives, and the
    consuming stream waits on an event recorded after each batch's copy."""
    import numpy as np
    from neurons_tpu_torch.parallel import create_mesh, prefetch_to_device

    waits = []
    wait_event = torch.cuda.Stream.wait_event

    def recording(stream, event):
        waits.append((stream, event))
        return wait_event(stream, event)

    monkeypatch.setattr(torch.cuda.Stream, "wait_event", recording)
    mesh = create_mesh()
    rng = np.random.default_rng(0)
    batches = [{"a": rng.standard_normal((10, 6, 256, 1664), np.float32),
                "b": np.arange(10) + i} for i in range(4)]
    for i, got in enumerate(prefetch_to_device(iter(batches), mesh)):
        assert waits and waits[-1][0] == torch.cuda.current_stream()
        assert isinstance(waits[-1][1], torch.cuda.Event)
        total = got["a"].sum()  # a kernel on the consumer stream
        for k, v in batches[i].items():
            assert torch.equal(got[k].cpu(), torch.as_tensor(v)), (i, k)
        assert torch.equal(total.cpu(), torch.as_tensor(
            batches[i]["a"]).to("cuda").sum().cpu())
    assert len(waits) == len(batches)


@pytest.mark.cuda
def test_nccl_world_one_round_trip(cuda):
    """A one-process NCCL group: the collectives the training steps use
    return what a single process holds."""
    import socket

    import numpy as np
    from neurons_tpu_torch.parallel import distributed as D

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    D.join_group(f"127.0.0.1:{port}", 1, 0, "nccl")
    try:
        assert (D.world_size(), D.rank()) == (1, 0)
        t = torch.arange(6.0, device="cuda")
        assert torch.equal(D.all_reduce_(t.clone()), t)
        x = torch.randn(3, 4, device="cuda")
        assert torch.equal(D._all_gather_rows(x), x)
        assert torch.equal(D.broadcast_(x.clone()), x)
        p = torch.zeros(5, device="cuda", requires_grad=True)
        p.grad = torch.arange(5.0, device="cuda")
        D.all_reduce_grads_([p])
        assert torch.equal(p.grad, torch.arange(5.0, device="cuda"))
        assert D.broadcast_from_host0({"k": 1.5}) == {"k": 1.5}
        out = D.process_allgather({"v": np.ones(2)})
        assert out["v"].shape == (1, 2)
        D.barrier()
    finally:
        D.destroy()


# The TF32 wgmma forward (csrc/flash_attn_fwd_tf32_sm90.cu) at every f32
# shape the paths launch at d <= 128: (B, H, Tq, Tk, D, kv heads), the
# bias's shape, lse, the batch rows the errors are taken on (the kernel
# runs the whole shape). Validate's UNet2D (heads of 64 at 64^2 and 32^2
# latents, CFG and one clip), UNet3D and SparseCtrl (d 40 and 80, 16 or 32
# rows), stage 6 (ViT-B, VideoMAE, CLIP ViT-L), precompute's bigG (d 104),
# the seg panels and stage e (the DecoderVideo at 24 and 12 rows), the f32
# stage-2 step (the prior's biased multi-query lse forward, the decoder's
# lse forwards at 60 rows) and the tiny CLI chain (d 8): one consumer, two
# and three (`tf32_wgmma_consumers`)
TF32_WGMMA_SHAPES = [
    ((2, 10, 1024, 1024, 64, 10), None, False, 2),
    ((2, 10, 1024, 256, 64, 10), None, False, 2),
    ((2, 20, 256, 256, 64, 20), None, False, 2),
    ((1, 10, 1024, 1024, 64, 10), None, False, 1),
    ((1, 20, 256, 256, 64, 20), None, False, 1),
    ((32, 8, 1024, 1024, 40, 8), None, False, 2),
    ((32, 8, 256, 256, 80, 8), None, False, 4),
    ((16, 8, 1024, 1024, 40, 8), None, False, 2),
    ((16, 8, 256, 256, 80, 8), None, False, 4),
    ((1, 12, 197, 197, 64, 12), None, False, 1),
    ((1, 12, 588, 588, 64, 12), None, False, 1),
    ((6, 16, 257, 257, 64, 16), None, False, 6),
    ((1, 16, 257, 257, 104, 16), None, False, 1),
    ((16, 16, 257, 257, 104, 16), None, False, 4),
    ((24, 1, 256, 256, 128, 1), None, False, 24),
    ((24, 1, 1024, 1024, 64, 1), None, False, 8),
    ((24, 1, 4096, 4096, 32, 1), None, False, 1),
    ((12, 1, 256, 256, 128, 1), None, False, 12),
    ((12, 1, 4096, 4096, 32, 1), None, False, 1),
    ((10, 32, 513, 514, 52, 1), (32, 513, 514), True, 1),
    ((60, 1, 256, 256, 128, 1), None, True, 8),
    ((60, 1, 1024, 1024, 64, 1), None, True, 4),
    ((60, 1, 4096, 4096, 32, 1), None, True, 1),
    ((8, 1, 256, 256, 8, 1), None, False, 8),
    ((1, 1, 256, 256, 8, 1), None, False, 1),
]


def _check_tf32_wgmma(q, k, v, bias=None, lse=False, rows=None,
                      route=attn.TF32_WGMMA_ROUTE):
    """The f32 forward on `route` (one launch), rerun bitwise, its out (and
    lse) on the first `rows` batch rows within 1.5x the TF32 plain
    version's error against float64."""
    rows = q.shape[0] if rows is None else rows
    before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
    got = attn.flash_attention_fwd(q, k, v, bias=bias, return_lse=lse)
    torch.cuda.synchronize()
    assert _route_of_last_launch(before) == route
    again = attn.flash_attention_fwd(q, k, v, bias=bias, return_lse=lse)
    got, again = ((got, again) if lse else ((got,), (again,)))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qs, ks, vs = q[:rows], k[:rows], v[:rows]
    bs = bias
    if bias is not None and bias.dim() == 4:
        bs = bias[:rows]
    want = attn.attention_reference_lse(
        qs.double(), ks.double(), vs.double(),
        None if bs is None else bs.double(), q.shape[-1] ** -0.5)
    plain = attn.attention_reference_tf32(qs, ks, vs, bias=bs,
                                          return_lse=True)
    for name, x, px, w in zip(("out", "lse"), got, plain, want):
        x = x[:rows]
        assert bool(torch.isfinite(x).all()), name
        err = (x.double() - w).abs().max().item()
        plain_err = (px.double() - w).abs().max().item()
        print(f"tf32 wgmma {tuple(q.shape)} k {tuple(k.shape)} bias "
              f"{None if bias is None else tuple(bias.shape)} {name}: err "
              f"{err:.3e}, plain {plain_err:.3e}, ratio "
              f"{err / max(plain_err, 1e-30):.3f}")
        assert err <= 1.5 * plain_err, (name, err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bias_shape,lse,rows", TF32_WGMMA_SHAPES,
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else str(x))
def test_tf32_wgmma_at_every_launched_f32_shape(cuda, shape, bias_shape, lse,
                                                rows):
    b, h, tq, tk, d, hkv = shape
    g = torch.Generator("cuda").manual_seed(b * h + tq + d)
    q = torch.randn((b, h, tq, d), generator=g, device="cuda")
    k, v = (torch.randn((b, hkv, tk, d), generator=g, device="cuda")
            for _ in range(2))
    bias = (torch.randn(bias_shape, generator=g, device="cuda")
            if bias_shape else None)
    _check_tf32_wgmma(q, k, v, bias, lse, rows)


def _off_16_bytes(x):
    """x copied into rows of d + 1 floats (rows off 16 bytes)."""
    buf = torch.zeros(x.shape[:-1] + (x.shape[-1] + 1,), device=x.device)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


# every DN (d 8 .. 128 in steps of 4: both members of each DN, ragged Tq
# and Tk, a tail tile of one key), both consumer regimes (1 at 3 heads;
# 3 or 2 at 9 x 30 heads of 129 rows: 810 blocks of 64 rows), on the same
# inputs as the register kernel it replaced (through rows of d + 1
# floats): the error's norm within 1.5x the TF32 plain version's, the
# largest element's error within 1.5x the register kernel's. (The largest
# element's error is held to the plain version's at the launched shapes;
# here, at d 88 on one input, both kernels were 1.61x the plain version's:
# where their key tiles agree they round the same unnormalised
# probabilities, and their ratios agreed to 0.01 over 56 inputs at d
# 64-128.)
@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(8, 129, 4)))
def test_tf32_wgmma_at_every_head_dim(cuda, d):
    g = torch.Generator("cuda").manual_seed(d)
    for b, h, tq, tk in ((1, 3, 130, 193), (9, 30, 129, 65)):
        q = torch.randn((b, h, tq, d), generator=g, device="cuda")
        k, v = (torch.randn((b, h, tk, d), generator=g, device="cuda")
                for _ in range(2))
        lse = tq == 129
        before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
        got = attn.flash_attention_fwd(q, k, v, return_lse=lse)
        torch.cuda.synchronize()
        assert _route_of_last_launch(before) == attn.TF32_WGMMA_ROUTE
        before = dict(attn.FLASH_FWD_LAUNCHES.by_route)
        reg = attn.flash_attention_fwd(*map(_off_16_bytes, (q, k, v)),
                                       return_lse=lse)
        assert _route_of_last_launch(before) == "flash_fwd_tf32_kernel"
        got, reg = ((got, reg) if lse else ((got,), (reg,)))
        want = attn.attention_reference_lse(q[:1].double(), k[:1].double(),
                                            v[:1].double())
        plain = attn.attention_reference_tf32(q[:1], k[:1], v[:1],
                                              return_lse=True)
        for name, x, r, px, w in zip(("out", "lse"), got, reg, plain, want):
            e, er, ep = ((y[:1].double() - w) for y in (x, r, px))
            rms, rms_plain = e.norm().item(), ep.norm().item()
            err, reg_err = e.abs().max().item(), er.abs().max().item()
            print(f"tf32 wgmma d {d} {tuple(q.shape)} {name}: rms ratio "
                  f"{rms / rms_plain:.3f}; max err {err:.3e}, register "
                  f"{reg_err:.3e}, plain {ep.abs().max().item():.3e}")
            assert rms <= 1.5 * rms_plain, (name, rms, rms_plain)
            assert err <= 1.5 * reg_err, (name, err, reg_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 52, 104])
def test_tf32_wgmma_reads_split_views_in_place(cuda, d):
    # the models' split: [B, T, 3 H D] chunked and viewed as [B, H, T, D]
    # (token stride 3 H D, head stride D): the tensor maps read the view
    g = torch.Generator("cuda").manual_seed(d)
    b, t, h = 2, 300, 3
    x = torch.randn((b, t, 3 * h * d), generator=g, device="cuda")
    q, k, v = (y.reshape(b, t, h, d).transpose(1, 2) for y in x.chunk(3, -1))
    assert not q.is_contiguous() and q.stride(2) == 3 * h * d
    _check_tf32_wgmma(q, k, v)


# the register kernel, which the TF32 wgmma kernel left rows, strides or
# pointers off 16 bytes (and d 4): each of its 12 instances (head dims
# padded to 32, 64, 128; bias; lse) on rows of d + 1 floats
@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("d", [32, 52, 104])
def test_tf32_register_kernel_off_tma_alignment(cuda, d, biased, lse):
    g = torch.Generator("cuda").manual_seed(d + 2 * biased + lse)
    q, k, v = (torch.randn((2, 3, 150, d + 1), generator=g,
                           device="cuda")[..., :d] for _ in range(3))
    assert attn._granule(d, 4, (q.stride(2),), (q,)) == 4
    bias = (torch.randn((3, 150, 150), generator=g, device="cuda")
            if biased else None)
    _check_tf32_wgmma(q, k, v, bias, lse, route="flash_fwd_tf32_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 24, 32, 40, 52, 64, 72, 80, 104,
                               128])
def test_tf32_wgmma_plan_matches_the_python_tables(cuda, d):
    for cons in (1, attn.tf32_wgmma_many(d)):
        plan = attn.tf32_wgmma_plan(d, cons)
        assert plan == attn.tf32_wgmma_tiles(d, cons), (d, cons)
        assert plan[5] <= 232448
        # two blocks an SM where the tables say so (1 KB reserved each)
        assert plan[6] * (plan[5] + 1024) <= 233472
    for d in (4, 130, 42):
        assert attn.tf32_wgmma_plan(d, 1) is None
    assert attn.tf32_wgmma_plan(64, 2) is None
    assert attn.tf32_wgmma_plan(72, 3) is None


# The TF32 wgmma backward (csrc/flash_attn_bwd_tf32_sm90.cu): the library's
# plans equal the Python tables at every d (and, for the prior's head-bias
# pair, every Tk class up to 576)
@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(8, 129, 4)))
def test_tf32_wgmma_bwd_plan_matches_the_python_tables(cuda, d):
    plan = attn.tf32_wgmma_bwd_plan(d)
    assert plan == attn.tf32_wgmma_bwd_tiles(d)
    assert max(plan[3], plan[7]) <= 232448
    for tk in (1, 33, 514, 576):
        bias_plan = attn.tf32_bias_wgmma_bwd_plan(d, tk)
        if d <= 64:
            assert bias_plan == attn.tf32_bias_wgmma_bwd_tiles(d, tk)
            assert max(bias_plan[3], bias_plan[7]) <= 232448
        else:
            assert bias_plan is None
    assert attn.tf32_bias_wgmma_bwd_plan(52, 577) is None
    for other in (4, 130, 42):
        assert attn.tf32_wgmma_bwd_plan(other) is None


def _check_tf32_wgmma_bwd(q, k, v, bias, go, route):
    """The backward on `route` from the forward's out and lse: each
    gradient within 1.5x the TF32 plain version's error against float64
    autograd, f32 out, a rerun bitwise."""
    d = q.shape[-1]
    scale = d ** -0.5
    ins = [x.double().requires_grad_() for x in (q, k, v)]
    b64 = None if bias is None else bias.double().requires_grad_()
    o64 = attn.attention_reference(*ins, bias=b64, scale=scale)
    want = torch.autograd.grad(o64, ins + ([] if b64 is None else [b64]),
                               go.double())
    out, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                        return_lse=True)
    before = dict(attn.FLASH_BWD_LAUNCHES.by_route)
    got = attn.flash_attention_bwd(q, k, v, bias, go, out, lse, scale)
    torch.cuda.synchronize()
    (took,) = [r for (r, key), n in attn.FLASH_BWD_LAUNCHES.by_route.items()
               if n != before.get((r, key), 0)]
    assert took == route, took
    again = attn.flash_attention_bwd(q, k, v, bias, go, out, lse, scale)
    assert all(torch.equal(a, x) for a, x in zip(again, got) if a is not None)
    plain = attn.flash_attention_bwd_reference(q, k, v, bias, go, out, lse,
                                               scale, tf32=True)
    for name, x, w, px in zip(("dq", "dk", "dv", "dbias"), got, want, plain):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        err = (x.double() - w).abs().max().item()
        plain_err = (px.double() - w).abs().max().item()
        print(f"tf32 wgmma bwd {tuple(q.shape)} k {tuple(k.shape)} {name}: "
              f"err {err:.3e}, plain {plain_err:.3e}")
        assert err <= 1.5 * plain_err, (name, err, plain_err)


# every DN (d 8 .. 128 in steps of 4) unbiased over multi-query k/v and
# over one k/v a head (ragged Tq and Tk, a tail key tile), and the prior's
# head-bias layout at d <= 64 (a per-head bias over multi-query k/v, 5
# heads: cluster head groups of 2, 2, 1 and none; an odd count of 32-key
# tiles)
@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(8, 129, 4)))
def test_tf32_wgmma_bwd_at_every_head_dim(cuda, d):
    g = torch.Generator("cuda").manual_seed(d)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for hkv in (1, 3):
        _check_tf32_wgmma_bwd(rand(2, 3, 130, d), rand(2, hkv, 193, d),
                              rand(2, hkv, 193, d), None, rand(2, 3, 130, d),
                              attn.TF32_BWD_WGMMA_ROUTE)
    if d <= 64:
        _check_tf32_wgmma_bwd(rand(2, 5, 129, d), rand(2, 1, 98, d),
                              rand(2, 1, 98, d), rand(5, 129, 98),
                              rand(2, 5, 129, d),
                              attn.TF32_BWD_BIAS_WGMMA_ROUTE)


# the prior's layout at the most keys the dbias accumulator takes (576:
# 18 key tiles, the dQ pass's largest shared memory) and past a head
# group's worth of heads at the real 52
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 130, 576, 52), (3, 9, 513, 514, 52)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tf32_wgmma_bwd_prior_layout(cuda, shape):
    b, h, tq, tk, d = shape
    g = torch.Generator("cuda").manual_seed(tk)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    _check_tf32_wgmma_bwd(rand(b, h, tq, d), rand(b, 1, tk, d),
                          rand(b, 1, tk, d), rand(h, tq, tk),
                          rand(b, h, tq, d), attn.TF32_BWD_BIAS_WGMMA_ROUTE)
