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
version's at that dtype."""

import pytest
import torch

from neurons_tpu_torch.ops import attention as attn
from neurons_tpu_torch.ops import temporal_attention as ta


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = False


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
def _check_train(b, h, tq, tk, d, hkv, bias_shape, dtype, seed=3):
    g = torch.Generator("cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
    bias = rand(*bias_shape) if bias_shape else None
    go = rand(b, h, tq, d)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])))
def test_train_kernels_match_plain(cuda, dtype, shape):
    _check_train(*shape, getattr(torch, dtype))


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
