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
