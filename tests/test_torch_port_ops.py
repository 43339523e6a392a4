"""The port's ops against the JAX package's: attention (plain version vs
`xla_attention` and the Pallas kernel in interpret mode), temporal
attention (plain version vs the JAX reference and the Pallas kernel in
interpret mode), the dispatcher's routing, GroupNorm(+SiLU), the nearest
resize convention, the weight carrier, and the port's guards (no JAX
import, no silent CPU move).

Tolerance: max |port - JAX| <= 1e-4 * max |JAX| in f32 unless stated;
both sides run the same f32 arithmetic up to summation order. In bf16
(temporal attention against the Pallas kernel): one bf16 rounding step at
max |JAX|, as that test states."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurons_tpu.ops import attention as jattn
from neurons_tpu.ops import fused_norm as jnorm
from neurons_tpu.ops import temporal_attention as jtemporal
from neurons_tpu_torch.ops import attention as tattn
from neurons_tpu_torch.ops import temporal_attention as ttemporal
from neurons_tpu_torch.ops.fused_norm import (group_norm_reference,
                                              group_norm_silu_reference)
from torch_port_utils import rel_err, t

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4


def _qkv(seed, b, h, tq, tk, d, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = h if hkv is None else hkv
    q = rng.standard_normal((b, h, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    return q, k, v


# d in {32, 64, 512} (the stage-3 head dims), ragged Tk, multi-query,
# bias, mask
ATTN_CASES = {
    "d32": dict(b=2, h=1, tq=48, tk=48, d=32),
    "d64_ragged": dict(b=1, h=3, tq=40, tk=37, d=64),
    "d512": dict(b=1, h=1, tq=24, tk=29, d=512),
    "multi_query": dict(b=2, h=4, tq=17, tk=18, d=16, hkv=1),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_reference_matches_xla(case):
    c = ATTN_CASES[case]
    q, k, v = _qkv(0, **c)
    ref = jattn.xla_attention(q, k, v)
    assert rel_err(tattn.attention_reference(t(q), t(k), t(v)), ref) <= TOL


def test_attention_reference_bias_mask_scale_match_xla():
    q, k, v = _qkv(1, b=2, h=4, tq=21, tk=22, d=8, hkv=1)
    rng = np.random.default_rng(2)
    bias = rng.standard_normal((4, 21, 22), dtype=np.float32)
    mask = rng.random((1, 1, 21, 22)) > 0.3
    ref = jattn.xla_attention(q, k, v, bias=bias, mask=mask, scale=0.3)
    got = tattn.attention_reference(t(q), t(k), t(v), bias=t(bias),
                                    mask=torch.from_numpy(mask), scale=0.3)
    assert rel_err(got, ref) <= TOL


# the Pallas kernels #1/#2 the CUDA kernel replaces, run in interpret mode:
# whole-KV (Tk 200) and streaming (Tk 2600 f32 > 4608 B a row) regimes
PALLAS_CASES = {
    "smallkv_d32": dict(b=1, h=2, tq=130, tk=200, d=32),
    "smallkv_d64_mq": dict(b=1, h=2, tq=128, tk=150, d=64, hkv=1),
    "smallkv_d512": dict(b=1, h=1, tq=128, tk=140, d=512),
    "streaming_d64": dict(b=1, h=1, tq=128, tk=2600, d=64),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_attention_reference_matches_pallas_interpret(case):
    c = PALLAS_CASES[case]
    q, k, v = _qkv(3, **c)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True)
    # the port's wrapper on CPU tensors computes the plain version
    got = tattn.flash_attention_fwd(t(q), t(k), t(v))
    assert rel_err(got, ref) <= TOL


def test_attention_reference_matches_pallas_bias_interpret(monkeypatch):
    # force the biased kernel (#3), which inference keeps off by default
    monkeypatch.setenv("NEURONS_TPU_BIAS_FLASH", "1")
    q, k, v = _qkv(4, b=1, h=2, tq=130, tk=131, d=16, hkv=1)
    bias = np.random.default_rng(5).standard_normal((2, 130, 131),
                                                    dtype=np.float32)
    ref = jattn._flash_attention_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(bias),
                                      interpret=True, return_lse=True)[0]
    got = tattn.attention_reference(t(q), t(k), t(v), bias=t(bias))
    assert rel_err(got, ref) <= TOL


def test_dispatcher_routes_like_the_jax_package(monkeypatch):
    calls = []

    def spy(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return tattn.attention_reference(q, k, v, scale=scale)

    monkeypatch.setattr(tattn, "flash_attention_fwd", spy)
    big = [torch.randn(1, 2, 128, 8) for _ in range(3)]
    small = [torch.randn(1, 2, 127, 8) for _ in range(3)]
    tattn.dot_product_attention(*big)
    assert calls == [(1, 2, 128, 8)]
    tattn.dot_product_attention(*small)                       # < 128 tokens
    tattn.dot_product_attention(*big, mask=torch.ones(128, 128, dtype=bool))
    tattn.dot_product_attention(*big, bias=torch.zeros(2, 128, 128))
    assert len(calls) == 1


def test_flash_wrapper_on_cpu_is_plain_and_counts_nothing():
    q, k, v = _qkv(6, b=1, h=2, tq=130, tk=140, d=40, hkv=1)
    before = tattn.FLASH_FWD_LAUNCHES.total
    got = tattn.flash_attention_fwd(t(q), t(k), t(v), scale=0.2)
    want = tattn.attention_reference(t(q), t(k), t(v), scale=0.2)
    assert torch.equal(got, want)
    assert tattn.FLASH_FWD_LAUNCHES.total == before


def test_round_to_tf32_is_round_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2**-10, one + 2**-11, one + 2**-12,
                      one + 3 * 2**-11, -(one + 2**-11), 3.0 * 2**-100])
    want = torch.tensor([one, one + 2**-10, one + 2**-10, one,
                         one + 2**-9, -(one + 2**-10), 3.0 * 2**-100])
    assert torch.equal(tattn.round_to_tf32(x), want)


def test_attention_reference_tf32_is_plain_at_tf32_precision():
    # TF32 keeps 10 mantissa bits (relative rounding 2^-11): the emulated
    # plain version differs from the f32 one by that order, not more, and
    # is exact where the operands already are TF32 values
    q, k, v = (t(a) for a in _qkv(8, b=1, h=2, tq=70, tk=90, d=52, hkv=1))
    want = tattn.attention_reference(q, k, v)
    got = tattn.attention_reference_tf32(q, k, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert 2**-16 < rel_err(got, want.numpy()) < 2**-8
    r = tattn.round_to_tf32
    exact = tattn.attention_reference_tf32(r(q), r(k), r(v))
    assert torch.equal(exact, got)


# The f32 route's register kernel (csrc/flash_attn_fwd.cu,
# flash_fwd_tf32_kernel) multiplies with mma.m16n8k8 TF32. Its fragment
# maps, emulated lane by lane: lane (g, t) = (lane // 4, lane % 4) holds
# A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
# B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0, c1 (g, 2t,
# 2t + 1), c2, c3 (g + 8, 2t, 2t + 1).
def _mma_m16n8k8(a_regs, b_regs):
    """One mma.m16n8k8 from 32 lanes' registers, the products summed in
    float64: [16, 8]."""
    a, b = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(
        8, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_regs[lane]
        b[t, g], b[t + 4, g] = b_regs[lane]
    return a @ b


def _c_regs(s_tile):
    """The C registers of a [16, 8] tile, by lane."""
    return [(s_tile[g, 2 * t], s_tile[g, 2 * t + 1], s_tile[g + 8, 2 * t],
             s_tile[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def _pv_emulated(p, v, permuted):
    """O = P V over a key tile as the kernel computes it: k8 step j takes S's
    n8 tile j; with `permuted`, a = (c0, c2, c1, c3) and b = V rows 2t,
    2t + 1 (A's k index t is key 2t, t + 4 is key 2t + 1); without, the
    C registers taken as A as they stand, b = V rows t, t + 4."""
    nk, d = v.shape
    o = torch.zeros(16, d, dtype=torch.float64)
    for j in range(nk // 8):
        c = _c_regs(p[:, 8 * j:8 * j + 8])
        a = [(c0, c2, c1, c3) if permuted else (c0, c1, c2, c3)
             for c0, c1, c2, c3 in c]
        vj = v[8 * j:8 * j + 8]
        for n in range(d // 8):
            col = vj[:, 8 * n:8 * n + 8]
            b = [(col[2 * t, g], col[2 * t + 1, g]) if permuted
                 else (col[t, g], col[t + 4, g])
                 for g, t in (divmod(lane, 4) for lane in range(32))]
            o[:, 8 * n:8 * n + 8] += _mma_m16n8k8(a, b)
    return o


@pytest.mark.parametrize("d", [32, 52, 64, 128])
def test_tf32_pv_key_permutation_is_the_plain_product(d):
    # a key tile of 64 (32 at d = 128), V zero-padded to d's n8 tiles as
    # the kernel's shared memory holds it; P and V rounded to TF32
    rng = np.random.default_rng(d)
    nk, dp = (64 if d <= 64 else 32), -(-d // 8) * 8
    p = tattn.round_to_tf32(torch.from_numpy(
        np.exp(rng.standard_normal((16, nk), dtype=np.float32)))).double()
    v = torch.zeros(nk, dp, dtype=torch.float64)
    v[:, :d] = tattn.round_to_tf32(torch.from_numpy(
        rng.standard_normal((nk, d), dtype=np.float32))).double()
    want = p @ v
    got = _pv_emulated(p, v, permuted=True)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    # the C registers taken as A as they stand pair the wrong keys
    wrong = _pv_emulated(p, v, permuted=False)
    assert (wrong - want).abs().max() > 1e-3 * want.abs().max()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tf32_qk_fragments_are_the_plain_product(d):
    # S = Q K^T over a key tile: Q's A fragments read once; K's B fragments
    # by ldmatrix x4, lane 8 m + i giving row i of matrix m = (k8 step
    # 2 kp + m // 2, half m % 2) and each lane word (g, t) of every matrix
    rng = np.random.default_rng(100 + d)
    nk = 64 if d <= 64 else 32
    q, k = (tattn.round_to_tf32(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32))).double()
        for shape in ((16, d), (nk, d)))
    s = torch.zeros(16, nk, dtype=torch.float64)
    for j in range(nk // 8):
        for kp in range(d // 16):
            mats = [k[8 * j:8 * j + 8, 16 * kp + 8 * (m // 2) + 4 * (m % 2):
                      16 * kp + 8 * (m // 2) + 4 * (m % 2) + 4]
                    for m in range(4)]
            r = [[mats[m][g, t] for m in range(4)]
                 for g, t in (divmod(lane, 4) for lane in range(32))]
            for half in range(2):
                ks = 2 * kp + half
                a = [(q[g, 8 * ks + t], q[g + 8, 8 * ks + t],
                      q[g, 8 * ks + t + 4], q[g + 8, 8 * ks + t + 4])
                     for g, t in (divmod(lane, 4) for lane in range(32))]
                b = [(rl[2 * half], rl[2 * half + 1]) for rl in r]
                s[:, 8 * j:8 * j + 8] += _mma_m16n8k8(a, b)
    want = q @ k.T
    assert (s - want).abs().max() <= 1e-12 * want.abs().max()


# the f32 route's plain version with its lse against the JAX package's f32
# attention (the Pallas kernel in interpret mode) at the f32 paths' ragged
# rows, scaled down: ViT-B's 197 and CLIP's 257 tokens, the head dims 32,
# 64 and 128. TF32 keeps 10 mantissa bits: held to 2^-8 relative
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t_len", [197, 257])
def test_attention_reference_tf32_lse_matches_jax(t_len, d):
    q, k, v = _qkv(t_len + d, b=1, h=2, tq=t_len, tk=t_len, d=d)
    ref, ref_lse = jattn._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        return_lse=True)
    got, lse = tattn.attention_reference_tf32(t(q), t(k), t(v),
                                              return_lse=True)
    assert got.shape == ref.shape and lse.shape == ref_lse.shape
    assert rel_err(got, ref) <= 2**-8
    assert rel_err(lse, ref_lse) <= 2**-8


@pytest.mark.parametrize("shapes", [
    ((1, 2, 8, 4), (1, 3, 8, 4)),       # k heads neither 1 nor H
    ((1, 2, 8, 4), (1, 2, 8, 5)),       # head dims differ
    ((2, 8, 4), (2, 8, 4)),             # not rank 4
])
def test_flash_wrapper_rejects_bad_shapes(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(torch.zeros(qs), torch.zeros(ks),
                                  torch.zeros(ks))


# (B F, D, C, F, H): a ragged shape (F=4, H=2, hd=4) and the path's head
# dims (F=16, H=8; hd 40, 80, 160) at a few pixels
TEMPORAL_CASES = {
    "ragged_f4_h2": (8, 6, 8, 4, 2),
    "hd40": (32, 3, 320, 16, 8),
    "hd80": (16, 2, 640, 16, 8),
    "hd160": (16, 2, 1280, 16, 8),
}
TEMPORAL_TOL = 1e-5


def _temporal_qkv(seed, bf, d, c):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bf, d, c), dtype=np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("case", sorted(TEMPORAL_CASES))
def test_temporal_reference_matches_jax(case):
    bf, d, c, f, h = TEMPORAL_CASES[case]
    q, k, v = _temporal_qkv(10, bf, d, c)
    scale = (c // h) ** -0.5
    ref = jtemporal.temporal_attention_reference(q, k, v, f, h, scale)
    got = ttemporal.temporal_attention_reference(t(q), t(k), t(v), f, h,
                                                 scale)
    assert rel_err(got, ref) <= TEMPORAL_TOL


def test_temporal_reference_matches_pallas_interpret():
    # the Pallas kernel #6 at a shape it takes (F * H == 128), in
    # interpret mode, as tests/test_temporal_attention.py runs it
    bf, d, c, f, h = 32, 16, 64, 16, 8
    q, k, v = _temporal_qkv(11, bf, d, c)
    scale = (c // h) ** -0.5
    assert jtemporal._kernel_eligible(bf, d, c, f, h, jnp.float32)
    ref = jtemporal._temporal_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), f, h, scale, True)
    # the port's wrapper on CPU tensors computes the plain version
    got = ttemporal.temporal_attention(t(q), t(k), t(v), f, h, scale)
    assert rel_err(got, ref) <= TEMPORAL_TOL


def bf16_pair(a):
    """numpy f32 -> (JAX bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def bf16_ulp(x) -> float:
    """One bf16 rounding step at magnitude x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


# (B F, D, C, F, H): shapes the Pallas kernel takes (F * H == 128), hd 8
# and the UNet3D's 32x32 level's hd 40
TEMPORAL_BF16_CASES = {"hd8": (32, 16, 64, 16, 8), "hd40": (32, 8, 320, 16, 8)}


@pytest.mark.parametrize("case", sorted(TEMPORAL_BF16_CASES))
def test_temporal_reference_bf16_matches_pallas_interpret(case):
    # bf16 in both packages: the port's plain version against the Pallas
    # kernel #6 in interpret mode with compensated (exact) q*k products.
    # Both take f32 logits and softmax, round the weights to bf16 and sum
    # P V in f32; only the f32 summation order differs, which can move a
    # weight or an output to the other side of a bf16 rounding step.
    # Tolerance: one bf16 step at max |out| (2^(floor(log2 max) - 7));
    # measured: equal bits at both cases (other seeds of the hd8 shape
    # moved up to 3.9e-3 on 0.01% of the elements, step 1.6e-2).
    bf, d, c, f, h = TEMPORAL_BF16_CASES[case]
    scale = (c // h) ** -0.5
    (jq, tq), (jk, tk), (jv, tv) = map(bf16_pair, _temporal_qkv(16, bf, d,
                                                                c))
    assert jtemporal._kernel_eligible(bf, d, c, f, h, jnp.bfloat16)
    ref = np.asarray(jtemporal._temporal_attention_impl(
        jq, jk, jv, f, h, scale, True, compensate=True).astype(jnp.float32))
    got = ttemporal.temporal_attention_reference(tq, tk, tv, f, h, scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    top = np.abs(ref).max()
    assert np.abs(got - ref).max() <= bf16_ulp(top)
    # recorded, not held: the default (uncompensated) kernel rounds each
    # q*k product to bf16 (neurons_tpu/ops/temporal_attention.py:126-129);
    # its drift from the compensated form was 1.6e-2 (hd8) and 7.8e-3
    # (hd40) here, against the port's 0; shown with -s
    unc = np.asarray(jtemporal._temporal_attention_impl(
        jq, jk, jv, f, h, scale, True, compensate=False).astype(jnp.float32))
    print(f"temporal bf16 {case}: port - compensated "
          f"{np.abs(got - ref).max():.3e}, uncompensated - compensated "
          f"{np.abs(unc - ref).max():.3e}, bf16 step at max |out| "
          f"{bf16_ulp(top):.3e}")


def test_temporal_wrapper_on_cpu_is_plain_and_counts_nothing():
    q, k, v = (t(a) for a in _temporal_qkv(12, 12, 5, 12))
    before = ttemporal.TEMPORAL_ATTN_LAUNCHES.total
    got = ttemporal.temporal_attention(q, k, v, 3, 4, 0.3)
    want = ttemporal.temporal_attention_reference(q, k, v, 3, 4, 0.3)
    assert torch.equal(got, want)
    assert ttemporal.TEMPORAL_ATTN_LAUNCHES.total == before


# (B F, D, C, F, H): a shape the Pallas kernel takes (F * H == 128), whose
# JAX forward runs it in interpret mode, and the tiny config's 4 frames x
# 2 heads, which JAX computes with its reference
TEMPORAL_VJP_CASES = {"pallas": (32, 16, 64, 16, 8), "tiny": (8, 5, 12, 4, 2)}


@pytest.mark.parametrize("case", sorted(TEMPORAL_VJP_CASES))
def test_temporal_function_backward_matches_jax_vjp(case):
    # the port's autograd Function (kernel forward, backward through the
    # plain version) against jax.vjp of the JAX custom-VJP op; both
    # differentiate the same f32 reference, so they differ by summation
    # order only: TEMPORAL_TOL relative to max |JAX| per gradient
    bf, d, c, f, h = TEMPORAL_VJP_CASES[case]
    q, k, v, g = _temporal_qkv(13, bf, d, c) + _temporal_qkv(14, bf, d, c)[:1]
    scale = (c // h) ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c_: jtemporal.temporal_attention(
        a, b_, c_, f, h, scale, True), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    out = ttemporal.TemporalAttentionFn.apply(*ins, f, h, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, t(g))
    for name, a, w in zip("qkv", got, want):
        assert rel_err(a, w) <= TEMPORAL_TOL, name


def test_temporal_entry_point_records_grad_only_when_asked():
    q, k, v = (t(a) for a in _temporal_qkv(15, 8, 5, 12))
    assert ttemporal.temporal_attention(q, k, v, 4, 2, 0.3).grad_fn is None
    q.requires_grad_()
    out = ttemporal.temporal_attention(q, k, v, 4, 2, 0.3)
    assert type(out.grad_fn).__name__ == "TemporalAttentionFnBackward"
    with torch.no_grad():
        assert ttemporal.temporal_attention(q, k, v, 4, 2, 0.3).grad_fn is None


@pytest.mark.parametrize("shapes,f,h", [
    (((8, 4, 6), (8, 4, 6)), 3, 2),      # 8 rows are not whole 3-frame clips
    (((8, 4, 6), (8, 4, 6)), 4, 4),      # 6 channels do not split in 4 heads
    (((8, 4, 6), (8, 5, 6)), 4, 2),      # shapes differ
    (((8, 4), (8, 4)), 4, 2),            # not rank 3
])
def test_temporal_wrapper_rejects_bad_shapes(shapes, f, h):
    qs, ks = shapes
    with pytest.raises(ValueError):
        ttemporal.temporal_attention(torch.zeros(qs), torch.zeros(ks),
                                     torch.zeros(ks), f, h, 1.0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_jax(eps, silu):
    rng = np.random.default_rng(7)
    x = 3.0 + rng.standard_normal((2, 6, 5, 16), dtype=np.float32)  # NHWC
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    jfn = jnorm.group_norm_silu_reference if silu else jnorm.group_norm_reference
    tfn = group_norm_silu_reference if silu else group_norm_reference
    ref = np.asarray(jfn(x, scale, bias, 4, eps)).transpose(0, 3, 1, 2)
    got = tfn(t(x).permute(0, 3, 1, 2), t(scale), t(bias), 4, eps)
    assert rel_err(got, ref) <= TOL


def test_group_norm_over_tokens_matches_jax_module():
    # the AttnBlock form: [N, T, C] tokens, statistics over (T, C/G)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 8), dtype=np.float32)
    mod = jnorm.GroupNorm(num_groups=2, epsilon=1e-6)
    params = {"scale": rng.standard_normal(8, dtype=np.float32),
              "bias": rng.standard_normal(8, dtype=np.float32)}
    ref = mod.apply({"params": params}, x)
    got = group_norm_reference(t(x).transpose(1, 2), t(params["scale"]),
                               t(params["bias"]), 2, 1e-6).transpose(1, 2)
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("src,dst", [(16, 4), (16, 8), (8, 16), (6, 4)])
def test_nearest_exact_is_jax_nearest(src, dst):
    x = np.random.default_rng(9).standard_normal((1, 2, src, src),
                                                 dtype=np.float32)
    ref = jax.image.resize(x, (1, 2, dst, dst), "nearest")
    got = F.interpolate(t(x), size=(dst, dst), mode="nearest-exact")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_load_jax_params_is_strict():
    from neurons_tpu_torch.interop.from_jax import load_jax_params

    lin = torch.nn.Linear(3, 2)
    good = {"kernel": np.ones((3, 2), np.float32),
            "bias": np.zeros(2, np.float32)}
    load_jax_params(lin, good)
    assert torch.equal(lin.weight, torch.ones(2, 3))
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_params(lin, {"kernel": good["kernel"]})
    with pytest.raises(ValueError, match="unused"):
        load_jax_params(lin, dict(good, extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(lin, dict(good, kernel=np.ones((2, 3), np.float32)))


def _port_sources():
    return sorted((REPO / "neurons_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    banned = ("jax", "jaxlib", "flax", "optax", "neurons_tpu")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_port_import_loads_no_jax_module():
    code = ("import sys\n"
            "import neurons_tpu_torch.pipelines.keyframe\n"
            "import neurons_tpu_torch.pipelines.e2e\n"
            "import neurons_tpu_torch.models.neurons\n"
            "import neurons_tpu_torch.interop.from_jax\n"
            "import neurons_tpu_torch.utils.synth_init\n"
            "import neurons_tpu_torch.training.loop\n"
            "import neurons_tpu_torch.cli\n"
            "import neurons_tpu_torch.models.blip2\n"
            "import neurons_tpu_torch.evaluation.runner\n"
            "import neurons_tpu_torch.pipelines.io\n"
            "import neurons_tpu_torch.interop.torch_import\n"
            "import neurons_tpu_torch.interop.convert_ldm\n"
            "import neurons_tpu_torch.interop.torch_export as tex\n"
            "import neurons_tpu_torch.interop.load_weights as lw\n"
            "import neurons_tpu_torch.pipelines.decoupled_eval\n"
            "import neurons_tpu_torch.ops.resize\n"
            "import neurons_tpu_torch.data.cc2017\n"
            "import neurons_tpu_torch.data.categories\n"
            "import neurons_tpu_torch.data.clip_tokenizer\n"
            "import neurons_tpu_torch.data.precompute\n"
            "import neurons_tpu_torch.data.tasks\n"
            "import neurons_tpu_torch.pipelines.validate\n"
            "import neurons_tpu_torch.serving\n"
            "import neurons_tpu_torch.models.conditioner\n"
            "import neurons_tpu_torch.models.engine\n"
            "import neurons_tpu_torch.models.video_unet\n"
            "import neurons_tpu_torch.models.temporal_ae\n"
            "import neurons_tpu_torch.pipelines.api\n"
            "import neurons_tpu_torch.pipelines.svd\n"
            "import neurons_tpu_torch.models.t5\n"
            "import neurons_tpu_torch.models.vq\n"
            "import neurons_tpu_torch.training.perceptual\n"
            "import neurons_tpu_torch.training.train_autoencoder\n"
            "import neurons_tpu_torch.diffusion.loss\n"
            "import neurons_tpu_torch.diffusion.lr_schedule\n"
            "import neurons_tpu_torch.utils.ema\n"
            "import neurons_tpu_torch.data.download\n"
            "import os, tempfile, torch\n"
            "p = os.path.join(tempfile.mkdtemp(), 'x.safetensors')\n"
            "tex.write_safetensors(p, {'w': torch.ones(2, dtype=torch.bfloat16)})\n"
            "assert torch.equal(lw.read_safetensors(p)['w'], "
            "torch.ones(2, dtype=torch.bfloat16))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'neurons_tpu', 'transformers', "
            "'imageio', 'safetensors', 'huggingface_hub')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    from neurons_tpu_torch.config import tiny_pipeline_config
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.pipelines.keyframe import reconstruct_keyframes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_pipeline_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNetModel(cfg.unet2d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKL(cfg.vae)
    unet = UNetModel(cfg.unet2d, device="cpu")
    vae = AutoencoderKL(cfg.vae, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reconstruct_keyframes(unet, unet, vae, torch.zeros(1, 1, 8))
