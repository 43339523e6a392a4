"""CPU emulation of the bf16 wgmma flash backward
(neurons_tpu_torch/csrc/flash_attn_bwd_sm90.cu), by index.

The kernel runs only on the card. These tests replay what it does: the
TMA boxes' swizzled shared-memory tiles (zero past Tq, Tk and D) and the
wgmma descriptors' reads of them (K-major for the S / dP products,
MN-major for g and Q in pass 1 and K in pass 2) at every head dim, the
hand-off of P^T, dS^T and dS from an accumulator's registers into the A
operand of the next product, each pass's tile walk with its masks and
rounding points (the probabilities by one FFMA and ex2, P and dS * scale
rounded to bf16, f32 sums tile by tile, dq rounded once), the plan's
shared memory, the mbarrier ring of pass 1 (whose full barrier takes the
producer warp's 32 arrivals: each lane writes its share of the tile's lse
and delta) and the route `flash_bwd_route` names. The emulated kernel is
held to the plain version (`flash_attention_bwd_reference`) as the card
tests hold the kernel: within 1.5x the bf16 plain version's error against
float64; and at two shapes to the JAX package's Pallas backward in
interpret mode, at the bf16 tolerance the plain version meets there.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.ops import attention as jattn
from neurons_tpu_torch.ops import attention as attn
from test_torch_port_wgmma_fwd import (MBarrier, a_layout, c_layout,
                                       read_k_major, read_mn_major, swizzle,
                                       tma_box)

HEAD_DIMS = [32, 64, 128]
LOG2E = np.float32(1.4426950408889634)
SMEM_LIMIT = 232448  # the 227 KB a block may use


def plan(d):
    rows1, rows2, bq, bk, bw, nb, stages = attn.wgmma_bwd_tiles(d)
    return dict(rows1=rows1, rows2=rows2, bq=bq, bk=bk, bw=bw, nb=nb,
                rb=2 * bw, stages=stages, split=rows1 < rows2)


def smem_bytes(d):
    """Each pass's shared memory as BwdCfg lays it out: the resident
    tiles, the ring, (pass 1) each stage's lse and delta, the barriers and
    the 1024-byte alignment slack."""
    p = plan(d)
    bars = 8 * (1 + 2 * p["stages"]) + 1024
    one = 2 * p["rows1"] * d * 2 + 2 * p["stages"] * p["bq"] * d * 2 \
        + p["stages"] * 2 * p["bq"] * 4
    two = 2 * p["rows2"] * d * 2 + 2 * p["stages"] * p["bk"] * d * 2
    return one + bars, two + bars


# ---------------------------------------------------------------------------
# the plan, the routes

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_fits_shared_memory_and_keeps_swizzle_alignment(d):
    p = plan(d)
    assert max(smem_bytes(d)) <= SMEM_LIMIT
    assert p["bw"] * p["nb"] == d and p["rb"] in (64, 128)
    # every tile, column block, warpgroup slice, ring stage and k16 step of
    # an MN-major read starts on its swizzle pattern's period
    for off in (p["rows1"] * d * 2, p["rows2"] * d * 2, p["bq"] * d * 2,
                p["bk"] * d * 2, p["rows1"] * p["rb"], p["rows2"] * p["rb"],
                p["bq"] * p["rb"], p["bk"] * p["rb"], 64 * p["rb"],
                16 * p["rb"]):
        assert off % (8 * p["rb"]) == 0
    # the S^T / S products are m64nNk16 with N = BQ or BK, the gradients'
    # m64nDk16: N a width the wgmma wrappers of csrc/sm90.cuh take
    assert p["bq"] in (64, 128) and p["bk"] in (64, 128)


# the stage-2 step's backward launches (chip_smoke.STEP_LAUNCHES): the
# DecoderVideo's unbiased sites and the prior's biased d 52 (the
# head-bias kernels)
STEP_BWD = [(60, 1, 256, 256, 128, False), (60, 1, 1024, 1024, 64, False),
            (60, 1, 4096, 4096, 32, False), (10, 32, 513, 514, 52, True)]


@pytest.mark.parametrize("shape", STEP_BWD, ids=lambda s: "x".join(
    map(str, s[:5])) + ("_bias" if s[5] else ""))
def test_routes_of_the_step_sites(shape):
    *_, tk, d, biased = shape
    # the prior's launch has the head-bias layout (attn.head_bias_layout):
    # the head-bias wgmma kernels of csrc/flash_attn_bwd_bias_sm90.cu
    route = attn.flash_bwd_route(d, torch.bfloat16, biased=biased,
                                 head_bias=biased, tk=tk)
    assert route == (attn.BWD_BIAS_WGMMA_ROUTE if biased
                     else attn.BWD_WGMMA_ROUTE)


def test_routes_off_the_wgmma_instances():
    reg = "flash_bwd_dkdv_reg_kernel+flash_bwd_dq_reg_kernel"
    bf16 = torch.bfloat16
    for d in (16, 40, 52, 80, 96, 112):  # no instance
        assert attn.flash_bwd_route(d, bf16) == reg
    for d in HEAD_DIMS:  # biased, off TMA's 16 bytes
        assert attn.flash_bwd_route(d, bf16, biased=True) == reg
        assert attn.flash_bwd_route(d, bf16, aligned=False) == reg
    # rows of 68 elements (136-byte token strides) move in 8-byte granules:
    # no TMA map, so the wrapper asks for the register kernels
    q = torch.zeros((2, 2, 150, 68), dtype=bf16)[..., :64]
    strides = (q.stride(0), q.stride(1), q.stride(2)) * 4
    assert attn._granule(64, 2, strides, (q,)) == 8
    assert not attn._tma_strides(strides, (2, 2, 150) * 4, 2)
    ok = torch.zeros((2, 2, 150, 64), dtype=bf16)
    strides = (ok.stride(0), ok.stride(1), ok.stride(2)) * 4
    assert attn._granule(64, 2, strides, (ok,)) == 16
    assert attn._tma_strides(strides, (2, 2, 150) * 4, 2)
    with pytest.raises(ValueError):
        attn.wgmma_bwd_tiles(96)


# ---------------------------------------------------------------------------
# registers: the C -> A hand-off of P^T, dS^T (pass 1) and dS (pass 2)

def pack_a(c):
    """The kernel's pack_a: c [128, N / 2] -> a [128, N / 16, 4, 2]
    (a[kk][j] packs c[8 kk + 2 j] and c[8 kk + 2 j + 1])."""
    return c.reshape(128, c.shape[1] // 8, 4, 2)


@pytest.mark.parametrize("n", [64, 128])
def test_c_to_a_hand_off_covers_each_element_once(n):
    # S^T's (or S's) accumulator over n columns, packed in pairs, read
    # through A's layout of the n / 16 k steps of the next product: every
    # element of the 64 x n tile lands once, at its own place
    rng = np.random.default_rng(n)
    s = rng.standard_normal((64, n)).astype(np.float32)
    row, col = c_layout(n)
    a = pack_a(s[row, col])
    ar, ak = a_layout()
    seen = np.zeros((64, n), int)
    got = np.zeros_like(s)
    for kk in range(n // 16):
        np.add.at(seen, (ar, 16 * kk + ak), 1)
        got[ar, 16 * kk + ak] = a[:, kk]
    assert (seen == 1).all()
    assert np.array_equal(got, s)


# ---------------------------------------------------------------------------
# shared memory: the boxes and the descriptors of both passes

def _src(n, d, sign):
    return sign * (np.arange(n)[:, None] * 1000.0 + np.arange(d)[None, :] + 1)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pass1_descriptors_read_the_intended_elements(d):
    # K (the block's keys) and a Q stage tile (BQ queries) written by TMA
    # boxes of BW columns; S^T = K Q^T reads K[64 keys of warpgroup cw (at
    # d 128 both warpgroups the block's 64), 16 ks ..] as A and Q[BQ, 16 ks
    # ..] as B, K-major; dK += dS^T Q reads Q[16 kk .., :D] MN-major (LBO
    # one column block of the tile)
    p = plan(d)
    bw, nb, rb, rows, bq = p["bw"], p["nb"], p["rb"], p["rows1"], p["bq"]
    k_src, q_src = _src(rows, d, 1.0), _src(bq, d, -1.0)
    q_base = rows * d * 2
    smem = np.full((q_base + bq * d * 2) // 2, np.nan)
    for j in range(nb):
        tma_box(smem, j * rows * rb, k_src, 0, j * bw, rows, bw, rb)
        tma_box(smem, q_base + j * bq * rb, q_src, 0, j * bw, bq, bw, rb)
    for ks in range(d // 16):
        blk, off = ks * 16 // bw, (ks * 16 % bw) * 2
        got_q = read_k_major(smem, q_base + blk * bq * rb + off, bq, 8 * rb,
                             rb)
        assert np.array_equal(got_q, q_src[:, 16 * ks:16 * ks + 16])
        for cw in range(2):
            r0 = 0 if p["split"] else 64 * cw
            got_k = read_k_major(smem, r0 * rb + blk * rows * rb + off, 64,
                                 8 * rb, rb)
            assert np.array_equal(
                got_k, k_src[r0:r0 + 64, 16 * ks:16 * ks + 16])
    for kk in range(bq // 16):
        got = read_mn_major(smem, q_base + kk * 16 * rb, d, bq * rb, 8 * rb,
                            rb)
        assert np.array_equal(got, q_src[16 * kk:16 * kk + 16])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pass2_descriptors_read_the_intended_elements(d):
    # Q (the block's 128 queries) and a K stage tile (BK keys): S = Q K^T
    # reads both K-major; dQ += dS K reads K[16 kk .., :D] MN-major
    p = plan(d)
    bw, nb, rb, rows, bk = p["bw"], p["nb"], p["rb"], p["rows2"], p["bk"]
    q_src, k_src = _src(rows, d, 1.0), _src(bk, d, -1.0)
    k_base = rows * d * 2
    smem = np.full((k_base + bk * d * 2) // 2, np.nan)
    for j in range(nb):
        tma_box(smem, j * rows * rb, q_src, 0, j * bw, rows, bw, rb)
        tma_box(smem, k_base + j * bk * rb, k_src, 0, j * bw, bk, bw, rb)
    for ks in range(d // 16):
        blk, off = ks * 16 // bw, (ks * 16 % bw) * 2
        got_k = read_k_major(smem, k_base + blk * bk * rb + off, bk, 8 * rb,
                             rb)
        assert np.array_equal(got_k, k_src[:, 16 * ks:16 * ks + 16])
        for cw in range(2):
            got_q = read_k_major(smem, cw * 64 * rb + blk * rows * rb + off,
                                 64, 8 * rb, rb)
            assert np.array_equal(
                got_q, q_src[64 * cw:64 * cw + 64, 16 * ks:16 * ks + 16])
    for kk in range(bk // 16):
        got = read_mn_major(smem, k_base + kk * 16 * rb, d, bk * rb, 8 * rb,
                            rb)
        assert np.array_equal(got, k_src[16 * kk:16 * kk + 16])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_swizzled_box_is_a_bijection_on_its_tile(d):
    p = plan(d)
    for rows in (p["rows1"], p["rows2"], p["bq"], p["bk"]):
        addr = swizzle(np.arange(rows)[:, None] * p["rb"]
                       + 2 * np.arange(p["bw"])[None, :], p["rb"])
        assert sorted(addr.ravel().tolist()) == list(
            range(0, rows * p["rb"], 2))


def test_ragged_box_reads_zeros_past_the_tokens():
    # the last ring tile of 513 queries at BQ 64 holds one row; the rest
    # of the box is TMA's zero fill, so its Q and g rows add nothing
    p = plan(64)
    src = _src(513, 64, 1.0)
    smem = np.full(p["bq"] * 64, np.nan)
    tma_box(smem, 0, src, 512, 0, p["bq"], p["bw"], p["rb"])
    got = np.concatenate([read_k_major(smem, ks * 32, p["bq"], 8 * p["rb"],
                                       p["rb"]) for ks in range(4)], axis=1)
    assert np.array_equal(got[0], src[512])
    assert (got[1:] == 0).all()


# ---------------------------------------------------------------------------
# the kernel's arithmetic, tile by tile

def _f32(x):
    return x.to(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(a, b):
    """One group of products of a tile: bf16-valued operands, the sum in
    f64, rounded to f32 (the accumulator's type)."""
    return _f32(a.double() @ b.double())


def _ex2_of_ffma(s, c, l2):
    """p = ex2.approx(fma(s, c, -l2)): the FFMA rounded once to f32."""
    x = _f32(s.double() * float(c) - l2.double())
    return _f32(torch.exp2(x.double()))


def _pad(x, n):
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def emulate_head(q, k, v, g, lse, delta, scale, mask=True):
    """One (b, h) of the kernels: q, g [Tq, D], k, v [Tk, D] bf16-valued f32
    tensors, lse, delta [Tq] f32. Returns dq (bf16-valued), dk, dv (f32), by
    the kernels' tile walks: pass 1 over ring tiles of BQ queries (keys in
    blocks, zero past Tk; lse * log2(e) +inf and delta 0 past Tq),
    pass 2 over ring tiles of BK keys (the last tile's keys past Tk masked
    unless `mask` is False)."""
    tq, d = q.shape
    tk = k.shape[0]
    p = plan(d)
    rows1, rows2, bq, bk = p["rows1"], p["rows2"], p["bq"], p["bk"]
    c = np.float32(scale) * LOG2E  # the host's scale * kLog2e, in f32
    sc = torch.tensor(scale, dtype=torch.float32)
    l2 = _f32(lse * torch.tensor(LOG2E))
    # pass 1: S^T, dP^T over each query tile; dK, dV summed tile by tile
    nk = -(-tk // rows1)
    kp, vp = _pad(k, nk * rows1), _pad(v, nk * rows1)
    dk = torch.zeros((nk * rows1, d))
    dv = torch.zeros((nk * rows1, d))
    for t in range(-(-tq // bq)):
        sl = slice(t * bq, (t + 1) * bq)
        qt, gt = _pad(q[sl], bq), _pad(g[sl], bq)
        lt = torch.cat([l2[sl], torch.full((bq - l2[sl].numel(),),
                                           float("inf"))])
        dlt = _pad(delta[sl], bq)
        st, dpt = _mm(kp, qt.T), _mm(vp, gt.T)
        pt = _ex2_of_ffma(st, c, lt[None, :])
        dst = _f32(_f32(pt * _f32(dpt - dlt[None, :])) * sc)
        dv = _f32(dv + _mm(_bf16(pt), gt))
        dk = _f32(dk + _mm(_bf16(dst), qt))
    # pass 2: S, dP over each key tile; dQ summed tile by tile
    nq = -(-tq // rows2)
    qp, gp = _pad(q, nq * rows2), _pad(g, nq * rows2)
    lr = torch.cat([l2, torch.full((nq * rows2 - tq,), float("inf"))])
    dr = _pad(delta, nq * rows2)
    dq = torch.zeros((nq * rows2, d))
    for t in range(-(-tk // bk)):
        sl = slice(t * bk, (t + 1) * bk)
        kt, vt = _pad(k[sl], bk), _pad(v[sl], bk)
        s, dp = _mm(qp, kt.T), _mm(gp, vt.T)
        pv = _ex2_of_ffma(s, c, lr[:, None])
        if mask:
            pv = torch.where(torch.arange(t * bk, (t + 1) * bk)[None, :] < tk,
                             pv, torch.zeros(()))
        ds = _f32(_f32(pv * _f32(dp - dr[:, None])) * sc)
        dq = _f32(dq + _mm(_bf16(ds), kt))
    return _bf16(dq[:tq]), dk[:tk], dv[:tk]


def kernel_delta(g, out):
    """delta = sum_d g * out [..., Tq] in f32 as the dQ pass takes it: the
    four lanes of a quad each sum their D / 4 columns in order (each bf16
    product is exact in f32), then the quad adds (0 + 1) + (2 + 3)."""
    d = g.shape[-1]
    parts = (g.float() * out.float()).reshape(*g.shape[:-1], 4, d // 4)
    acc = torch.zeros(parts.shape[:-1])
    for j in range(d // 4):
        acc = acc + parts[..., j]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def emulate(q, k, v, g, out, lse, scale, mask=True):
    """`flash_attention_bwd` on the wgmma route, emulated: q, g [B, H, Tq,
    D], k, v [B, Hkv, Tk, D] bf16 tensors, out bf16 and lse f32 from the
    forward. delta as the dQ pass takes it; dk, dv rounded to bf16 from
    f32, or for multi-query k/v summed over heads in f32 first."""
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    delta = kernel_delta(g, out)
    dq = torch.zeros(q.shape)
    dk = torch.zeros((b, h) + k.shape[2:])
    dv = torch.zeros((b, h) + k.shape[2:])
    for i in range(b):
        for j in range(h):
            jk = 0 if hkv == 1 else j
            dq[i, j], dk[i, j], dv[i, j] = emulate_head(
                q[i, j].float(), k[i, jk].float(), v[i, jk].float(),
                g[i, j].float(), lse[i, j].float(), delta[i, j], scale, mask)
    if hkv != h:
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _case(seed, b, h, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    return rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d), \
        rand(b, h, tq, d)


def _errors(got, q, k, v, g, scale):
    """Each gradient's max error against float64, and the bf16 plain
    version's."""
    out64, lse64 = attn.attention_reference_lse(q.double(), k.double(),
                                                v.double(), scale=scale)
    want = attn.flash_attention_bwd_reference(
        q.double(), k.double(), v.double(), None, g.double(), out64, lse64,
        scale)
    out, lse = attn.attention_reference_lse(q, k, v, scale=scale)
    plain = attn.flash_attention_bwd_reference(q, k, v, None, g, out, lse,
                                               scale)
    return {n: ((a.double() - w).abs().max().item(),
                (pl.double() - w).abs().max().item())
            for n, a, pl, w in zip(("dq", "dk", "dv"), got, plain, want)}


# (B, H, kv heads, Tq, Tk, D): the prior's ragged 513 x 514 rows at each
# head dim (multi-query at d 64), Tq != Tk both ways, a single key tile,
# and a tile of one query
EMU_CASES = [(1, 1, 1, 513, 514, 32), (1, 2, 1, 513, 514, 64),
             (1, 1, 1, 513, 514, 128), (2, 2, 2, 200, 300, 32),
             (1, 3, 3, 300, 130, 64), (1, 2, 1, 129, 70, 128),
             (1, 1, 1, 65, 257, 64)]


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_kernel_matches_the_plain_version(case):
    b, h, hkv, tq, tk, d = case
    q, k, v, g = _case(sum(case), b, h, hkv, tq, tk, d)
    scale = d ** -0.5
    out, lse = attn.attention_reference_lse(q, k, v, scale=scale)
    got = emulate(q, k, v, g, out, lse, scale)
    for name, (err, plain_err) in _errors(got, q, k, v, g, scale).items():
        assert bool(torch.isfinite(got[0].float()).all())
        assert err <= 1.5 * plain_err, (name, err, plain_err)


def test_last_key_tile_needs_its_mask():
    # TMA fills keys past Tk with zeros: a zero logit, so p = exp(-lse),
    # which overflows where a row's logits all sit far below zero (here
    # about -210: lse < -88). Unmasked, that p times a zero K row poisons
    # the row's dq; masked, the kernel matches the plain version
    b, h, tq, tk, d = 1, 1, 70, 200, 32
    q, k, v, g = _case(5, b, h, h, tq, tk, d)
    k[..., 0] = 4.0
    q[0, 0, 3] = 0.0
    q[0, 0, 3, 0] = -300.0
    scale = d ** -0.5
    out, lse = attn.attention_reference_lse(q, k, v, scale=scale)
    assert lse[0, 0, 3] < -88.0
    dq, _, _ = emulate(q, k, v, g, out, lse, scale, mask=False)
    assert not bool(torch.isfinite(dq[0, 0, 3].float()).all())
    got = emulate(q, k, v, g, out, lse, scale)
    for name, (err, plain_err) in _errors(got, q, k, v, g, scale).items():
        assert err <= 1.5 * plain_err, (name, err, plain_err)


# The emulated kernel against the JAX package's Pallas backward in
# interpret mode (bf16 on both sides): they round g, p and ds * scale to
# bf16 at the same places and differ in f32 summation order and in the
# exponential (ex2 of one FFMA against exp), which can move an output by
# one bf16 rounding step: 2^-8 relative to max |JAX|, the tolerance
# `test_plain_backward_bf16_matches_pallas_interpret` holds the plain
# version to
@pytest.mark.parametrize("case", [(1, 1, 1, 160, 200, 32),
                                  (1, 2, 2, 130, 150, 64)],
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_kernel_matches_pallas_interpret(case):
    b, h, hkv, tq, tk, d = case
    q, k, v, g = _case(7 + d, b, h, hkv, tq, tk, d)
    scale = d ** -0.5
    out, lse = attn.attention_reference_lse(q, k, v, scale=scale)
    got = emulate(q, k, v, g, out, lse, scale)

    def j(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    want = jattn._flash_bwd_pallas(j(q), j(k), j(v), j(g), j(out),
                                   jnp.asarray(lse.numpy()), scale, True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        rel = np.abs(a.float().numpy() - w).max() / np.abs(w).max()
        assert rel <= 2.0 ** -8, (name, rel)


# ---------------------------------------------------------------------------
# the mbarrier ring of pass 1

def ring_walk(ntiles, stages, cons, lanes, seed):
    """Random interleavings of the producer warp's `lanes` lanes (each:
    wait for stage t % stages to be empty, write its share of tile t's lse
    and delta, arrive on the stage's full barrier; lane 0 with the
    transaction bytes of the Q and g boxes, whose copies land at random
    later steps) and `cons` consumers (wait for the full barrier, read the
    boxes and every lane's stats, release the stage after the products).
    Asserts that no consumer reads a tile before all of it landed and that
    no write hits a stage a consumer still reads; returns the steps taken
    (every party finishes)."""
    rnd = random.Random(seed)
    full = [MBarrier(lanes) for _ in range(stages)]
    empty = [MBarrier(cons) for _ in range(stages)]
    boxes = [None] * stages              # the tile whose Q and g a stage holds
    stats = [[None] * lanes for _ in range(stages)]
    reading = [set() for _ in range(stages)]
    in_flight = []  # (stage, tile)

    def lane(i):
        for t in range(ntiles):
            s, parity = t % stages, ((t // stages) & 1) ^ 1
            while not empty[s].try_wait(parity):
                yield
            assert not reading[s], "a lane overwrote a stage in use"
            stats[s][i] = t
            yield
            if i == 0:
                full[s].arrive(expect_tx=1)
                in_flight.append((s, t))
            else:
                full[s].arrive()
            yield

    def consumer(cw):
        for t in range(ntiles):
            s, parity = t % stages, (t // stages) & 1
            while not full[s].try_wait(parity):
                yield
            assert boxes[s] == t and stats[s] == [t] * lanes, \
                "a product read a tile before it landed"
            reading[s].add(cw)
            yield  # the products and the exponentials
            reading[s].discard(cw)
            empty[s].arrive()
            yield

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                s, t = in_flight.pop(rnd.randrange(len(in_flight)))
                assert not reading[s]
                boxes[s] = t
                full[s].complete_tx(1)
            yield

    parties = [lane(i) for i in range(lanes)] + [consumer(c)
                                                 for c in range(cons)]
    copies = tma()
    steps = 0
    while parties:
        steps += 1
        assert steps < 200000, "the ring deadlocked"
        next(copies)
        party = rnd.choice(parties)
        try:
            next(party)
        except StopIteration:
            parties.remove(party)
    return steps


@pytest.mark.parametrize("ntiles", [1, 2, 3, 9])
def test_mbarrier_ring_walk(ntiles):
    p = plan(64)
    for seed in range(10):
        assert ring_walk(ntiles, p["stages"], 2, 4, seed) > 0

