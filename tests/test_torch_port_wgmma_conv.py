"""CPU emulation of the bf16 wgmma GroupNorm+SiLU+3x3-conv kernel
(neurons_tpu_torch/csrc/gn_silu_conv_sm90.cu), by index.

The kernel runs only on the card. These tests replay in numpy what it does
with each index, from the launch plan `fused_conv.conv_plan_sm90` gives:
the TMA box of raw x over NCHW at each mode's tile (zeros outside the
image), the activation and its zero mask where the conv pads, the swizzled
activated tile (a bijection) and each tap's ldmatrix rows, which must read
the intended (pixel, channel) at every map width and for whole samples,
the A fragment of wgmma's register form and the m64nNk16 accumulator, the
weight ring's TMA-swizzled stages read MN-major through descriptors, the
epilogue's [channel][pixel] staging and NCHW stores, the split workspace's
reduction, the plan's shared memory and alignment at every shape of the
fused clip, and the producer / consumer walk over the two rings'
mbarriers. The emulated kernel is held to `gn_silu_conv_reference` as the
card tests hold the kernel: within 1.5x the bf16 plain version's error
against float64. No JAX here.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from neurons_tpu_torch.ops import fused_conv as fc
from test_torch_port_wgmma_fwd import (MBarrier, a_layout, bf16, c_layout,
                                       read_mn_major, swizzle)

CHUNK = fc.SM90_CHUNK
BM = fc.SM90_BM

# ((N, Cin, H, W, Cout), launches a fused clip) of #8, 32 groups: every
# shape of the fused clip (tools/torch_flash_ab.py: CONV_CLIP)
CONV_CLIP = [
    ((2, 320, 48, 48, 640), 38), ((2, 320, 96, 96, 4), 38),
    ((2, 320, 96, 96, 320), 266), ((2, 640, 24, 24, 1280), 38),
    ((2, 640, 48, 48, 640), 228), ((2, 640, 96, 96, 320), 76),
    ((2, 960, 48, 48, 640), 38), ((2, 960, 96, 96, 320), 38),
    ((2, 1280, 24, 24, 1280), 380), ((2, 1280, 48, 48, 640), 38),
    ((2, 1920, 24, 24, 1280), 38), ((2, 1920, 48, 48, 640), 38),
    ((2, 2560, 24, 24, 1280), 76), ((32, 320, 16, 16, 640), 50),
    ((32, 320, 32, 32, 320), 275), ((32, 640, 8, 8, 1280), 50),
    ((32, 640, 16, 16, 640), 225), ((32, 640, 32, 32, 320), 50),
    ((32, 960, 16, 16, 640), 25), ((32, 960, 32, 32, 320), 25),
    ((32, 1280, 4, 4, 1280), 475), ((32, 1280, 8, 8, 1280), 225),
    ((32, 1280, 16, 16, 640), 25), ((32, 1920, 8, 8, 1280), 25),
    ((32, 1920, 16, 16, 640), 25), ((32, 2560, 4, 4, 1280), 75),
    ((32, 2560, 8, 8, 1280), 50),
]


def bn_cfg(bn):
    """(BW, NB, row bytes) of an N tile (ConvCfg)."""
    bw = 64 if bn % 64 == 0 else 32 if bn % 32 == 0 else 16
    return bw, bn // bw, 2 * bw


def plan_of(shape, sms=132, bn=None):
    n, cin, h, w, cout = shape
    p = dict(fc._sm90_plan(n, cin, h, w, cout, sms, bn))
    p.update(n=n, cin=cin, h=h, w=w, cout=cout, hw=h * w,
             tps=-(-h * w // BM), nchunks=-(-cin // CHUNK),
             kc=-(-cin // CHUNK) * CHUNK)
    p["tiles"] = p["mtiles"] * p["ntiles"] * p["splits"]
    p["act_bytes"] = fc._round_up(p["samples"] * p["rb"] * (w + 2) * 64, 1024)
    p["raw_bytes"] = fc._round_up(p["samples"] * CHUNK * p["rr"] * p["wr"] * 2,
                                  1024)
    return p


def geo_of(p, t):
    """(sample n0, pixel p0, halo row y_lo, N tile, split) of tile t."""
    z, r = divmod(t, p["mtiles"] * p["ntiles"])
    m, nt = divmod(r, p["ntiles"])
    if p["mode"] == 0:
        n0, tt = divmod(m, p["tps"])
        p0 = tt * BM
        return n0, p0, p0 // p["w"] - 1, nt, z
    return m * p["samples"], 0, -1, nt, z


def slot_pixel(p, g, slot):
    """(sample, pixel, is an output pixel) of tile slot(s)."""
    n0, p0, _, _, _ = g
    slot = np.asarray(slot)
    if p["mode"] == 0:
        pix = p0 + slot
        return np.full_like(slot, n0), pix, pix < p["hw"]
    s, pix = np.divmod(slot, p["hw"])
    return n0 + s, pix, n0 + s < p["n"]


def slot_pos(p, g, slot):
    n, pix, ok = slot_pixel(p, g, slot)
    yy, xx = np.divmod(pix, p["w"])
    pos = ((n - g[0]) * p["rb"] + yy - g[2]) * (p["w"] + 2) + xx + 1
    return np.where(ok, pos, p["w"] + 3)


def halo_off(pos, c):
    return pos * 64 + ((c ^ ((pos >> 1) & 3)) << 4)


# ---------------------------------------------------------------------------
# the raw box and the activation

def raw_box(x, p, g, c):
    """The TMA box of chunk c for tile geometry g, as it lands in shared
    memory: [S][32][rr][wr] bf16 values, zero outside x (rows mode: W
    columns from row max(y_lo, 0); samples mode: whole samples)."""
    n, cin, h, w = x.shape
    s_ = np.arange(p["samples"])[:, None, None, None]
    ch = c * CHUNK + np.arange(CHUNK)[None, :, None, None]
    r = np.arange(p["rr"])[None, None, :, None]
    col = np.arange(p["wr"])[None, None, None, :]
    if p["mode"] == 0:
        nn, yy, xx = g[0] + 0 * s_, max(g[2], 0) + r, col
    else:
        nn, (yy, xx) = g[0] + s_, np.divmod(col + 0 * r, w)
    ok = (nn < n) & (ch < cin) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    vals = x[np.minimum(nn, n - 1), np.minimum(ch, cin - 1),
             np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
    return np.where(ok, vals, 0.0).astype(np.float32)


def silu_f32(v):
    """SiLU as the kernel takes it, h + h tanh(h) with h = v / 2 (f32; the
    card's tanh.approx is within about 2^-11 of this tanh)."""
    h = (np.float32(0.5) * np.asarray(v, np.float32)).astype(np.float32)
    return (h + h * np.tanh(h)).astype(np.float32)


def affine_silu(v, mean, scale, shift):
    """The kernel's activation of raw values v (bf16 values) of one channel:
    SiLU(fmaf(v, scale, fmaf(-mean, scale, shift))), bf16."""
    sc = np.float64(scale)
    b = np.float32(np.float64(shift) - np.float64(mean) * sc)
    return bf16(silu_f32((np.asarray(v, np.float64) * sc + b)
                         .astype(np.float32)))


def activate(raw, p, g, c, stats, act):
    """activate_item over every item of chunk c (the kernel's item order,
    (row or sample, 8-pixel group, channel pair) with the pair fastest, and
    its arithmetic): act is the activated tile as a float array indexed by
    byte offset / 2, written at halo_off (the pad columns are not written:
    the kernel zeroes them once). Returns the positions written."""
    mean, scale, shift = stats
    w, hw_w = p["w"], p["w"] + 2
    nj = w // 8 if p["mode"] == 0 else p["hw"] // 8
    outer = p["rb"] if p["mode"] == 0 else p["samples"]
    written = []
    for i in range(outer * nj * 16):
        cp, j, o = i & 15, (i >> 4) % nj, (i >> 4) // nj
        s_ = 0 if p["mode"] == 0 else o
        n = g[0] + s_
        if p["mode"] == 0:
            yy = g[2] + o
            row_in = 0 <= yy < p["h"]
            rrow = yy - max(g[2], 0) if row_in else 0
            xx, pos = 8 * j, o * hw_w + 8 * j + 1
        else:
            row_in, rrow = True, 0
            yy, xx = divmod(8 * j, w)
            pos = (s_ * p["rb"] + yy + 1) * hw_w + xx + 1
        vals = []
        for hh in range(2):
            cg = c * CHUNK + 2 * cp + hh
            ok = row_in and cg < p["cin"] and n < p["n"]
            v = raw[s_, 2 * cp + hh, rrow, 8 * j:8 * j + 8]
            vals.append(affine_silu(v, mean[n, cg], scale[n, cg],
                                    shift[n, cg]) if ok
                        else np.zeros(8, np.float32))
        for q in range(8):
            off = halo_off(pos, cp >> 2) + (cp & 3) * 4
            act[off // 2] = vals[0][q]
            act[off // 2 + 1] = vals[1][q]
            written.append(pos)
            pos += 1
            xx += 1
            if xx == w:
                xx, pos = 0, pos + 2
    return written


# ---------------------------------------------------------------------------
# reading the activated tile: ldmatrix, the A fragment

def ldmatrix_a(act, p, g, wg, warp, tap, ks):
    """One k16 step's A of warp `warp` of warpgroup wg as ldmatrix_x4 reads
    it: each lane gives the row address of its slot shifted by the tap, at
    chunk 2 ks + lane / 16. Returns (A [16 rows, 16 k], the registers
    [32 lanes, 4, 2])."""
    lane = np.arange(32)
    slot = 64 * wg + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8
    shift = (tap // 3 - 1) * (p["w"] + 2) + (tap % 3 - 1)
    addr = halo_off(slot_pos(p, g, slot) + shift, 2 * ks + (lane >> 4))
    rows = act[addr[:, None] // 2 + np.arange(8)[None, :]]  # [lane, 8]
    # matrix m (lanes 8 m ..) row r = lane % 8; m & 1: rows + 8, m >> 1: k + 8
    m, r = lane // 8, lane % 8
    a = np.zeros((16, 16), np.float32)
    a[(r + 8 * (m & 1))[:, None], (8 * (m >> 1))[:, None] + np.arange(8)] = rows
    # thread T's register j: matrix j's row T / 4 (given by lane 8 j + T / 4),
    # columns 2 (T % 4) and 2 (T % 4) + 1
    T = np.arange(32)[:, None, None]
    j = np.arange(4)[None, :, None]
    h = np.arange(2)[None, None, :]
    regs = rows[8 * j + T // 4, 2 * (T % 4) + h]
    return a, regs


def shifted_act(x_act, p, g, slots, tap):
    """The activated value the conv needs at each slot under the tap:
    [slots, 32 channels], zero outside the image."""
    n, pix, ok = slot_pixel(p, g, slots)
    yy, xx = np.divmod(pix, p["w"])
    yy, xx = yy + tap // 3 - 1, xx + tap % 3 - 1
    inside = ok & (yy >= 0) & (yy < p["h"]) & (xx >= 0) & (xx < p["w"])
    v = x_act[np.minimum(n, p["n"] - 1)[:, None], np.arange(CHUNK)[None, :],
              np.clip(yy, 0, p["h"] - 1)[:, None],
              np.clip(xx, 0, p["w"] - 1)[:, None]]
    return np.where(inside[:, None], v, 0.0), ok


# ---------------------------------------------------------------------------
# the weight ring

def pack_blocked(cw, p):
    """The conv weight [Cout, Cin, 3, 3] as the kernel reads it: column
    blocks of BW, [Np / BW, 9, Kc, BW] (bf16 values), zero in the pad."""
    cout, cin = cw.shape[:2]
    bw, _, _ = bn_cfg(p["bn"])
    packed = np.zeros((9, p["kc"], p["ntiles"] * p["bn"]), np.float32)
    packed[:, :cin, :cout] = bf16(cw.transpose(2, 3, 1, 0).reshape(9, cin,
                                                                   cout))
    return packed.reshape(9, p["kc"], -1, bw).transpose(2, 0, 1, 3)


def stage_of(blocked, p, nt, grp, c):
    """One ring stage (3 taps) as the producer's TMA box (BW columns x 32
    rows x 3 taps x the N tile's NB column blocks of the blocked weights)
    writes it, [NB][3][32][BW] swizzled by the row width: byte-addressed,
    as a float array indexed by offset / 2."""
    bw, nb, rb = bn_cfg(p["bn"])
    taps = fc.SM90_TAPS_PER_GROUP
    smem = np.full(taps * CHUNK * p["bn"], np.nan, np.float32)
    j = np.arange(nb)[:, None, None, None]
    tt = np.arange(taps)[None, :, None, None]
    r = np.arange(CHUNK)[None, None, :, None]
    col = np.arange(bw)[None, None, None, :]
    addr = swizzle(((j * taps + tt) * CHUNK + r) * rb + 2 * col, rb)
    smem[addr // 2] = blocked[nt * nb + j, grp * taps + tt, c * CHUNK + r, col]
    return smem


def read_b(stage, p, tt, ks):
    """The [16 x BN] B operand of tap tt (of the stage) and k16 step ks, as
    its MN-major descriptor reads it: LBO one column block (3 taps x 32
    rows), SBO 8 rows, the start 32 rows a tap and 16 rows a step on."""
    bw, nb, rb = bn_cfg(p["bn"])
    return read_mn_major(stage, (tt * CHUNK + ks * 16) * rb, p["bn"],
                         fc.SM90_TAPS_PER_GROUP * CHUNK * rb, 8 * rb, rb)


# ---------------------------------------------------------------------------
# the kernel, emulated

def gn_stats(x, gw, gb, groups, eps=1e-5):
    """Per-(n, c) mean, scale and shift in f32 (the statistics kernels'
    centred moments, taken here in float64)."""
    n, c = x.shape[:2]
    xg = x.astype(np.float64).reshape(n, groups, -1)
    mean = xg.mean(-1)
    rstd = 1.0 / np.sqrt(xg.var(-1) + eps)
    rep = c // groups
    mean = np.repeat(mean, rep, 1).astype(np.float32)
    scale = (np.repeat(rstd, rep, 1) * gw[None, :]).astype(np.float32)
    shift = np.broadcast_to(gb[None, :], (n, c)).astype(np.float32)
    return mean, scale, shift


def emulate(x, gw, gb, cw, cb, groups, sms=132, bn=None):
    """The kernel at x [N, Cin, H, W] (bf16 values in f32): per tile and
    chunk the raw box, the activation, 9 taps x 2 k16 steps of ldmatrix'd
    A times the stage's B; the epilogue through the staging tile, or the
    split workspace and its fixed-order reduction. Returns y (bf16
    values)."""
    n, cin, h, w = x.shape
    cout = cw.shape[0]
    p = plan_of((n, cin, h, w, cout), sms, bn)
    bn = p["bn"]
    stats = gn_stats(x, gw, gb, groups)
    blocked = pack_blocked(cw, p)
    hw = h * w
    y = np.full((n, cout, hw), np.nan, np.float32)
    ws = np.full((p["splits"], n, cout, hw), np.nan, np.float32)
    row, col = c_layout(bn)  # [128 threads, BN / 2]
    for t in range(p["tiles"]):
        g = geo_of(p, t)
        c0 = g[4] * p["cps"]
        acc = np.zeros((2, 64, bn), np.float64)
        for c in range(c0, min(p["nchunks"], c0 + p["cps"])):
            # zeroed once at the kernel's start (the pads stay so); a
            # chunk's activation rewrites every other position
            act = np.zeros(p["act_bytes"] // 2, np.float32)
            activate(raw_box(x, p, g, c), p, g, c, stats, act)
            for tap in range(9):
                stage = stage_of(blocked, p, g[3], tap // 3, c)
                for ks in range(2):
                    b = read_b(stage, p, tap % 3, ks).astype(np.float64)
                    for wg in range(2):
                        for warp in range(4):
                            a, _ = ldmatrix_a(act, p, g, wg, warp, tap, ks)
                            acc[wg, 16 * warp:16 * warp + 16] += a @ b
        acc = acc.astype(np.float32)
        for wg in range(2):
            regs = acc[wg][row, col]  # the accumulator registers
            for piece in range(bn // min(bn, 32)):
                e = min(bn, 32)
                stg = np.full((e, fc.SM90_EPI_LD), np.nan, np.float32)
                sel = (col >= piece * e) & (col < (piece + 1) * e)
                stg[col[sel] - piece * e, row[sel]] = regs[sel]
                vec = 4 if p["splits"] > 1 else 8
                for v in range(e * 64 // vec):
                    cl, r0 = divmod(v, 64 // vec)
                    r0 *= vec
                    nn, pix, ok = slot_pixel(p, g, 64 * wg + r0)
                    co = g[3] * bn + piece * e + cl
                    if not ok or co >= cout:
                        continue
                    vals = stg[cl, r0:r0 + vec]
                    if p["splits"] > 1:
                        ws[g[4], nn, co, pix:pix + vec] = vals
                    else:
                        y[nn, co, pix:pix + vec] = bf16(vals + cb[co])
    if p["splits"] > 1:
        acc = np.zeros((n, cout, hw), np.float32)
        for z in range(p["splits"]):
            acc = (acc + ws[z]).astype(np.float32)
        y = bf16(acc + cb[None, :, None])
    return y.reshape(n, cout, h, w), p


def _inputs(shape, seed, mean=0.0):
    n, cin, h, w, cout = shape
    rng = np.random.default_rng(seed)
    x = bf16(mean + rng.standard_normal((n, cin, h, w)))
    gw = bf16(1.0 + 0.2 * rng.standard_normal(cin))
    gb = bf16(0.2 * rng.standard_normal(cin))
    cw = bf16(rng.standard_normal((cout, cin, 3, 3)) / (9 * cin) ** 0.5)
    cb = bf16(0.1 * rng.standard_normal(cout))
    return x, gw, gb, cw, cb


def _errors(got, args, groups):
    t = [torch.from_numpy(a) for a in args]
    want = fc.gn_silu_conv_reference(*(a.double() for a in t), groups, 1e-5)
    plain = fc.gn_silu_conv_reference(*(a.bfloat16() for a in t), groups,
                                      1e-5)
    return ((torch.from_numpy(got).double() - want).abs().max().item(),
            (plain.double() - want).abs().max().item())


# (N, Cin, H, W, Cout, groups, sms, N tile or None): rows mode with two
# tiles a sample and a partial last tile (W 24), Cin off the chunk (40) and
# Cout off the N tile (170 on one N tile of 256, 260 on two of 160, the
# second partial), whole samples with a partial last tile (N = 3 of 8 a
# tile at 4x4, 2 at 8x8), the head's N tile of 16, and splits over Cin (a
# 4-SM card)
EMU_CASES = [(2, 32, 16, 16, 24, 8, 132, None),
             (1, 40, 8, 24, 170, 8, 132, 256),
             (3, 64, 4, 4, 16, 32, 132, None), (3, 32, 8, 8, 260, 8, 132, None),
             (1, 96, 16, 16, 4, 32, 4, None), (2, 64, 4, 4, 24, 16, 4, None)]


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])))
def test_emulated_kernel_matches_the_plain_version(case):
    *shape, groups, sms, bn = case
    args = _inputs(tuple(shape), sum(shape))
    got, p = emulate(*args, groups, sms, bn)
    err, plain_err = _errors(got, args, groups)
    assert np.isfinite(got).all()
    assert err <= 1.5 * plain_err, (err, plain_err, p)


def test_emulated_cases_cover_both_modes_splits_and_n_tiles():
    plans = [plan_of(tuple(c[:5]), c[6], c[7]) for c in EMU_CASES]
    assert {q["mode"] for q in plans} == {0, 1}
    assert {q["bn"] for q in plans} == set(fc.SM90_BNS)
    assert any(q["splits"] > 1 for q in plans)
    assert any(q["ntiles"] > 1 for q in plans)
    assert any(q["hw"] % BM for q in plans if q["mode"] == 0)


def test_large_mean_input_on_the_emulated_kernel():
    # the statistics are centred: a mean of 100 leaves the error where
    # the plain version's is
    args = _inputs((2, 32, 16, 16, 24), 11, mean=100.0)
    got, _ = emulate(*args, 8)
    err, plain_err = _errors(got, args, 8)
    assert err <= 1.5 * plain_err


def test_pad_taps_need_their_zero_mask():
    # TMA fills zeros outside the image, but SiLU(affine(0)) is not 0: an
    # activation that did not mask the pad would put SiLU(shift - mean *
    # scale) under every border tap
    shape = (1, 32, 16, 16, 16)
    x, gw, gb, cw, cb = _inputs(shape, 3)
    p = plan_of(shape)
    g = geo_of(p, 0)
    stats = gn_stats(x, gw, gb, 8)
    act = np.zeros(p["act_bytes"] // 2, np.float32)
    activate(raw_box(x, p, g, 0), p, g, 0, stats, act)
    hw_w = p["w"] + 2
    for pos in range(p["rb"] * hw_w):
        yy, xx = g[2] + pos // hw_w, pos % hw_w - 1
        vals = act[halo_off(pos, np.arange(4))[:, None] // 2
                   + np.arange(8)[None, :]]
        if not (0 <= yy < p["h"] and 0 <= xx < p["w"]):
            assert (vals == 0).all()
        else:
            want = affine_silu(x[0, :, yy, xx], *(st[0] for st in stats))
            assert np.array_equal(vals.ravel(), want)
    unmasked = silu_f32(-stats[0][0] * stats[1][0] + stats[2][0])
    assert np.abs(unmasked).max() > 1e-2


# ---------------------------------------------------------------------------
# addressing, by index

@pytest.mark.parametrize("shape", [c[0] for c in CONV_CLIP],
                         ids=lambda s: "x".join(map(str, s)))
def test_raw_box_covers_each_tiles_halo(shape):
    # every output pixel of every tile finds its 3x3 neighbourhood in the
    # box (rows mode: image rows y_lo .. y_lo + rr - 1, columns -1 .. W;
    # samples mode: the whole sample) and in the activated tile's rows
    p = plan_of(shape)
    hw_w = p["w"] + 2
    for m in range(min(p["mtiles"], 2 * p["tps"])):
        g = geo_of(p, m * p["ntiles"])
        slots = np.arange(BM)
        n, pix, ok = slot_pixel(p, g, slots)
        yy, xx = np.divmod(pix[ok], p["w"])
        pos = slot_pos(p, g, slots)[ok]
        rows_used = (pos // hw_w) % p["rb"]
        assert rows_used.min() >= 1 and rows_used.max() <= p["rb"] - 2
        assert ((pos % hw_w) == xx + 1).all()
        if p["mode"] == 0:
            assert (yy - g[2] >= 1).all() and (yy - g[2] <= p["rr"] - 2).all()
            # the box: W columns, rows from max(y_lo, 0), inside the map
            assert p["wr"] == p["w"] and p["wr"] % 8 == 0
            assert p["rr"] <= p["h"]
        else:
            assert p["wr"] == p["hw"] and p["rr"] == 1
        assert pos.max() * 64 + 64 <= p["act_bytes"]


@pytest.mark.parametrize("shape", [(1, 40, 8, 24, 16), (3, 40, 4, 4, 16),
                                   (2, 32, 8, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_raw_box_is_x_with_zeros_outside(shape):
    x, *_ = _inputs(shape, 5)
    p = plan_of(shape)
    for t in range(p["mtiles"]):
        g = geo_of(p, t * p["ntiles"])
        for c in range(p["nchunks"]):
            raw = raw_box(x, p, g, c)
            assert raw.shape == (p["samples"], CHUNK, p["rr"], p["wr"])
            # a direct read of the zero-padded tensor
            xp = np.zeros((p["n"] + p["samples"], p["kc"], p["h"] + 2,
                           p["wr"] + p["w"] + 2), np.float32)
            xp[:p["n"], :p["cin"], 1:p["h"] + 1, 1:p["w"] + 1] = x
            if p["mode"] == 0:
                y0 = max(g[2], 0)
                want = xp[g[0], c * CHUNK:(c + 1) * CHUNK,
                          y0 + 1:y0 + 1 + p["rr"], 1:p["w"] + 1]
                rows_in = min(p["rr"], p["h"] - y0)
                assert np.array_equal(raw[0, :, :rows_in],
                                      want[:, :rows_in])
                assert not raw[0, :, rows_in:].any()
            else:
                want = xp[g[0]:g[0] + p["samples"],
                          c * CHUNK:(c + 1) * CHUNK, 1:p["h"] + 1,
                          1:p["w"] + 1].reshape(p["samples"], CHUNK, 1, -1)
                assert np.array_equal(raw, want)


@pytest.mark.parametrize("shape", [(2, 32, 16, 16, 24), (1, 40, 8, 24, 16),
                                   (3, 64, 4, 4, 16), (3, 32, 8, 8, 16),
                                   (2, 32, 96, 96, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_activated_tile_is_a_bijection_and_covered(shape):
    p = plan_of(shape)
    npos = p["samples"] * p["rb"] * (p["w"] + 2)
    pos = np.arange(npos)[:, None]
    off = halo_off(pos, np.arange(4)[None, :])
    assert len(np.unique(off)) == off.size and off.max() + 16 <= p["act_bytes"]
    assert (off % 16 == 0).all()
    # every position but the pad columns (and, for whole samples, the pad
    # rows) is written every chunk, once; the pads are the kernel's zeros
    x, gw, gb, *_ = _inputs(shape, 2)
    act = np.zeros(p["act_bytes"] // 2, np.float32)
    written = activate(raw_box(x, p, geo_of(p, 0), 0), p, geo_of(p, 0), 0,
                       gn_stats(x, gw, gb, 8), act)
    hw_w = p["w"] + 2
    col, row = pos[:, 0] % hw_w, pos[:, 0] // hw_w % p["rb"]
    interior = (col >= 1) & (col <= p["w"])
    if p["mode"] == 1:
        interior &= (row >= 1) & (row <= p["h"])
    assert len(written) == 16 * len(set(written))
    assert sorted(set(written)) == pos[interior, 0].tolist()
    # an ldmatrix's 8 rows of consecutive pixels hit 8 bank groups
    for start in range(0, 64):
        rows = halo_off(np.arange(start, start + 8), 1)
        assert len(set((rows % 128 // 16).tolist())) == 8


@pytest.mark.parametrize("shape", [(2, 32, 16, 16, 24), (1, 40, 8, 24, 16),
                                   (3, 64, 4, 4, 16), (3, 32, 8, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_each_taps_ldmatrix_rows_read_the_intended_pixel(shape):
    # every slot's A row at every tap is the activation at the shifted
    # pixel (zero where the conv pads), all 32 channels over the two k16
    # steps; at whole samples the taps never cross into the next sample
    x, gw, gb, *_ = _inputs(shape, 4)
    p = plan_of(shape)
    stats = gn_stats(x, gw, gb, 8)
    x_act = affine_silu(x, *(st[:, :, None, None] for st in stats))
    x_act = np.pad(x_act, ((0, 0), (0, p["kc"] - p["cin"]), (0, 0), (0, 0)))
    for t in range(min(p["mtiles"], 3)):
        g = geo_of(p, t * p["ntiles"])
        act = np.zeros(p["act_bytes"] // 2, np.float32)
        activate(raw_box(x, p, g, 0), p, g, 0, stats, act)
        for tap in range(9):
            for wg in range(2):
                for warp in range(4):
                    slots = 64 * wg + 16 * warp + np.arange(16)
                    want, ok = shifted_act(x_act, p, g, slots, tap)
                    got = np.concatenate([ldmatrix_a(act, p, g, wg, warp, tap,
                                                     ks)[0]
                                          for ks in range(2)], axis=1)
                    assert np.array_equal(got[ok], want[ok])


def test_ldmatrix_registers_are_the_rs_a_fragment():
    # thread T's four ldmatrix registers are wgmma's register A fragment of
    # its warp's 16 rows (a_layout): a0 (g, 2t..), a1 (g + 8, ..), a2 (g,
    # 2t + 8..), a3 (g + 8, 2t + 8..)
    shape = (2, 32, 16, 16, 24)
    x, gw, gb, *_ = _inputs(shape, 6)
    p = plan_of(shape)
    g = geo_of(p, 0)
    act = np.zeros(p["act_bytes"] // 2, np.float32)
    activate(raw_box(x, p, g, 0), p, g, 0, gn_stats(x, gw, gb, 8), act)
    ar, ak = a_layout()  # [128, 4, 2]
    for tap in (0, 4, 8):
        for warp in range(4):
            a, regs = ldmatrix_a(act, p, g, 0, warp, tap, 1)
            lanes = slice(32 * warp, 32 * warp + 32)
            assert np.array_equal(regs, a[ar[lanes] - 16 * warp, ak[lanes]])


@pytest.mark.parametrize("bn", fc.SM90_BNS)
def test_accumulator_layout_and_epilogue_staging(bn):
    # the m64nNk16 accumulator covers the warpgroup's 64 x BN tile once;
    # staged as [channel][pixel] in pieces of 32 channels, each piece's
    # 8-pixel vectors cover it once, on 16-byte boundaries
    row, col = c_layout(bn)
    seen = np.zeros((64, bn), int)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()
    e = min(bn, 32)
    for piece in range(bn // e):
        sel = (col >= piece * e) & (col < (piece + 1) * e)
        idx = (col[sel] - piece * e) * fc.SM90_EPI_LD + row[sel]
        assert len(np.unique(idx)) == e * 64
        # bank conflicts of the staging writes: one register index, the
        # warp's 32 lanes on 32 different banks
        for i in range(0, bn // 2, 7):
            for warp in range(4):
                lanes = np.arange(32 * warp, 32 * warp + 32)
                if piece * e <= col[lanes[0], i] < (piece + 1) * e:
                    banks = ((col[lanes, i] - piece * e) * fc.SM90_EPI_LD
                             + row[lanes, i]) % 32
                    assert len(set(banks.tolist())) == 32
    assert fc.SM90_EPI_LD * 4 % 16 == 0


@pytest.mark.parametrize("bn", fc.SM90_BNS)
def test_weight_stage_descriptors_read_the_packed_weights(bn):
    # a stage of 3 taps x 32 x BN, written by one TMA box of the blocked
    # weights [Np / BW, 9, Kc, BW] with the row width's swizzle, read
    # MN-major (LBO one column block, SBO 8 rows, + 32 rows a tap, + 16 a
    # k16 step) is packed[tap, 32 c + 16 ks .., the N tile's columns]
    rng = np.random.default_rng(bn)
    cout, cin = 2 * bn, 64
    p = dict(bn=bn, kc=cin, ntiles=2)
    cw = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
    blocked = pack_blocked(cw, p)
    dense = bf16(cw.transpose(2, 3, 1, 0).reshape(9, cin, cout))
    bw, nb, rb = bn_cfg(bn)
    assert rb in (32, 64, 128) and bw * nb == bn
    assert blocked.shape == (2 * nb, 9, cin, bw)
    for nt in range(2):
        for grp in range(3):
            for c in range(2):
                stage = stage_of(blocked, p, nt, grp, c)
                assert np.isfinite(stage).all()
                for tt in range(3):
                    for ks in range(2):
                        r0 = c * CHUNK + 16 * ks
                        assert np.array_equal(
                            read_b(stage, p, tt, ks),
                            dense[3 * grp + tt, r0:r0 + 16,
                                  nt * bn:(nt + 1) * bn])


@pytest.mark.parametrize("shape", [(2, 32, 16, 16, 24), (3, 64, 4, 4, 16),
                                   (1, 40, 8, 24, 170)],
                         ids=lambda s: "x".join(map(str, s)))
def test_epilogue_writes_each_output_once(shape):
    # every (sample, channel, pixel) of y comes from exactly one tile's
    # 8-pixel vector (4 in the split workspace), and no vector straddles a
    # sample or runs past HW
    p = plan_of(shape)
    n, cout, hw = p["n"], p["cout"], p["hw"]
    for vec in (8, 4):
        seen = np.zeros((n, cout, hw), int)
        for t in range(p["mtiles"] * p["ntiles"]):
            g = geo_of(p, t)
            for wg in range(2):
                for co_l in range(p["bn"]):
                    co = g[3] * p["bn"] + co_l
                    for r0 in range(0, 64, vec):
                        nn, pix, ok = slot_pixel(p, g, 64 * wg + r0 +
                                                 np.arange(vec))
                        if not ok[0] or co >= cout:
                            assert not ok.any() or co >= cout
                            continue
                        assert ok.all() and (nn == nn[0]).all()
                        assert pix[0] % vec == 0 and pix[-1] < hw
                        seen[nn[0], co, pix] += 1
        assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the plan

@pytest.mark.parametrize("shape", [c[0] for c in CONV_CLIP],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_fits_shared_memory_and_keeps_alignment(shape):
    p = plan_of(shape)
    assert fc.conv_route(*shape, torch.bfloat16) == fc.WGMMA_CONV_ROUTE
    assert p["smem"] == fc.sm90_smem_bytes(p["bn"], p["stages"],
                                           p["act_bytes"], p["raw_bytes"])
    assert p["smem"] <= fc.SM90_SMEM_LIMIT
    assert 2 <= p["stages"] <= fc.SM90_MAX_STAGES
    bw, nb, rb = bn_cfg(p["bn"])
    assert fc.sm90_column_block(p["bn"]) == bw
    stage = fc.SM90_TAPS_PER_GROUP * CHUNK * p["bn"] * 2
    # every stage, column block, tap and k16 step on its swizzle period;
    # the activated and raw tiles and the staging on 1024-byte boundaries
    for off in (stage, 3 * CHUNK * rb, CHUNK * rb, 16 * rb, p["act_bytes"],
                p["raw_bytes"]):
        assert off % (8 * rb) == 0
    assert p["act_bytes"] % 1024 == 0 and p["raw_bytes"] % 1024 == 0
    assert p["wr"] % 8 == 0 and p["wr"] <= 256 and p["rr"] <= 256
    assert p["ntiles"] * p["bn"] >= p["cout"] > (p["ntiles"] - 1) * p["bn"]
    # the split: chunks cover Cin once, every split has work, the grid is
    # persistent (at most one block an SM)
    assert (p["splits"] - 1) * p["cps"] < p["nchunks"] <= p["splits"] * p["cps"]
    assert p["blocks"] == min(p["tiles"], 132)
    # a whole sample or 128 consecutive pixels a tile
    if p["mode"] == 1:
        assert p["samples"] * p["hw"] == BM
    else:
        assert p["w"] % 8 == 0 and p["samples"] == 1


def test_routes():
    # f32 keeps the TF32 kernel, maps TMA cannot address (rows off 16
    # bytes, small maps that do not divide the tile) the staged-halo one,
    # and so does an x off its 16-byte boundary
    assert fc.conv_route(2, 64, 16, 16, 64, torch.float32) == \
        fc.TF32_CONV_ROUTE
    for shape in [(2, 64, 7, 9, 4), (2, 960, 6, 6, 320), (1, 64, 40, 36, 96),
                  (2, 64, 12, 12, 64), (1, 80, 20, 20, 64)]:
        assert fc.conv_plan_sm90(*shape) is None
        assert fc.conv_route(*shape, torch.bfloat16) == fc.HALO_CONV_ROUTE
    assert fc.conv_route(2, 64, 16, 16, 64, torch.bfloat16,
                         aligned=False) == fc.HALO_CONV_ROUTE
    # the N tile by the modelled grid: 16 for the head, 160 for Cout 320,
    # 256 where 160 would take a second wave (Cout 640 at 48x48: 108 tiles
    # against 144 on 132 SMs; Cout 1280 at 24x24), 160 where 256 leaves
    # SMs idle (Cout 1280 at 8x8, Cin 640: 80 tiles against 128)
    bn = {s: fc.conv_plan_sm90(*s)["bn"] for s, _ in CONV_CLIP}
    assert bn[(2, 320, 96, 96, 4)] == 16
    assert bn[(32, 320, 32, 32, 320)] == bn[(2, 320, 96, 96, 320)] == 160
    assert bn[(2, 640, 48, 48, 640)] == 256 and bn[(32, 640, 16, 16, 640)] == 160
    assert bn[(2, 1280, 24, 24, 1280)] == 256
    assert bn[(32, 640, 8, 8, 1280)] == 160


def test_fused_clip_launches_all_take_the_wgmma_route():
    assert sum(n for _, n in CONV_CLIP) == 2930
    for shape, _ in CONV_CLIP:
        assert fc.conv_route(*shape, torch.bfloat16) == fc.WGMMA_CONV_ROUTE


# ---------------------------------------------------------------------------
# the two rings

def ring_walk(steps, stages, seed):
    """Random interleavings of the producer (the raw halo of step k + 1,
    then the weights of step k, a stage a group of 3 taps, each after its
    empty barrier) and two consumer warpgroups (per step: the consumer
    barrier; per group: the stage's full barrier, the products, the next
    step's activation after its raw full barrier, the products waited for,
    the stage released; then the raw buffer released), with TMA copies
    landing at random later moments. Asserts no read before its data
    landed and no copy into a buffer a consumer still reads."""
    rnd = random.Random(seed)
    full_b = [MBarrier(1) for _ in range(stages)]
    empty_b = [MBarrier(2) for _ in range(stages)]
    full_r = [MBarrier(1) for _ in range(2)]
    empty_r = [MBarrier(2) for _ in range(2)]  # one arrival a warpgroup here
    data_b, data_r = [None] * stages, [None, None]
    reading_b = [set() for _ in range(stages)]
    reading_r = [set(), set()]
    at_barrier = [0]
    generation = [0]
    in_flight = []

    def producer():
        def raw(k):
            buf = k & 1
            while not empty_r[buf].try_wait(((k >> 1) & 1) ^ 1):
                yield
            assert not reading_r[buf]
            full_r[buf].arrive(expect_tx=1)
            in_flight.append(("r", buf, k))

        yield from raw(0)
        for k in range(steps):
            if k + 1 < steps:
                yield from raw(k + 1)
            for grp in range(3):
                b = k * 3 + grp
                s = b % stages
                while not empty_b[s].try_wait(((b // stages) & 1) ^ 1):
                    yield
                full_b[s].arrive(expect_tx=1)
                in_flight.append(("b", s, b))
                yield

    def consumer(wg):
        def activate_from(k):
            buf = k & 1
            while not full_r[buf].try_wait((k >> 1) & 1):
                yield
            assert data_r[buf] == k, "activated a halo before it landed"
            reading_r[buf].add(wg)
            yield

        yield from activate_from(0)
        reading_r[0].discard(wg)
        empty_r[0].arrive()
        for k in range(steps):
            gen = generation[0]
            at_barrier[0] += 1  # bar.sync of the 256 consumer threads
            if at_barrier[0] == 2:
                at_barrier[0] = 0
                generation[0] += 1
            while generation[0] == gen:
                yield
            for grp in range(3):
                b = k * 3 + grp
                s = b % stages
                while not full_b[s].try_wait((b // stages) & 1):
                    yield
                assert data_b[s] == b, "a product read early"
                reading_b[s].add(wg)
                if k + 1 < steps and grp == 0:
                    yield from activate_from(k + 1)
                yield  # the products run, and are waited for
                reading_b[s].discard(wg)
                empty_b[s].arrive()
            if k + 1 < steps:
                reading_r[(k + 1) & 1].discard(wg)
                empty_r[(k + 1) & 1].arrive()

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                kind, s, tag = in_flight.pop(rnd.randrange(len(in_flight)))
                if kind == "b":
                    assert not reading_b[s], "a copy overwrote a stage in use"
                    data_b[s] = tag
                    full_b[s].complete_tx(1)
                else:
                    assert not reading_r[s]
                    data_r[s] = tag
                    full_r[s].complete_tx(1)
            yield

    parties = [producer(), consumer(0), consumer(1)]
    copies = tma()
    n = 0
    while parties:
        n += 1
        assert n < 200000, "the rings deadlocked"
        next(copies)
        party = rnd.choice(parties)
        try:
            next(party)
        except StopIteration:
            parties.remove(party)
    return n


@pytest.mark.parametrize("stages", [2, 3, 6])
@pytest.mark.parametrize("steps", [1, 2, 5])
def test_mbarrier_rings_walk(steps, stages):
    for seed in range(10):
        assert ring_walk(steps, stages, seed) > 0
