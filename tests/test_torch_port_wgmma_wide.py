"""CPU emulation of the bf16 wide wgmma flash forward at 128 < d <= 512
(neurons_tpu_torch/csrc/flash_attn_fwd_wide_sm90.cu), by index.

The kernel runs only on the card. These tests replay in numpy what it does
with each index: the one TMA box a tile that writes every column block of
a K, V or Q tile into 128-byte swizzled shared memory (a 5-D map that
splits D into blocks of 64), the ldmatrix reads that put each warpgroup's
half of Q's depth into the A fragments of S, the K-major reads of K and
the MN-major reads of V's 256 columns, the tile walk (S over each half of
the depth, the two halves exchanged and summed, the online softmax with
the last tile's -inf mask, O's column halves += P V), the key parts and
their combine in part order, the copies thread 0 issues past each tile's
barrier, the host's choice of parts, and the routes. The emulated kernel
is held to the plain version (`attention_reference`) as the card tests
hold the kernel: within 1.5x the bf16 plain version's error against f32.
The plain version is held to the JAX package's Pallas kernel in interpret
mode at d 512.
"""

from __future__ import annotations

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.ops import attention as jattn
from neurons_tpu_torch.ops import attention as attn
from test_torch_port_wgmma_fwd import (MBarrier, a_layout, read_k_major,
                                       read_mn_major, swizzle, tma_box)
from torch_port_utils import rel_err

BW, RB = 64, 128          # a column block: 64 bf16, one 128-byte row
BQ, BK = attn.WIDE_BQ, attn.WIDE_BK
HALF = 256                # O's columns (and S's depth) a warpgroup


def bf16(x) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def tile_box(smem, base, src, r0, rows, nblk):
    """The kernel's one box of a tile: `rows` rows of `src` from r0, all of
    its column blocks, written as [nblk][rows][64] from `base` (TMA fills
    rows past src's end with zeros): what the column blocks' boxes of 64
    columns would write one after another."""
    for j in range(nblk):
        tma_box(smem, base + j * rows * RB, src, r0, j * BW, rows, BW, RB)


# ---------------------------------------------------------------------------
# shared memory: the plan, the box, the reads


def test_plan_fits_shared_memory_and_keeps_swizzle_alignment():
    q_bytes = BQ * 512 * 2
    tile = BK * 512 * 2
    exchange = 2 * 2 * (BK // 2) * 128 * 4  # two buffers, two warpgroups
    smem = (q_bytes + 2 * attn.WIDE_STAGES * tile + exchange
            + 8 * (1 + 4 * attn.WIDE_STAGES) + 1024)
    assert smem <= 232448  # the 227 KB a block may use
    # every tile, column block, warpgroup half and k16 step of V starts on
    # the swizzle's 1024-byte period
    for off in (q_bytes, tile, BQ * RB, BK * RB, 4 * BQ * RB, 4 * BK * RB,
                16 * RB):
        assert off % 1024 == 0


@pytest.mark.parametrize("rows", [BQ, BK])
def test_box_covers_every_element_of_its_tile_once(rows):
    # the 8 column blocks of one box: each element of the [rows x 512]
    # source lands at exactly one 2-byte slot of the tile, and every slot
    # of the tile is written
    src = (np.arange(rows)[:, None] * 512 + np.arange(512)[None, :] + 1.0)
    smem = np.full(rows * 512, np.nan)
    tile_box(smem, 0, src, 0, rows, 8)
    assert not np.isnan(smem).any()
    assert sorted(smem.tolist()) == sorted(src.ravel().tolist())
    for j in range(8):  # block j holds columns 64 j.. of every row
        r = np.arange(rows)[:, None]
        addr = swizzle(j * rows * RB + r * RB + 2 * np.arange(BW)[None, :],
                       RB)
        assert np.array_equal(smem[addr // 2], src[:, 64 * j:64 * j + 64])


def ldmatrix_q(smem, q_half, ks):
    """The A fragments one warpgroup's ldmatrix_x4 loads for k16 step ks of
    S (load_q): [128 threads, 4 registers, 2 halves]. Lane l addresses row
    16 w + l % 16, 16-byte chunk (ks * 16 % 64) / 8 + l / 16 of column
    block ks * 16 / 64, through the swizzle; register j of lane l holds
    row l / 4, elements 2 (l % 4) and + 1 of matrix j, whose rows the
    lanes 8 j .. 8 j + 7 address."""
    tid = np.arange(128)
    warp, lane = tid // 32, tid % 32
    blk, base_chunk = ks * 16 // BW, (ks * 16 % BW) // 8
    out = np.zeros((128, 4, 2))
    for j in range(4):
        src_lane = 8 * j + lane // 4
        row = warp * 16 + (src_lane & 15)
        chunk = base_chunk + (src_lane >> 4)
        addr = q_half + blk * BQ * RB + row * RB + ((chunk ^ (row & 7)) << 4)
        for hh in range(2):
            out[:, j, hh] = smem[(addr + 2 * (2 * (lane % 4) + hh)) // 2]
    return out


@pytest.mark.parametrize("cw", [0, 1])
def test_q_fragments_read_this_halfs_depth(cw):
    q = np.arange(BQ)[:, None] * 1000.0 + np.arange(512)[None, :] + 1
    smem = np.zeros(BQ * 512)
    tile_box(smem, 0, q, 0, BQ, 8)
    ar, ak = a_layout()
    for ks in range(HALF // 16):
        got = ldmatrix_q(smem, cw * 4 * BQ * RB, ks)
        want = q[ar, HALF * cw + 16 * ks + ak]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cw", [0, 1])
def test_k_and_v_descriptors_read_this_half(cw):
    # S's k16 step ks of warpgroup cw reads K[keys, 256 cw + 16 ks ..]
    # (K-major, SBO 8 rows); P V's step kk reads V[16 kk .., 256 cw ..]
    # (MN-major, LBO one column block of the tile, SBO 8 rows)
    kv = np.arange(BK)[:, None] * 1000.0 + np.arange(512)[None, :] + 1
    smem = np.zeros(BK * 512)
    tile_box(smem, 0, kv, 0, BK, 8)
    half = cw * 4 * BK * RB
    for ks in range(HALF // 16):
        blk, off = ks * 16 // BW, (ks * 16 % BW) * 2
        got = read_k_major(smem, half + blk * BK * RB + off, BK, 8 * RB, RB)
        assert np.array_equal(got, kv[:, HALF * cw + 16 * ks:][:, :16])
    for kk in range(BK // 16):
        got = read_mn_major(smem, half + kk * 16 * RB, HALF, BK * RB, 8 * RB,
                            RB)
        assert np.array_equal(got, kv[16 * kk:16 * kk + 16,
                                      HALF * cw:HALF * cw + HALF])


# ---------------------------------------------------------------------------
# the kernel, emulated


def emulate(q, k, v, scale, parts=None, mask=True):
    """One (b, h) of the kernel: q [Tq, D], k/v [Tk, D] (bf16 values in
    f32, D a multiple of 64). Returns bf16 values of out [Tq, D]. Per key
    tile of each part: S = the two warpgroups' halves of the depth, each
    rounded to f32 and summed in f32 (checked equal in either order), the
    online softmax (ex2 of one FFMA), O's column halves rescaled where the
    row max moved and += P V with P in bf16; the parts merged in order."""
    tq, d = q.shape
    tk = k.shape[0]
    pad = ((0, 0), (0, 512 - d))  # column blocks past D stay zero
    qp, kp, vp = (np.pad(x, pad) for x in (q, k, v))
    c = np.float32(scale * math.log2(math.e))
    ntiles = -(-tk // BK)
    if parts is None:
        parts, per, _ = attn.wide_wgmma_parts(1, 1, tq, tk)
    else:
        per = -(-ntiles // parts)
        parts = -(-ntiles // per)
    out = np.zeros((tq, 512), np.float32)
    for qb in range(-(-tq // BQ)):
        rows = slice(qb * BQ, min(tq, qb * BQ + BQ))
        qt = qp[rows]
        o_parts, m_parts, l_parts = [], [], []
        for part in range(parts):
            o = np.zeros((qt.shape[0], 512), np.float32)
            m = np.full(qt.shape[0], -np.inf, np.float32)
            l = np.zeros(qt.shape[0], np.float32)
            for t in range(part * per, min(ntiles, part * per + per)):
                keys = slice(t * BK, t * BK + BK)
                kt, vt = kp[keys], vp[keys]
                half = [f32(qt[:, h * HALF:h * HALF + HALF].astype(np.float64)
                            @ kt[:, h * HALF:h * HALF + HALF].T)
                        for h in range(2)]
                s = half[0] + half[1]
                assert np.array_equal(s, half[1] + half[0])  # both halves
                s = np.pad(s, ((0, 0), (0, BK - s.shape[1])))  # zero keys
                if mask and (t + 1) * BK > tk:
                    s[:, np.arange(BK) + t * BK >= tk] = -np.inf
                mx = np.maximum(m, s.max(1))
                mc = f32(mx.astype(np.float64) * c)
                alpha = f32(np.exp2(m.astype(np.float64) * c - mc))
                x = f32(np.exp2(s.astype(np.float64) * c - mc[:, None]))
                m = mx
                l = f32(l * alpha + x.sum(1, dtype=np.float32))
                o = np.where((alpha != 1)[:, None], f32(o * alpha[:, None]),
                             o)
                vt = np.pad(vt, ((0, BK - vt.shape[0]), (0, 0)))
                o = f32(o + bf16(x).astype(np.float64) @ vt)
            o_parts.append(o)
            m_parts.append(m)
            l_parts.append(l)
        if parts == 1:
            out[rows] = o_parts[0] / l_parts[0][:, None]
        else:  # flash_fwd_wide_combine_kernel, in part order
            big = np.max(m_parts, axis=0)
            acc = np.zeros_like(o_parts[0])
            lsum = np.zeros_like(l_parts[0])
            for o, m, l in zip(o_parts, m_parts, l_parts):
                w = f32(np.exp2(f32((m - big) * c).astype(np.float64)))
                lsum = f32(lsum + w * l)
                acc = f32(acc + w[:, None] * o)
            out[rows] = acc / lsum[:, None]
    return bf16(out[:, :d])


def _inputs(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [bf16(rng.standard_normal((n, d))) for n in (tq, tk, tk)]


def _errors(got, q, k, v):
    tq_, tk_, tv = (torch.from_numpy(x)[None, None] for x in (q, k, v))
    want = attn.attention_reference(tq_, tk_, tv)[0, 0].numpy()
    plain = attn.attention_reference(tq_.bfloat16(), tk_.bfloat16(),
                                     tv.bfloat16())[0, 0].float().numpy()
    return np.abs(got - want).max(), np.abs(plain - want).max()


# d 512 ragged (a partial query block, a last key tile of 13 keys), the
# head dims the route takes below 512, and several key parts (the combine)
EMU_CASES = [(512, 200, 333, None), (512, 130, 1000, 3), (512, 64, 257, 2),
             (192, 150, 500, None), (320, 140, 300, 2), (384, 100, 700, None)]


@pytest.mark.parametrize("d,tq,tk,parts", EMU_CASES)
def test_emulated_kernel_matches_the_plain_version(d, tq, tk, parts):
    q, k, v = _inputs(d + tq + tk, tq, tk, d)
    got = emulate(q, k, v, d ** -0.5, parts=parts)
    err, plain_err = _errors(got, q, k, v)
    assert np.isfinite(got).all()
    assert err <= 1.5 * plain_err, (err, plain_err)


def test_emulated_kernel_with_multi_query_kv():
    # one k/v head under two query heads: each head's block reads head 0
    rng = np.random.default_rng(5)
    q = bf16(rng.standard_normal((2, 150, 512)))
    k, v = (bf16(rng.standard_normal((1, 333, 512))) for _ in range(2))
    want = attn.attention_reference(
        torch.from_numpy(q)[None], torch.from_numpy(k)[None],
        torch.from_numpy(v)[None])[0].numpy()
    plain = attn.attention_reference(
        torch.from_numpy(q)[None].bfloat16(),
        torch.from_numpy(k)[None].bfloat16(),
        torch.from_numpy(v)[None].bfloat16())[0].float().numpy()
    for h in range(2):
        got = emulate(q[h], k[0], v[0], 512 ** -0.5)
        assert (np.abs(got - want[h]).max()
                <= 1.5 * np.abs(plain[h] - want[h]).max())


def test_last_tile_needs_its_minus_inf_mask():
    # TMA fills keys past Tk with zeros: a zero logit, not -inf
    q, k, v = _inputs(7, 130, 333, 512)
    got = emulate(q, k, v, 512 ** -0.5, mask=False)
    err, plain_err = _errors(got, q, k, v)
    assert err > 5 * plain_err


def test_parts_agree_with_one_part():
    # the combine merges the parts' unnormalized O within the rounding of
    # one part's walk
    q, k, v = _inputs(11, 100, 1100, 512)
    one = emulate(q, k, v, 512 ** -0.5, parts=1)
    for parts in (2, 4, 5):
        many = emulate(q, k, v, 512 ** -0.5, parts=parts)
        err, plain_err = _errors(many, q, k, v)
        assert err <= 1.5 * plain_err
        assert np.abs(many - one).max() <= 2 * plain_err


# ---------------------------------------------------------------------------
# the plain version against the JAX package's Pallas kernel


def test_plain_version_matches_pallas_interpret_at_d512():
    # the streaming kernel (_flash_kernel, :226): Tk 1200 f32 passes the
    # whole-KV regime's 4.6 KB a row
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, 1, 130, 512), dtype=np.float32)
    k, v = (rng.standard_normal((1, 1, 1200, 512), dtype=np.float32)
            for _ in range(2))
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True)
    got = attn.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert rel_err(got, ref) <= 1e-5


# ---------------------------------------------------------------------------
# the copies: thread 0 past each tile's barrier


def issue_walk(units, stages, seed):
    """Random interleavings of one block's two warpgroups over its units
    (`units`: each unit's key tiles) and the copies thread 0 issues: a
    unit's Q and K and V of its tiles 0 and 1 first, then past tile i's
    barrier K of i + 2 and V of i + 1, the ring's stages and phases and
    Q's phase running on from one unit to the next; TMA copies land at
    random later steps. Asserts no read before its data landed, no copy
    into a stage or a Q a warpgroup still reads, and that each copy past
    a barrier found its empty barrier completed (thread 0 waits only for
    a unit's first copies)."""
    rnd = random.Random(seed)
    full = {x: [MBarrier(1) for _ in range(stages)] for x in "kv"}
    full["q"] = [MBarrier(1)]
    empty = {x: [MBarrier(2) for _ in range(stages)] for x in "kv"}
    data = {x: [None] * stages for x in "kv"}
    data["q"] = [None]
    reading = {x: [set() for _ in range(stages)] for x in "kvq"}
    q_read = [-1, -1]  # the last unit whose Q each warpgroup read
    in_flight = []
    at_barrier = {}

    def issue(x, g):
        s = g % stages
        assert empty[x][s].try_wait(((g // stages) & 1) ^ 1), \
            "thread 0 would wait on a stage the block still reads"
        assert not reading[x][s]
        full[x][s].arrive(expect_tx=1)
        in_flight.append((x, s, g))

    def warpgroup(cw):
        base = 0
        for u, n in enumerate(units):
            if cw == 0:  # thread 0: Q and the unit's first tiles
                assert not reading["q"][0] and min(q_read) == u - 1, \
                    "Q refilled while a warpgroup still needs it"
                full["q"][0].arrive(expect_tx=1)
                in_flight.append(("q", 0, u))
                for i in range(min(n, stages)):
                    for x in "kv":
                        g = base + i
                        while not empty[x][g % stages].try_wait(
                                ((g // stages) & 1) ^ 1):
                            yield
                        issue(x, g)
            while not full["q"][0].try_wait(u & 1):
                yield
            assert data["q"][0] == u, "Q read before it landed"
            reading["q"][0].add(cw)
            yield  # ldmatrix into registers
            reading["q"][0].discard(cw)
            q_read[cw] = u
            for i in range(n):
                g = base + i
                s, parity = g % stages, (g // stages) & 1
                while not full["k"][s].try_wait(parity):
                    yield
                assert data["k"][s] == g, "S read K before it landed"
                reading["k"][s].add(cw)
                yield  # S, waited for
                reading["k"][s].discard(cw)
                empty["k"][s].arrive()
                at_barrier[g] = at_barrier.get(g, 0) + 1
                while at_barrier[g] < 2:  # the exchange's named barrier
                    yield
                if cw == 0:  # thread 0
                    if i + 2 < n:
                        issue("k", g + 2)
                    if i >= 1 and i + 1 < n:
                        issue("v", g + 1)
                yield  # the softmax
                while not full["v"][s].try_wait(parity):
                    yield
                assert data["v"][s] == g, "P V read V before it landed"
                reading["v"][s].add(cw)
                yield  # P V, waited for
                reading["v"][s].discard(cw)
                empty["v"][s].arrive()
            base += n

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                x, s, g = in_flight.pop(rnd.randrange(len(in_flight)))
                assert not reading[x][s]
                data[x][s] = g
                full[x][s].complete_tx(1)
            yield

    parties = [warpgroup(0), warpgroup(1)]
    copies = tma()
    steps = 0
    while parties:
        steps += 1
        assert steps < 100000, "the walk deadlocked"
        next(copies)
        p = rnd.choice(parties)
        try:
            next(p)
        except StopIteration:
            parties.remove(p)
    return steps


@pytest.mark.parametrize("ntiles", [1, 2, 3, 9])
def test_copies_issued_past_each_barrier(ntiles):
    for seed in range(20):
        assert issue_walk([ntiles], attn.WIDE_STAGES, seed) > 0


# a block's units in turn (a grid smaller than the units): tile counts of
# one, odd and even, so that a unit starts on either stage and phase
@pytest.mark.parametrize("units", [[1, 1, 1], [2, 3], [9, 1, 4], [3, 3, 3, 3]],
                         ids=str)
def test_units_run_the_ring_on(units):
    for seed in range(20):
        assert issue_walk(units, attn.WIDE_STAGES, seed) > 0


# ---------------------------------------------------------------------------
# the host's plan and the routes


@pytest.mark.parametrize("shape,parts", [
    ((1, 1, 9216, 9216), 4),    # the keyframe decode, 144 blocks
    ((1, 1, 4096, 4096), 2),    # the blurry decode, 64 blocks
    ((16, 1, 1024, 1024), 1),   # the video decode, 256 blocks
    ((1, 1, 1024, 1024), 4),    # the 32^2 keyframe, 16 blocks
    ((7, 1, 9216, 9216), 1),    # SVD's temporal decoder, 1008 blocks
    ((2, 1, 9216, 9216), 1),    # a served batch's keyframes, two waves
])
def test_host_chooses_parts_from_the_shape(shape, parts):
    b, h, tq, tk = shape
    got, per, units = attn.wide_wgmma_parts(*shape)
    ntiles = -(-tk // BK)
    assert got == parts
    assert per * (got - 1) < ntiles <= per * got  # no part left empty
    assert units == -(-tq // BQ) * b * h * got
    assert attn.wide_wgmma_scratch(*shape, 512) == (
        0 if got == 1 else got * b * h * tq * (4 * 512 + 8))


def test_parts_leave_two_waves_whole():
    # a grid of two waves or more keeps one part; below, each part holds
    # at least 8 tiles and there are at most 8
    for tq in range(64, 20000, 777):
        for tk in (100, 1000, 9216):
            parts, per, _ = attn.wide_wgmma_parts(1, 1, tq, tk)
            if -(-tq // BQ) >= 264:
                assert parts == 1
            assert 1 <= parts <= 8
            assert parts == 1 or per >= 8


def test_routes_at_wide_head_dims():
    bf, f = torch.bfloat16, torch.float32
    assert attn.flash_route(512, bf) == attn.WIDE_WGMMA_ROUTE
    for d in (192, 256, 320, 384, 448):
        assert attn.flash_route(d, bf) == attn.WIDE_WGMMA_ROUTE
    # the column-split kernel keeps biased, lse and unaligned launches,
    # and head dims between multiples of 64
    assert attn.flash_route(512, bf, biased=True) == "flash_fwd_wide_kernel"
    assert attn.flash_route(512, bf, lse=True) == "flash_fwd_wide_kernel"
    assert attn.flash_route(512, bf, aligned=False) == "flash_fwd_wide_kernel"
    for d in (136, 200, 264, 504):
        assert attn.flash_route(d, bf) == "flash_fwd_wide_kernel"
    # f32 past d 128 takes the TF32 column-split kernel; d <= 128 the
    # wgmma kernel of flash_attn_fwd_sm90.cu
    assert attn.flash_route(512, f) == "flash_fwd_wide_tf32_kernel"
    assert attn.flash_route(512, f, lse=True) == "flash_fwd_wide_tf32_kernel"
    assert attn.flash_route(128, bf) == attn.WGMMA_ROUTE
