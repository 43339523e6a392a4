"""CPU emulation of the bf16 wgmma flash forward
(neurons_tpu_torch/csrc/flash_attn_fwd_sm90.cu), by index.

The kernel runs only on the card. These tests replay in numpy what it does
with each index: the TMA box writes into swizzled shared-memory tiles (zero
past D and past Tk), the wgmma descriptors' reads of those tiles (K-major
for Q and K, MN-major for V) at every head dim's swizzle mode, the m64nNk16
accumulator layout, P's hand-off from S's registers into the A operand of
O += P V, the online softmax by thread and quad with the last tile's -inf
mask, the order of a tile's steps (S, the softmax rescaling O to the
tile's max, P V), the lse, and the producer / consumer walk over the full
and empty mbarriers of the ring. The emulated kernel is held to the
plain version (`attention_reference`) as the card tests hold the kernel:
within 1.5x the bf16 plain version's error against f32. No JAX here.
"""

from __future__ import annotations

import math
import random

import numpy as np
import pytest
import torch

from neurons_tpu_torch.ops import attention as attn

HEAD_DIMS = [32, 40, 64, 80, 88, 128]


def bf16(x) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def plan(d):
    bw, nb = attn.wgmma_blocks(d)
    bq, bk, stages = attn.wgmma_tiles(d)
    return dict(bw=bw, nb=nb, dk=bw * nb, rb=2 * bw, bq=bq, bk=bk,
                stages=stages, cons=bq // 64)


# ---------------------------------------------------------------------------
# register layouts (csrc/sm90.cuh)

def c_layout(n):
    """(row, col) of accumulator register i of thread tid, m64nNk16 f32:
    arrays [128, n / 2]."""
    tid = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    warp, lane = tid // 32, tid % 32
    row = 16 * warp + lane // 4 + 8 * ((i >> 1) & 1)
    col = 8 * (i // 4) + 2 * (lane % 4) + (i & 1)
    return row, col


def a_layout():
    """(row, k) of A register j (0..3), half h (0 low, 1 high) of thread
    tid for one k16 step: arrays [128, 4, 2]."""
    tid = np.arange(128)[:, None, None]
    j = np.arange(4)[None, :, None]
    h = np.arange(2)[None, None, :]
    warp, lane = tid // 32, tid % 32
    g, t = lane // 4, lane % 4
    row = 16 * warp + g + 8 * (j & 1)
    k = 2 * t + h + 8 * (j >> 1)
    return row + 0 * k, k + 0 * row


def pack_p(sc):
    """The kernel's hand-off: sc [128, BK / 2] -> pa [128, BK / 16, 4, 2]
    (pa[kk][j] packs sc[8 kk + 2 j] and sc[8 kk + 2 j + 1])."""
    n = sc.shape[1]
    return sc.reshape(128, n // 8, 4, 2)


@pytest.mark.parametrize("n", [32, 48, 64, 80, 96, 128])
def test_accumulator_layout_covers_each_element_once(n):
    row, col = c_layout(n)
    seen = np.zeros((64, n), int)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()


def test_p_hands_off_from_c_to_a_without_a_shuffle():
    # S's accumulator chunks 2 kk and 2 kk + 1, packed in pairs, are the A
    # fragment of k step kk: the P matrix read through A's layout is S
    rng = np.random.default_rng(0)
    s = rng.standard_normal((64, 128)).astype(np.float32)
    row, col = c_layout(128)
    pa = pack_p(s[row, col])
    ar, ak = a_layout()
    p = np.zeros_like(s)
    for kk in range(128 // 16):
        p[ar, 16 * kk + ak] = pa[:, kk]
    assert np.array_equal(p, s)


# ---------------------------------------------------------------------------
# shared memory: TMA's swizzled writes and the descriptors' reads

def swizzle(addr, rb):
    """The 16-byte chunk of a byte address XORed with address bits 7.. (as
    many bits as the row's swizzle span has chunks beyond one)."""
    mask = {32: 1, 64: 3, 128: 7}[rb]
    return addr ^ (((addr >> 7) & mask) << 4)


def tma_box(smem, base, src, r0, c0, rows, bw, rb):
    """One box of `rows` x `bw` elements of the 2-D `src` at (r0, c0) into
    the byte-addressed bf16 `smem` at `base`, zero where the box passes
    src's extent."""
    r = np.arange(rows)[:, None]
    c = np.arange(bw)[None, :]
    inside = (r0 + r < src.shape[0]) & (c0 + c < src.shape[1])
    vals = np.where(inside, src[np.minimum(r0 + r, src.shape[0] - 1),
                                np.minimum(c0 + c, src.shape[1] - 1)], 0.0)
    addr = swizzle(base + r * rb + 2 * c, rb)
    smem[addr // 2] = vals


def read_k_major(smem, start, rows, sbo, rb):
    """The [rows x 16] operand a K-major descriptor (start, SBO) reads."""
    r = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (r // 8) * sbo + (r % 8) * rb + (k // 8) * 16 + (k % 8) * 2
    return smem[swizzle(addr, rb) // 2]


def read_mn_major(smem, start, n, lbo, sbo, rb):
    """The [16 x n] operand an MN-major descriptor (start, LBO, SBO) reads
    (k rows, n columns)."""
    bw = rb // 2
    k = np.arange(16)[:, None]
    c = np.arange(n)[None, :]
    addr = (start + (c // bw) * lbo + (k // 8) * sbo + (k % 8) * rb
            + (c % bw) * 2)
    return smem[swizzle(addr, rb) // 2]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_swizzled_box_is_a_bijection_on_its_tile(d):
    p = plan(d)
    rows = p["bk"]
    addr = swizzle(np.arange(rows)[:, None] * p["rb"]
                   + 2 * np.arange(p["bw"])[None, :], p["rb"])
    assert sorted(addr.ravel().tolist()) == list(range(0, rows * p["rb"], 2))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_descriptors_read_the_intended_elements(d):
    # K (keys x D) and Q written by TMA boxes of BW columns; every k16 step
    # of S = Q K^T reads Q[rows of warpgroup cw, 16 ks ..] and K[keys,
    # 16 ks ..] (zero past D), every k16 step of P V reads V[16 kk .., :DK]
    p = plan(d)
    bw, nb, rb, bk, bq = p["bw"], p["nb"], p["rb"], p["bk"], p["bq"]
    k_src = (np.arange(bk)[:, None] * 1000.0 + np.arange(d)[None, :] + 1)
    q_src = -k_src[:1].repeat(bq, 0) - 1000.0 * np.arange(bq)[:, None]
    tile = bk * p["dk"] * 2
    smem = np.full((bq * p["dk"] * 2 + tile) // 2, np.nan)
    for j in range(nb):
        tma_box(smem, j * bq * rb, q_src, 0, j * bw, bq, bw, rb)
        tma_box(smem, bq * p["dk"] * 2 + j * bk * rb, k_src, 0, j * bw, bk,
                bw, rb)
    k_base = bq * p["dk"] * 2
    k_pad = np.pad(k_src, ((0, 0), (0, p["dk"] - d)))
    q_pad = np.pad(q_src, ((0, 0), (0, p["dk"] - d)))
    for ks in range(p["dk"] // 16):
        blk, off = ks * 16 // bw, (ks * 16 % bw) * 2
        got_k = read_k_major(smem, k_base + blk * bk * rb + off, bk, 8 * rb, rb)
        assert np.array_equal(got_k, k_pad[:, 16 * ks:16 * ks + 16])
        for cw in range(p["cons"]):
            got_q = read_k_major(smem, cw * 64 * rb + blk * bq * rb + off,
                                 64, 8 * rb, rb)
            assert np.array_equal(
                got_q, q_pad[64 * cw:64 * cw + 64, 16 * ks:16 * ks + 16])
    # the same tile read as V, MN-major: LBO one column block, SBO 8 rows
    for kk in range(bk // 16):
        got_v = read_mn_major(smem, k_base + kk * 16 * rb, p["dk"], bk * rb,
                              8 * rb, rb)
        assert np.array_equal(got_v, k_pad[16 * kk:16 * kk + 16])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_fit_shared_memory_and_keep_swizzle_alignment(d):
    p = plan(d)
    q_bytes = p["bq"] * p["dk"] * 2
    tile = p["bk"] * p["dk"] * 2
    smem = q_bytes + 2 * p["stages"] * tile + 8 * (1 + 4 * p["stages"]) + 1024
    assert smem <= 232448  # the 227 KB a block may use
    # every tile, column block, warpgroup slice and k16 step of V starts
    # on its swizzle pattern's period (1024 bytes covers all three spans)
    for off in (q_bytes, tile, p["bq"] * p["rb"], p["bk"] * p["rb"],
                64 * p["rb"], 16 * p["rb"]):
        assert off % (8 * p["rb"]) == 0
    assert p["dk"] >= d and p["dk"] - d < 16 and p["bw"] <= d


# ---------------------------------------------------------------------------
# the kernel, emulated

def emulate(q, k, v, scale, lse=False, mask=True):
    """One (b, h) of the kernel: q [Tq, D], k/v [Tk, D] (bf16 values in
    f32). Returns (out [Tq, D] bf16 values, lse [Tq] or None). Per key
    tile: S, its softmax (O rescaled to the tile's max, P made), P V."""
    tq, d = q.shape
    tk = k.shape[0]
    p = plan(d)
    bw, nb, rb, bk, bq, dk = (p["bw"], p["nb"], p["rb"], p["bk"], p["bq"],
                              p["dk"])
    stages = p["stages"]
    q_bytes, tile = bq * dk * 2, bk * dk * 2
    k_base, v_base = q_bytes, q_bytes + stages * tile
    c = np.float32(scale if lse else scale * math.log2(math.e))
    out = np.zeros((tq, d), np.float32)
    lse_out = np.zeros(tq, np.float32)
    srow, scol = c_layout(bk)
    orow, ocol = c_layout(dk)
    ar, ak = a_layout()
    thread = np.arange(128)
    lane = thread % 32
    r_of_s = (np.arange(bk // 2) >> 1) & 1  # register -> its row (0 or 8)
    r_of_o = (np.arange(dk // 2) >> 1) & 1
    ntiles = -(-tk // bk)
    for qb in range(-(-tq // bq)):
        # the producer: Q once, then K and V of tile t into stage t % stages
        # (a snapshot of shared memory as each tile's products read it)
        smem = np.zeros((q_bytes + 2 * stages * tile) // 2, np.float32)
        for j in range(nb):
            tma_box(smem, j * bq * rb, q, qb * bq, j * bw, bq, bw, rb)
        images = []
        for t in range(ntiles):
            st = t % stages
            for j in range(nb):
                for base, src in ((k_base, k), (v_base, v)):
                    tma_box(smem, base + st * tile + j * bk * rb, src,
                            t * bk, j * bw, bk, bw, rb)
            images.append(smem.copy())

        def pv(t, pa):  # O's registers of P (tile t) V (tile t)
            pmat = np.zeros((64, bk), np.float32)
            for kk in range(bk // 16):
                pmat[ar, 16 * kk + ak] = pa[:, kk]
            vmat = np.concatenate([read_mn_major(
                images[t], v_base + (t % stages) * tile + kk * 16 * rb, dk,
                bk * rb, 8 * rb, rb) for kk in range(bk // 16)])
            return (pmat.astype(np.float64) @ vmat)[orow, ocol]

        for cw in range(p["cons"]):
            o = np.zeros((128, dk // 2), np.float32)
            m = np.full((128, 2), -np.inf, np.float32)
            l = np.zeros((128, 2), np.float32)
            pa = None
            for t in range(ntiles):
                smat = np.zeros((64, bk), np.float64)
                for ks in range(dk // 16):  # S = Q K^T, k16 steps
                    blk, off = ks * 16 // bw, (ks * 16 % bw) * 2
                    a = read_k_major(images[t], cw * 64 * rb + blk * bq * rb
                                     + off, 64, 8 * rb, rb)
                    b = read_k_major(images[t], k_base + (t % stages) * tile
                                     + blk * bk * rb + off, bk, 8 * rb, rb)
                    smat += a.astype(np.float64) @ b.T.astype(np.float64)
                sc = smat.astype(np.float32)[srow, scol]
                if mask and (t + 1) * bk > tk:
                    sc = np.where(t * bk + scol >= tk, -np.inf, sc)
                if lse:
                    sc = (sc * c).astype(np.float32)
                mx = m.copy()
                for r in range(2):
                    mx[:, r] = np.maximum(mx[:, r], sc[:, r_of_s == r].max(1))
                mx = np.maximum(mx, mx[thread ^ 1])  # the quad: xor 1, xor 2
                mx = np.maximum(mx, mx[thread ^ 2])
                if lse:
                    mc = mx
                    alpha = np.exp(m - mx).astype(np.float32)
                    x = np.exp(sc - mc[:, r_of_s]).astype(np.float32)
                else:
                    mc = (mx * c).astype(np.float32)
                    alpha = np.exp2(m.astype(np.float64) * c - mc) \
                        .astype(np.float32)
                    x = np.exp2(sc.astype(np.float64) * c
                                - mc[:, r_of_s]).astype(np.float32)
                m = mx
                rs = np.zeros((128, 2), np.float32)
                for i in range(bk // 2):
                    rs[:, r_of_s[i]] += x[:, i]
                l = (l * alpha + rs).astype(np.float32)
                o = (o * alpha[:, r_of_o]).astype(np.float32)
                pa = bf16(pack_p(x))
                o = (o + pv(t, pa)).astype(np.float32)
            l = l + l[thread ^ 1]
            l = l + l[thread ^ 2]
            row0 = qb * bq + cw * 64
            for r in range(2):
                rows = row0 + orow[:, r_of_o == r]
                cols = ocol[:, r_of_o == r]
                ok = (rows < tq) & (cols < d)
                vals = o[:, r_of_o == r] / l[:, r:r + 1]
                out[rows[ok], cols[ok]] = vals[ok]
                rr = row0 + 16 * (thread // 32) + lane // 4 + 8 * r
                keep = (rr < tq) & (lane % 4 == 0)
                lse_out[rr[keep]] = (m[keep, r]
                                     + np.log(np.maximum(l[keep, r], 1e-30)))
    return bf16(out), (lse_out if lse else None)


def _inputs(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [bf16(rng.standard_normal((n, d))) for n in (tq, tk, tk)]


def _errors(got, q, k, v):
    tq_, tk_, tv = (torch.from_numpy(x)[None, None] for x in (q, k, v))
    want = attn.attention_reference(tq_, tk_, tv)[0, 0].numpy()
    plain = attn.attention_reference(tq_.bfloat16(), tk_.bfloat16(),
                                     tv.bfloat16())[0, 0].float().numpy()
    return np.abs(got - want).max(), np.abs(plain - want).max()


# ragged rows and keys at every head dim: a partial query block, a last key
# tile of 1 (d 40: 257 keys) to 127 keys, a single key tile
EMU_CASES = [(32, 200, 300), (40, 130, 257), (64, 192, 128), (80, 70, 200),
             (88, 257, 257), (128, 129, 130)]


@pytest.mark.parametrize("d,tq,tk", EMU_CASES)
def test_emulated_kernel_matches_the_plain_version(d, tq, tk):
    q, k, v = _inputs(d + tq, tq, tk, d)
    got, _ = emulate(q, k, v, d ** -0.5)
    err, plain_err = _errors(got, q, k, v)
    assert np.isfinite(got).all()
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.parametrize("d,tq,tk", [(40, 130, 257), (128, 129, 130)])
def test_last_tile_needs_its_minus_inf_mask(d, tq, tk):
    # TMA fills keys past Tk with zeros: a zero logit, not -inf. Without
    # the mask the emulated kernel weighs them in and leaves the plain
    # version's error far behind
    q, k, v = _inputs(7, tq, tk, d)
    got, _ = emulate(q, k, v, d ** -0.5, mask=False)
    err, plain_err = _errors(got, q, k, v)
    assert err > 5 * plain_err


@pytest.mark.parametrize("d,tq,tk", [(32, 150, 300), (64, 200, 130),
                                     (128, 129, 257)])
def test_emulated_lse_matches_the_plain_version(d, tq, tk):
    # the lse instance: scaled logits, the accurate exp, m + log(max(l,
    # 1e-30)), held at f32 level as the card holds the kernel's lse
    q, k, v = _inputs(d * 3 + tk, tq, tk, d)
    got, lse = emulate(q, k, v, d ** -0.5, lse=True)
    want_out, want_lse = attn.attention_reference_lse(
        *(torch.from_numpy(x)[None, None].double() for x in (q, k, v)))
    err, plain_err = _errors(got, q, k, v)
    assert err <= 1.5 * plain_err
    assert np.abs(lse - want_lse[0, 0].numpy()).max() <= 4e-6


# ---------------------------------------------------------------------------
# the mbarrier ring

class MBarrier:
    """A phase counter: a phase completes when its arrivals and its
    transaction bytes are all in; try_wait(parity) succeeds once the
    phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.completed = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.count

    def arrive(self, expect_tx=0):
        self.tx += expect_tx
        self.pending -= 1
        self._check()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

    def try_wait(self, parity):
        return self.completed % 2 != parity


def ring_walk(ntiles, stages, cons, seed):
    """Random interleavings of the producer (K then V of each tile into
    stage t % stages, each after the stage's empty barrier) and `cons`
    consumers (S of tile t after K's full barrier, releasing K, then P V
    after V's, releasing V),
    with TMA copies that land at random later steps. Asserts no read
    before its data landed and no copy into a stage a consumer still
    reads; returns the steps taken (every party finishes)."""
    rnd = random.Random(seed)
    full = {x: [MBarrier(1) for _ in range(stages)] for x in "kv"}
    empty = {x: [MBarrier(cons) for _ in range(stages)] for x in "kv"}
    data = {x: [None] * stages for x in "kv"}   # the tile a stage holds
    reading = {x: [set() for _ in range(stages)] for x in "kv"}
    in_flight = []  # (kind, stage, tile)

    def producer():
        for t in range(ntiles):
            s, parity = t % stages, ((t // stages) & 1) ^ 1
            for x in "kv":
                while not empty[x][s].try_wait(parity):
                    yield
                assert not reading[x][s], "a copy overwrote a stage in use"
                full[x][s].arrive(expect_tx=1)
                in_flight.append((x, s, t))
                yield

    def consumer(cw):
        for t in range(ntiles):
            s, parity = t % stages, (t // stages) & 1
            for x in "kv":  # S of tile t, the softmax, then P V
                while not full[x][s].try_wait(parity):
                    yield
                assert data[x][s] == t, f"a product read {x} before it landed"
                reading[x][s].add(cw)
                yield  # the product runs, and is waited for
                reading[x][s].discard(cw)
                empty[x][s].arrive()
                yield  # the softmax, or the next tile

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                x, s, t = in_flight.pop(rnd.randrange(len(in_flight)))
                assert not reading[x][s]
                data[x][s] = t
                full[x][s].complete_tx(1)
            yield

    parties = [producer()] + [consumer(c) for c in range(cons)]
    copies = tma()
    steps = 0
    while parties:
        steps += 1
        assert steps < 100000, "the ring deadlocked"
        next(copies)
        p = rnd.choice(parties)
        try:
            next(p)
        except StopIteration:
            parties.remove(p)
    return steps


@pytest.mark.parametrize("stages,cons", [(2, 2), (2, 3), (3, 2)])
@pytest.mark.parametrize("ntiles", [1, 2, 3, 7])
def test_mbarrier_ring_walk(ntiles, stages, cons):
    for seed in range(20):
        assert ring_walk(ntiles, stages, cons, seed) > 0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dims_and_routes(d):
    # every launched head dim has an instance (and d 56, 104, 112, 24
    # none: the register kernel takes them); the route name is the
    # kernel's
    assert attn.wgmma_blocks(d) is not None
    assert attn.flash_route(d, torch.bfloat16) == attn.WGMMA_ROUTE
    for other in (24, 56, 104, 112, 136, 42):
        assert attn.wgmma_blocks(other) is None
