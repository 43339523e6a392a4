"""CPU emulation of the TF32 wgmma flash forward
(neurons_tpu_torch/csrc/flash_attn_fwd_tf32_sm90.cu), by index, and the
port's f32 forward against the JAX package's.

The kernel runs only on the card. These tests replay in numpy what it does
with each index: the TMA boxes' swizzled f32 writes of Q, K and V (zero
past D and past Tk), the producer's rounding of K in place and its
transpose of V in place into V^T (keys contiguous, each 8-key group in the
order 0 2 4 6 1 3 5 7) with its lane map, the K-major descriptors' reads of
Q, K and V^T at every DN's swizzle, the m64nNk8 accumulator layout, P's
hand-off from S's registers into the TF32 A fragment (a = c0, c2, c1,
c3), cvt.rna against `round_to_tf32`, the online softmax by thread and
quad (the inference exp2 of one FFMA, the lse's exp, a bias slice, the
last tile's -inf mask) and the full / ready / empty mbarrier walk of the
producer and the consumers, and chip_smoke.py's gate on the instances'
registers, spills and serialized products. The emulated kernel is held
to the plain version as the card tests hold the kernel: its error
against float64 within 1.5x that of `attention_reference_tf32`
(TF32-rounded operands).

The last cases hold the port's f32 `flash_attention_fwd` (its plain
version on the CPU) to the JAX package's `_flash_attention_impl` (the
Pallas kernels in interpret mode, as the JAX tests run them) at d 40, 52
(biased, with the lse, multi-query k/v) and 104: both sides run f32
arithmetic up to summation order, held to 1e-4 of max |JAX| (2e-4 for the
lse, which sums exponentials over the row in another order)."""

from __future__ import annotations

import random
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.ops import attention as jattn
from neurons_tpu_torch.ops import attention as attn
from torch_port_utils import rel_err, t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

HEAD_DIMS = [8, 32, 40, 52, 64, 80, 104, 128]
LOG2E = 1.4426950408889634


def plan(d, cons):
    bq, bk, bw, nb, stages, smem, blocks = attn.tf32_wgmma_tiles(d, cons)
    return dict(dn=attn.tf32_wgmma_dn(d), bq=bq, bk=bk, bw=bw, nb=nb,
                dks=bw * nb, rb=4 * bw, stages=stages, smem=smem,
                blocks=blocks, cons=cons)


def rna(x) -> np.ndarray:
    """cvt.rna.tf32.f32 by its definition: the nearest value with 10
    mantissa bits, ties away from zero (computed in float64)."""
    x = np.asarray(x, np.float32).astype(np.float64)
    mant, exp = np.frexp(x)                  # x = mant 2^exp, |mant| in [0.5, 1)
    scaled = np.abs(mant) * 2.0 ** 11        # 11 significant bits
    r = np.floor(scaled + 0.5)               # halves away from zero
    return (np.sign(mant) * r * 2.0 ** (exp - 11)).astype(np.float32)


def tf32(x) -> np.ndarray:
    return attn.round_to_tf32(torch.from_numpy(
        np.ascontiguousarray(x, np.float32))).numpy()


def test_cvt_rna_is_round_to_tf32():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)
         ).astype(np.float32)
    # exact ties: 10 mantissa bits then a lone 1 in the 11th place
    ties = (np.arange(1, 2048, dtype=np.float32) * 2.0 + 1.0) / 2.0 ** 11
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, 65504.0]]
                       ).astype(np.float32)
    assert np.array_equal(tf32(x), rna(x))
    # 13 low bits cleared, and the tensor core's truncation would differ
    bits = tf32(x).view(np.int32)
    assert not (bits & 0x1FFF).any()
    trunc = (x.view(np.int32) & ~0x1FFF).view(np.float32)
    assert not np.array_equal(trunc, tf32(x))


# ---------------------------------------------------------------------------
# register layouts (csrc/sm90.cuh)

def c_layout(n):
    """(row, col) of accumulator register i of thread tid, m64nNk8 f32:
    arrays [128, n / 2] (m64nNk16's layout)."""
    tid = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    warp, lane = tid // 32, tid % 32
    row = 16 * warp + lane // 4 + 8 * ((i >> 1) & 1)
    col = 8 * (i // 4) + 2 * (lane % 4) + (i & 1)
    return row, col


def a_layout():
    """(row, k) of TF32 A register j (0..3) of thread tid for one k8 step:
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); [128, 4]."""
    tid = np.arange(128)[:, None]
    j = np.arange(4)[None, :]
    warp, lane = tid // 32, tid % 32
    g, t4 = lane // 4, lane % 4
    return 16 * warp + g + 8 * (j & 1), t4 + 4 * (j >> 1)


PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # A's column k -> the key it holds


def hand_off(sc):
    """The kernel's P: sc [128, BK / 2] -> pa [128, BK / 8, 4] (a = c0, c2,
    c1, c3 of S's chunk kk), rounded."""
    n = sc.shape[1]
    chunks = sc.reshape(128, n // 4, 4)
    return tf32(chunks[:, :, [0, 2, 1, 3]])


def a_matrix(pa):
    """The [64, 8 kk] matrix the A fragments pa [128, kk, 4] hold, by A's
    column (each 8-key group in PERM's order)."""
    ar, ak = a_layout()
    out = np.zeros((64, 8 * pa.shape[1]), np.float32)
    for kk in range(pa.shape[1]):
        out[ar, 8 * kk + ak] = pa[:, kk]
    return out


@pytest.mark.parametrize("n", [8, 32, 56, 64, 104, 128])
def test_accumulator_layout_covers_each_element_once(n):
    row, col = c_layout(n)
    seen = np.zeros((64, n), int)
    np.add.at(seen, (row, col), 1)
    assert (seen == 1).all()


def test_p_hands_off_from_c_to_a_by_the_key_permutation():
    # A's column t of k step kk is S's key 8 kk + 2t, column t + 4 key
    # 8 kk + 2t + 1: no register moves between lanes
    rng = np.random.default_rng(1)
    s = tf32(rng.standard_normal((64, 64)))
    row, col = c_layout(64)
    pmat = a_matrix(hand_off(s[row, col]))
    keys = (8 * (np.arange(64) // 8) + PERM[np.arange(64) % 8])
    assert np.array_equal(pmat, s[:, keys])
    # C's own order is not A's: taken as is, the columns would not match
    assert not np.array_equal(a_matrix(tf32(s[row, col].reshape(128, 8, 4))),
                              s)


# ---------------------------------------------------------------------------
# shared memory: TMA's swizzled writes and the descriptors' reads (4-byte
# elements; byte addresses)

def swizzle(addr, rb):
    """The 16-byte chunk of a byte address XORed with address bits 7.. (as
    many bits as the row's swizzle span has chunks beyond one)."""
    mask = {32: 1, 64: 3, 128: 7}[rb]
    return addr ^ (((addr >> 7) & mask) << 4)


def tma_box(smem, base, src, r0, c0, rows, bw, rb):
    """One box of `rows` x `bw` floats of the 2-D `src` at (r0, c0) into
    the byte-addressed f32 `smem` at `base`, zero past src's extent."""
    r = np.arange(rows)[:, None]
    c = np.arange(bw)[None, :]
    inside = (r0 + r < src.shape[0]) & (c0 + c < src.shape[1])
    vals = np.where(inside, src[np.minimum(r0 + r, src.shape[0] - 1),
                                np.minimum(c0 + c, src.shape[1] - 1)], 0.0)
    smem[swizzle(base + r * rb + 4 * c, rb) // 4] = vals


def read_k_major(smem, start, rows, sbo, rb):
    """The [rows x 8] operand of one k8 step a K-major descriptor (start,
    SBO) reads: 8 floats (32 bytes) of each row."""
    r = np.arange(rows)[:, None]
    k = np.arange(8)[None, :]
    addr = start + (r // 8) * sbo + (r % 8) * rb + 4 * k
    return smem[swizzle(addr, rb) // 4]


def v_jobs(p):
    """The producer's V pieces as the kernel numbers them: per piece j
    (thread j % 128, pass j // 128) the lane position l, the 32-key block
    kb and the 4-column chunk c."""
    nkb, full = p["bk"] // 32, (p["dn"] // 4) & ~7
    j = np.arange((p["bk"] // 8) * 2 * (p["dn"] // 4))
    l, rest = j & 7, j >> 3
    kb, m = rest % nkb, rest // nkb
    c = np.where(m < full, m ^ (l & 6), m)
    return j, l, kb, c


def v_reads(p, base):
    """Byte addresses [jobs, u] of the raw V tile's float4 reads."""
    _, l, kb, c = v_jobs(p)
    u = np.arange(4)[None, :]
    key = 32 * kb[:, None] + 8 * (l[:, None] >> 1) + 2 * u + (l[:, None] & 1)
    col = 4 * c[:, None]
    blk, cc = col // p["bw"], col % p["bw"]
    return base + blk * p["bk"] * p["rb"] + swizzle(key * p["rb"] + 4 * cc,
                                                     p["rb"]), key


def v_writes(p, base):
    """Byte addresses [jobs, w] of V^T's float4 writes (column n = 4c + w)."""
    _, l, kb, c = v_jobs(p)
    w = np.arange(4)[None, :]
    n = 4 * c[:, None] + w
    return base + kb[:, None] * p["dn"] * 128 + swizzle(
        n * 128 + 16 * l[:, None], 128), n


def transpose_v(smem, base, p):
    """The producer's in-place pass: every piece read (4 keys x 4 columns)
    before any write, each written rounded to V^T's row n."""
    raddr, _ = v_reads(p, base)
    vals = np.stack([smem[(raddr[:, :, None] // 4) + np.arange(4)]])[0]
    waddr, _ = v_writes(p, base)
    # value (piece, u, col w) goes to V^T row 4c + w, position 4 (l & 1) + u
    for w in range(4):
        for u in range(4):
            smem[waddr[:, w] // 4 + u] = tf32(vals[:, u, w])


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_swizzled_tiles_are_bijections(d, many):
    p = plan(d, attn.tf32_wgmma_many(d) if many else 1)
    for rows in (p["bq"], p["bk"]):  # a column block of Q, of K or V
        addr = swizzle(np.arange(rows)[:, None] * p["rb"]
                       + 4 * np.arange(p["bw"])[None, :], p["rb"])
        assert sorted(addr.ravel().tolist()) == list(
            range(0, rows * p["rb"], 4))
    # V^T's 32-key blocks of 128-byte rows: DN rows each
    addr = swizzle(np.arange(p["dn"])[:, None] * 128
                   + 4 * np.arange(32)[None, :], 128)
    assert sorted(addr.ravel().tolist()) == list(range(0, p["dn"] * 128, 4))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_v_transpose_pieces_cover_v_once_and_keep_their_banks(d):
    p = plan(d, 1)
    bk, dn = p["bk"], p["dn"]
    _, key = v_reads(p, 0)
    waddr, n = v_writes(p, 0)
    # every (key, column) of the tile read once, every V^T slot written once
    c = (n // 4)[:, :1]
    seen = np.zeros((bk, dn // 4), int)
    np.add.at(seen, (key, np.broadcast_to(c, key.shape)), 1)
    assert (seen == 1).all()
    slots = (waddr[:, :, None] + 4 * np.arange(4)).ravel()
    assert sorted(slots.tolist()) == list(range(0, dn * bk * 4, 4))
    # the 8 lanes of each 16-byte phase: 8 distinct bank groups on every
    # read (128-byte raw rows) and every write
    raddr, _ = v_reads(p, 0)
    for a in (raddr, waddr):
        for start in range(0, (len(a) // 8) * 8, 8):
            phase = a[start:start + 8]
            full = (start // 8) // (bk // 32) < (dn // 4) & ~7
            if p["rb"] == 128 and full:
                for col in range(4):
                    assert len(set((phase[:, col] // 16 % 8).tolist())) == 8


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_descriptors_read_the_intended_elements(d, many):
    # Q and K written by TMA boxes of BW columns (zero past D); each k8
    # step of S reads Q[warpgroup's rows, 8 ks ..] and K[keys, 8 ks ..];
    # V transposed in place: each k8 step of P V reads V^T, 8 permuted keys
    cons = attn.tf32_wgmma_many(d) if many else 1
    p = plan(d, cons)
    bw, nb, rb, bk, bq, dn = (p["bw"], p["nb"], p["rb"], p["bk"], p["bq"],
                              p["dn"])
    rng = np.random.default_rng(d)
    q_src = rng.standard_normal((bq, d)).astype(np.float32)
    v_src = rng.standard_normal((bk, d)).astype(np.float32)
    q_bytes, tile = bq * p["dks"] * 4, bk * p["dks"] * 4
    smem = np.full((q_bytes + 2 * tile) // 4, np.nan, np.float32)
    for j in range(nb):
        tma_box(smem, j * bq * rb, q_src, 0, j * bw, bq, bw, rb)
        tma_box(smem, q_bytes + j * bk * rb, v_src, 0, j * bw, bk, bw, rb)
        tma_box(smem, q_bytes + tile + j * bk * rb, v_src, 0, j * bw, bk, bw,
                rb)
    assert not np.isnan(smem).any()
    q_pad = np.pad(q_src, ((0, 0), (0, dn - d)))
    k_pad = np.pad(v_src, ((0, 0), (0, dn - d)))
    for ks in range(dn // 8):
        blk, off = ks * 8 // bw, (ks * 8 % bw) * 4
        got_k = read_k_major(smem, q_bytes + blk * bk * rb + off, bk, 8 * rb,
                             rb)
        assert np.array_equal(got_k, k_pad[:, 8 * ks:8 * ks + 8])
        for cw in range(cons):
            got_q = read_k_major(smem, cw * 64 * rb + blk * bq * rb + off,
                                 64, 8 * rb, rb)
            assert np.array_equal(
                got_q, q_pad[64 * cw:64 * cw + 64, 8 * ks:8 * ks + 8])
    vt = q_bytes + tile
    transpose_v(smem, vt, p)
    for kk in range(bk // 8):
        got = read_k_major(smem, vt + (kk // 4) * dn * 128 + (kk % 4) * 32,
                           dn, 1024, 128)          # [DN, 8]
        want = tf32(k_pad[8 * kk + PERM]).T         # V^T's permuted keys
        assert np.array_equal(got, want)


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_fit_shared_memory_and_keep_swizzle_alignment(d, many):
    p = plan(d, attn.tf32_wgmma_many(d) if many else 1)
    q_bytes, tile = p["bq"] * p["dks"] * 4, p["bk"] * p["dks"] * 4
    smem = q_bytes + 2 * p["stages"] * tile + 8 * (1 + 3 * p["stages"]) + 1024
    assert smem == p["smem"] <= 232448  # the 227 KB a block may use
    assert p["blocks"] * (smem + 1024) <= 233472  # the SM's 228 KB
    # tiles, column blocks, warpgroup slices and V^T's key blocks start on
    # their swizzle's period (1024 bytes covers every span)
    for off in (q_bytes, tile, p["bq"] * p["rb"], p["bk"] * p["rb"],
                64 * p["rb"], p["dn"] * 128):
        assert off % (8 * p["rb"]) == 0 and (p["dn"] * 128) % 1024 == 0
    # a box at most as wide as the map: the last column block starts
    # inside d
    assert p["bw"] <= d and (p["nb"] - 1) * p["bw"] < d
    assert p["dn"] - d < 8 and p["dn"] <= p["dks"]


def test_consumer_regimes():
    # one consumer while its 64-row blocks fit two waves of 132 SMs at two
    # an SM (d <= 64) or one wave at one an SM (past 64); else three up to
    # DN 64, two past it
    c = attn.tf32_wgmma_consumers
    assert [attn.tf32_wgmma_many(d) for d in (8, 60, 64, 68, 128)] == [
        3, 3, 3, 2, 2]
    assert c(2, 20, 256, 64) == 1       # validate's 256^2: 160 blocks
    assert c(2, 10, 1024, 64) == 1      # 320
    assert c(6, 16, 257, 64) == 1       # CLIP ViT-L: 480
    assert c(32, 8, 1024, 40) == 3      # validate's d 40: 4096
    assert c(10, 32, 513, 52) == 3      # the prior: 2880
    assert c(24, 1, 4096, 32) == 3      # the panel's 64^2: 1536
    assert c(1, 12, 197, 64) == 1       # ViT-B: 48
    assert c(24, 1, 256, 128) == 1      # the panel's 16^2: 96
    assert c(60, 1, 256, 128) == 2      # the f32 step's 16^2: 240
    assert c(16, 16, 257, 104) == 2     # bigG: 1280
    assert (c(1, 132, 256, 64), c(1, 133, 256, 64)) == (1, 3)    # 528
    assert (c(1, 33, 256, 128), c(1, 34, 256, 128)) == (1, 2)    # 132


# ---------------------------------------------------------------------------
# the kernel, emulated

def emulate(q, k, v, scale, cons, bias=None, lse=False, mask=True):
    """One (b, h) of the kernel: q [Tq, D], k/v [Tk, D] f32, bias [Tq, Tk]
    or None. Returns (out [Tq, D], lse [Tq] or None)."""
    tq, d = q.shape
    tk = k.shape[0]
    p = plan(d, cons)
    bw, nb, rb, bk, bq, dn = (p["bw"], p["nb"], p["rb"], p["bk"], p["bq"],
                              p["dn"])
    stages = p["stages"]
    q_bytes, tile = bq * p["dks"] * 4, bk * p["dks"] * 4
    scaled = lse or bias is not None
    c2 = np.float32(LOG2E if scaled else scale * LOG2E)
    out = np.zeros((tq, d), np.float32)
    lse_out = np.zeros(tq, np.float32)
    srow, scol = c_layout(bk)
    orow, ocol = c_layout(dn)
    thread = np.arange(128)
    lane = thread % 32
    r_of_s = (np.arange(bk // 2) >> 1) & 1  # register -> its row (0 or 8)
    r_of_o = (np.arange(dn // 2) >> 1) & 1
    ntiles = -(-tk // bk)
    for qb in range(-(-tq // bq)):
        smem = np.zeros((q_bytes + 2 * stages * tile) // 4, np.float32)
        for j in range(nb):
            tma_box(smem, j * bq * rb, q, qb * bq, j * bw, bq, bw, rb)
        for cw in range(cons):  # each consumer rounds its own rows
            for j in range(nb):
                a = (j * bq * rb + cw * 64 * rb) // 4
                smem[a:a + 16 * rb] = tf32(smem[a:a + 16 * rb])
        images = []  # stage images as each tile's products read them
        for t in range(ntiles):
            st = t % stages
            kt = q_bytes + st * 2 * tile
            for j in range(nb):
                tma_box(smem, kt + j * bk * rb, k, t * bk, j * bw, bk, bw, rb)
                tma_box(smem, kt + tile + j * bk * rb, v, t * bk, j * bw, bk,
                        bw, rb)
            smem[kt // 4:(kt + tile) // 4] = tf32(smem[kt // 4:(kt + tile) // 4])
            transpose_v(smem, kt + tile, p)
            images.append(smem.copy())
        for cw in range(cons):
            o = np.zeros((128, dn // 2), np.float32)
            m = np.full((128, 2), -np.inf, np.float32)
            l = np.zeros((128, 2), np.float32)
            row0 = qb * bq + cw * 64
            for t in range(ntiles):
                img, kt = images[t], q_bytes + (t % stages) * 2 * tile
                smat = np.zeros((64, bk), np.float64)
                for ks in range(dn // 8):  # S = Q K^T, the real k8 steps
                    blk, off = ks * 8 // bw, (ks * 8 % bw) * 4
                    a = read_k_major(img, cw * 64 * rb + blk * bq * rb + off,
                                     64, 8 * rb, rb)
                    b = read_k_major(img, kt + blk * bk * rb + off, bk,
                                     8 * rb, rb)
                    smat += a.astype(np.float64) @ b.T.astype(np.float64)
                sc = smat.astype(np.float32)[srow, scol]
                key = t * bk + scol
                if scaled:
                    sc = (sc * np.float32(scale)).astype(np.float32)
                    if bias is not None:
                        rr = np.minimum(row0 + srow, tq - 1)
                        kk_ = np.minimum(key, tk - 1)
                        sc = (sc + bias[rr, kk_]).astype(np.float32)
                if mask:
                    sc = np.where(key >= tk, -np.inf, sc).astype(np.float32)
                mx = m.copy()
                for r in range(2):
                    mx[:, r] = np.maximum(mx[:, r], sc[:, r_of_s == r].max(1))
                mx = np.maximum(mx, mx[thread ^ 1])  # the quad: xor 1, xor 2
                mx = np.maximum(mx, mx[thread ^ 2])
                ms = np.where(mx == -np.inf, 0.0, mx).astype(np.float32)
                mc = (ms * c2).astype(np.float32)
                with np.errstate(invalid="ignore"):
                    if lse:
                        alpha = np.exp(m.astype(np.float64) - ms)
                        x = np.exp(sc.astype(np.float64) - ms[:, r_of_s])
                    else:
                        alpha = np.exp2(m.astype(np.float64) * c2 - mc)
                        x = np.exp2(sc.astype(np.float64) * c2
                                    - mc[:, r_of_s])
                alpha, x = alpha.astype(np.float32), x.astype(np.float32)
                m = mx
                rs = np.zeros((128, 2), np.float32)
                for i in range(bk // 2):
                    rs[:, r_of_s[i]] += x[:, i]
                l = (l * alpha + rs).astype(np.float32)
                o = (o * alpha[:, r_of_o]).astype(np.float32)
                pmat = a_matrix(hand_off(x))  # [64, BK], keys permuted
                vt = kt + tile
                bmat = np.concatenate([read_k_major(
                    img, vt + (kk // 4) * dn * 128 + (kk % 4) * 32, dn, 1024,
                    128).T for kk in range(bk // 8)])  # [BK, DN]
                o = (o + (pmat.astype(np.float64) @ bmat)[orow, ocol]
                     ).astype(np.float32)
            l = l + l[thread ^ 1]
            l = l + l[thread ^ 2]
            for r in range(2):
                rows = row0 + orow[:, r_of_o == r]
                cols = ocol[:, r_of_o == r]
                ok = (rows < tq) & (cols < d)
                vals = o[:, r_of_o == r] * (1.0 / l[:, r:r + 1])
                out[rows[ok], cols[ok]] = vals[ok]
                rr = row0 + 16 * (thread // 32) + lane // 4 + 8 * r
                keep = (rr < tq) & (lane % 4 == 0)
                lse_out[rr[keep]] = (m[keep, r]
                                     + np.log(np.maximum(l[keep, r], 1e-30)))
    return out, (lse_out if lse else None)


def _inputs(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32)
            for n in (tq, tk, tk)]


def _errors(got, q, k, v, bias=None, lse_got=None, scale=None):
    """(err, plain err) of out (and of the lse) against float64."""
    qt, kt, vt = (torch.from_numpy(x)[None, None] for x in (q, k, v))
    bt = None if bias is None else torch.from_numpy(bias)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    want, want_lse = attn.attention_reference_lse(
        qt.double(), kt.double(), vt.double(),
        None if bt is None else bt.double(), scale)
    plain, plain_lse = attn.attention_reference_tf32(qt, kt, vt, scale, bt,
                                                     return_lse=True)
    errs = [(np.abs(got - want[0, 0].numpy()).max(),
             (plain - want).abs().max().item())]
    if lse_got is not None:
        errs.append((np.abs(lse_got - want_lse[0, 0].numpy()).max(),
                     (plain_lse - want_lse).abs().max().item()))
    return errs


# ragged rows and keys at every launched head dim and both consumer
# regimes: a partial query block, a last key tile of 1 to BK - 1 keys, a
# single key tile
EMU_CASES = [(8, 1, 100, 130), (32, 3, 200, 65), (40, 1, 130, 257),
             (52, 3, 129, 194), (64, 1, 64, 64), (80, 2, 70, 97),
             (104, 1, 130, 33), (128, 2, 129, 100), (64, 3, 250, 70)]


@pytest.mark.parametrize("d,cons,tq,tk", EMU_CASES)
def test_emulated_kernel_matches_the_plain_version(d, cons, tq, tk):
    q, k, v = _inputs(d + tq, tq, tk, d)
    got, _ = emulate(q, k, v, d ** -0.5, cons)
    assert np.isfinite(got).all()
    [(err, plain_err)] = _errors(got, q, k, v)
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.parametrize("d,cons,tq,tk", [(40, 1, 130, 257),
                                          (104, 2, 129, 100)])
def test_last_tile_needs_its_minus_inf_mask(d, cons, tq, tk):
    # TMA fills keys past Tk with zeros: a zero logit, not -inf. Without
    # the mask the emulated kernel weighs them in
    q, k, v = _inputs(7, tq, tk, d)
    got, _ = emulate(q, k, v, d ** -0.5, cons, mask=False)
    [(err, plain_err)] = _errors(got, q, k, v)
    assert err > 5 * plain_err


@pytest.mark.parametrize("d,cons,tq,tk,biased", [
    (52, 3, 129, 130, True), (52, 1, 70, 200, True), (32, 1, 150, 300, False),
    (128, 2, 129, 257, False), (8, 1, 100, 100, True)])
def test_emulated_lse_and_bias_match_the_plain_version(d, cons, tq, tk,
                                                       biased):
    # the lse launch: scaled (and biased) logits, the accurate exp, m +
    # log(max(l, 1e-30)); held like the out to 1.5x the plain version's
    q, k, v = _inputs(d * 3 + tk, tq, tk, d)
    bias = (np.random.default_rng(d).standard_normal((tq, tk))
            .astype(np.float32) if biased else None)
    got, lse = emulate(q, k, v, d ** -0.5, cons, bias=bias, lse=True)
    for err, plain_err in _errors(got, q, k, v, bias, lse):
        assert err <= 1.5 * plain_err, (err, plain_err)


def test_emulated_bias_without_lse_matches_the_plain_version():
    # a biased inference launch: scaled and biased logits, exp2 of one FFMA
    q, k, v = _inputs(3, 100, 140, 40)
    bias = np.random.default_rng(4).standard_normal((100, 140)).astype(
        np.float32)
    got, _ = emulate(q, k, v, 40 ** -0.5, 1, bias=bias)
    [(err, plain_err)] = _errors(got, q, k, v, bias)
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_emulated_multi_query_with_each_bias_slice(mode):
    # q [B, H], k/v [B, 1] (every head reads batch row b's k/v, a head
    # extent of 1), the bias's slice by mode: 1 one slice, 2 one a head, 3
    # one a (b, h) (`bias_slice`)
    b, h, tq, tk, d = 2, 3, 70, 90, 52
    rng = np.random.default_rng(mode)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, 1, tk, d)).astype(np.float32)
            for _ in range(2))
    slices = {1: 1, 2: h, 3: b * h}[mode]
    bias = rng.standard_normal((slices, tq, tk)).astype(np.float32)
    got = np.zeros_like(q)
    lse = np.zeros((b, h, tq), np.float32)
    for bh in range(b * h):
        s = 0 if mode == 1 else bh % h if mode == 2 else bh
        o, ls = emulate(q[bh // h, bh % h], k[bh // h, 0], v[bh // h, 0],
                        d ** -0.5, 1, bias=bias[s], lse=True)
        got[bh // h, bh % h], lse[bh // h, bh % h] = o, ls
    full = bias.reshape({1: (tq, tk), 2: (h, tq, tk), 3: (b, h, tq, tk)}[mode])
    bt = torch.from_numpy(np.ascontiguousarray(full))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    want, want_lse = attn.attention_reference_lse(
        qt.double(), kt.double(), vt.double(), bt.double(), d ** -0.5)
    plain, plain_lse = attn.attention_reference_tf32(qt, kt, vt, d ** -0.5,
                                                     bt, return_lse=True)
    for x, px, w in ((got, plain, want), (lse, plain_lse, want_lse)):
        err = np.abs(x - w.numpy()).max()
        assert err <= 1.5 * (px.double() - w).abs().max().item(), err


# ---------------------------------------------------------------------------
# the mbarrier ring: full (the copies landed), ready (K rounded, V^T
# written), empty (the consumers are done with the stage)

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
    """Random interleavings of the producer (thread 0 issues tiles 0 ..
    S - 1, then, after each tile's pass, tile t - 1 + S once tile t - 1's
    stage is empty; the warpgroup's pass of tile t after its full barrier:
    the rounding and the transpose, then 128 arrivals on ready) and `cons`
    consumers (tile t after ready, releasing the stage on empty), with TMA
    copies that land at random later steps. Asserts that no pass reads a
    tile before it landed, no consumer reads one before its pass, and no
    copy lands in a stage a pass or a consumer still reads."""
    rnd = random.Random(seed)
    full = [MBarrier(1) for _ in range(stages)]
    ready = [MBarrier(128) for _ in range(stages)]
    empty = [MBarrier(cons) for _ in range(stages)]
    data = [None] * stages       # the tile a stage holds
    passed = [None] * stages     # the tile whose pass wrote the stage
    busy = [set() for _ in range(stages)]
    in_flight = []

    def load(t):
        s = t % stages
        full[s].arrive(expect_tx=1)
        in_flight.append((s, t))

    def producer():
        for t in range(min(stages, ntiles)):
            load(t)
            yield
        for t in range(ntiles):
            s, parity = t % stages, (t // stages) & 1
            while not full[s].try_wait(parity):
                yield
            assert data[s] == t, "a pass read a tile before it landed"
            busy[s].add("pass")
            yield  # the rounding and the transpose
            passed[s] = t
            busy[s].discard("pass")
            for _ in range(128):
                ready[s].arrive()
            if t >= 1 and t - 1 + stages < ntiles:
                sp, pp = (t - 1) % stages, ((t - 1) // stages) & 1
                while not empty[sp].try_wait(pp):
                    yield
                load(t - 1 + stages)
            yield

    def consumer(cw):
        for t in range(ntiles):
            s, parity = t % stages, (t // stages) & 1
            while not ready[s].try_wait(parity):
                yield
            assert passed[s] == t, "a product read a tile before its pass"
            busy[s].add(cw)
            yield  # S, the softmax, P V
            busy[s].discard(cw)
            empty[s].arrive()
            yield

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                s, t = in_flight.pop(rnd.randrange(len(in_flight)))
                assert not busy[s], "a copy landed in a stage in use"
                data[s] = t
                full[s].complete_tx(1)
            yield

    parties = [producer()] + [consumer(c) for c in range(cons)]
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


@pytest.mark.parametrize("stages,cons", [(2, 1), (3, 1), (3, 2), (3, 3)])
@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 9])
def test_mbarrier_ring_walk(ntiles, stages, cons):
    for seed in range(20):
        assert ring_walk(ntiles, stages, cons, seed) > 0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dims_and_routes(d):
    # every launched head dim (and every multiple of 4 from 8 to 128) on 16-
    # byte rows takes the TF32 wgmma kernel; off them, at d 4 and past 128
    # it does not
    assert attn.flash_route(d, torch.float32) == attn.TF32_WGMMA_ROUTE
    assert attn.flash_route(d, torch.float32, biased=True, lse=True,
                            head_bias=True, tk=514) == attn.TF32_WGMMA_ROUTE
    assert attn.tf32_wgmma_dn(d) == -(-d // 8) * 8
    for other in (4, 6, 42, 132, 512):
        assert attn.tf32_wgmma_dn(other) == 0


def _ptxas(dn, cons, registers, spill=0):
    """One -Xptxas -v entry of a TF32 wgmma instance (the mangled name
    nvcc gives a kernel in an anonymous namespace)."""
    return dict(source="flash_attn_fwd_tf32_sm90", function=(
        f"_ZN60_GLOBAL__N__d3af4dca_27_flash_attn_fwd_tf32_sm90_cu_3903ae6b27"
        f"flash_fwd_tf32_wgmma_kernelILi{dn}ELi{cons}EEEv14CUtensorMap_stS1_"
        f"S1_NS_10Tf32ParamsE"), registers=registers, spill_stores=spill,
        spill_loads=spill)


def test_chip_smoke_gates_the_instances():
    # chip_smoke.py reads the 32 instances (DN 8 .. 128; one consumer, and
    # three up to DN 64, two past it) and raises on a missing one, a spill
    # or a serialized product (C751x in the build log)
    ptxas = [_ptxas(dn, c, 120 + dn // 8) for dn in range(8, 129, 8)
             for c in (1, attn.tf32_wgmma_many(dn))]
    ptxas.append(dict(source="flash_attn_fwd", registers=150, function=(
        "_ZN50_GLOBAL__N__0_flash_attn_fwd_cu21flash_fwd_tf32_kernelILi64E"
        "Lb0ELb0EEEvNS_6ParamsE")))
    got = chip_smoke.tf32_wgmma_instances(ptxas, build_log="")
    assert len(got) == 32 and {i["cons"] for i in got} == {1, 2, 3}
    with pytest.raises(AssertionError):  # an instance is missing
        chip_smoke.tf32_wgmma_instances(ptxas[1:], build_log="")
    with pytest.raises(AssertionError):  # an instance spills
        chip_smoke.tf32_wgmma_instances(
            ptxas[:31] + [_ptxas(128, 2, 168, 8)], build_log="")
    serialized = ("ptxas warning : (C7513) Potential Performance Loss: "
                  "wgmma.mma_async instructions are serialized")
    with pytest.raises(AssertionError):
        chip_smoke.tf32_wgmma_instances(ptxas, build_log=serialized)


# ---------------------------------------------------------------------------
# the port's f32 forward against the JAX package's (the Pallas kernels in
# interpret mode, whole-KV regime; #3 with a bias and the lse over
# multi-query k/v, as the prior calls it)

def _qkv(seed, b, h, tq, tk, d, hkv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, tq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32))


@pytest.mark.parametrize("d,b,h,hkv,tq,tk,biased", [
    (40, 1, 2, 2, 130, 140, False),
    (52, 2, 4, 1, 129, 130, True),
    (104, 1, 2, 2, 128, 150, False),
])
def test_port_f32_forward_matches_the_jax_kernels(d, b, h, hkv, tq, tk,
                                                  biased):
    q, k, v = _qkv(d, b, h, tq, tk, d, hkv)
    bias = (np.random.default_rng(d + 1).standard_normal((h, tq, tk),
                                                         dtype=np.float32)
            if biased else None)
    ref, ref_lse = jattn._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), interpret=True,
        return_lse=True)
    got, lse = attn.flash_attention_fwd(
        t(q), t(k), t(v), bias=None if bias is None else t(bias),
        return_lse=True)
    assert got.shape == ref.shape and lse.shape == ref_lse.shape
    assert rel_err(got, ref) <= 1e-4
    assert rel_err(lse, ref_lse) <= 2e-4
