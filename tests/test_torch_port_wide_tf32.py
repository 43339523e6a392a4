"""The flash kernels' f32 route past d 128 (csrc/flash_attn_fwd.cu:
flash_fwd_wide_tf32_kernel; csrc/flash_attn_bwd.cu:
flash_bwd_dkdv_wide_tf32_kernel, flash_bwd_dq_wide_tf32_kernel), on the
CPU: the plain versions at its head dims against the JAX package's Pallas
kernels in interpret mode, and a float64 emulation of the kernels' fragment
maps and split sums, which must give the plain products.

The kernels split D by columns across 8 warps (64 columns a warp): each
warp multiplies its columns' share of S = Q K^T (and, in the backward, of
dP), the shares are summed in warp order, and each warp adds its columns of
O = P V (dK, dV, dQ). The emulations below take the mma.m16n8k8 TF32
fragment layouts lane by lane: lane (g, t) = (lane // 4, lane % 4) holds
A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0, c1 (g, 2t,
2t + 1), c2, c3 (g + 8, 2t, 2t + 1). ldmatrix .x4 of 8 x 8 b16 matrices
reads 8 rows x 4 floats each: lane 8 m + i gives row i of matrix m, and
lane l receives element (l // 4, l % 4) of every matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.ops import attention as jattn
from neurons_tpu_torch.ops import attention as tattn
from torch_port_utils import rel_err, t

TF32_TOL = 2.0 ** -8  # TF32 keeps 10 mantissa bits
WARPS, COLS = 8, 64   # warps a block, columns of D a warp
LD = 512 + 4          # a ring tile's row stride in floats
LDS = 16 + 8          # the partials' and P's row stride


def _qkv(seed, b, h, tq, tk, d, hkv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, tq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32))


# the plain version at the route's head dims (ragged 136, 256, 512) and
# ragged rows, one head per k/v row and multi-query, with its lse, against
# the Pallas forward in interpret mode
@pytest.mark.parametrize("hkv", [2, 1], ids=["heads", "multi_query"])
@pytest.mark.parametrize("d", [136, 256, 512])
def test_attention_reference_tf32_lse_matches_jax_past_d128(d, hkv):
    q, k, v = _qkv(d + hkv, 1, 2, 130, 140, d, hkv)
    ref, ref_lse = jattn._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        return_lse=True)
    assert ref_lse is not None  # the kernel path, not the XLA fallback
    got, lse = tattn.attention_reference_tf32(t(q), t(k), t(v),
                                              return_lse=True)
    assert got.shape == ref.shape and lse.shape == ref_lse.shape
    assert rel_err(got, ref) <= TF32_TOL
    assert rel_err(lse, ref_lse) <= TF32_TOL


# --------------------------------------------------- fragment emulation ----

def _mma(a_regs, b_regs):
    """One mma.m16n8k8 from 32 lanes' registers, summed in float64."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane in range(32):
        g, tl = divmod(lane, 4)
        a[g, tl], a[g + 8, tl], a[g, tl + 4], a[g + 8, tl + 4] = a_regs[lane]
        b[tl, g], b[tl + 4, g] = b_regs[lane]
    return a @ b


def _a_held(tile, r0, col0, ks):
    """A fragments of rows r0.. and columns col0 + 8 ks.. of a [rows, LD]
    tile, read as the kernels hold them (Q, or K and V in pass 1)."""
    regs = []
    for lane in range(32):
        g, tl = divmod(lane, 4)
        x = (r0 + g) * LD + col0 + 8 * ks + tl
        regs.append((tile[x], tile[x + 8 * LD], tile[x + 4],
                     tile[x + 8 * LD + 4]))
    return regs


def _ldmatrix_b(tile, n0, col0, ks):
    """B fragments of two k8 steps (ks, ks + 1) over rows n0 .. n0 + 7 of a
    [rows, LD] tile, by one ldmatrix .x4: lane l's row address is row n0 +
    l % 8, column col0 + 8 ks + (l // 16) 8 + ((l // 8) % 2) 4."""
    addr = [(n0 + (lane & 7)) * LD + col0 + 8 * ks + (lane >> 4) * 8
            + ((lane >> 3) & 1) * 4 for lane in range(32)]
    regs = []
    for lane in range(32):
        i, e = divmod(lane, 4)
        regs.append([tile[addr[8 * m + i] + e] for m in range(4)])
    return [(r[0], r[1]) for r in regs], [(r[2], r[3]) for r in regs]


def _partial_scores(a_tile, b_tile, rows, warp):
    """One warp's [rows x 16] share of A B^T over its 64 columns (A held,
    rows // 16 m16 tiles; B by ldmatrix, 2 n8 tiles), written as the
    kernels write it: each lane's C registers as float2 pairs at (g, 8 j +
    2 t) and (g + 8, ..) of a [rows][LDS] buffer (returned flat)."""
    col0 = warp * COLS
    part = np.zeros(rows * LDS)
    for mi in range(rows // 16):
        for j in range(2):
            c = np.zeros((16, 8))
            for ks in range(0, 8, 2):
                b0, b1 = _ldmatrix_b(b_tile, 8 * j, col0, ks)
                c += _mma(_a_held(a_tile, 16 * mi, col0, ks), b0)
                c += _mma(_a_held(a_tile, 16 * mi, col0, ks + 1), b1)
            for lane in range(32):
                g, tl = divmod(lane, 4)
                at = (16 * mi + g) * LDS + 8 * j + 2 * tl
                part[at:at + 2] = c[g, 2 * tl:2 * tl + 2]
                at8 = at + 8 * LDS
                part[at8:at8 + 2] = c[g + 8, 2 * tl:2 * tl + 2]
    return part


def _product_cols(a16, b_tile, rows, warp, mismatch=False):
    """One warp's [rows x 64] columns of A B: A [rows x 16] read from a
    [rows][LDS] tile as (columns 2t, 2t + 1) pairs into A's k indices t
    and t + 4, B's rows 2t and 2t + 1 of a [16, LD] tile at column col0 +
    8 n + g. `mismatch`: A's columns t and t + 4 instead, against the same
    B rows (a pairing the kernels must not make)."""
    col0 = warp * COLS
    out = np.zeros((rows, COLS))
    for mi in range(rows // 16):
        for j in range(2):
            a_regs, b_rows = [], []
            for lane in range(32):
                g, tl = divmod(lane, 4)
                r = 16 * mi + g
                k0, k1 = 8 * j + 2 * tl, 8 * j + 2 * tl + 1
                a0, a1 = (8 * j + tl, 8 * j + tl + 4) if mismatch else (k0, k1)
                a_regs.append((a16[r, a0], a16[r + 8, a0], a16[r, a1],
                               a16[r + 8, a1]))
                b_rows.append((k0, k1))
            for n in range(8):
                b_regs = [(b_tile[k0 * LD + col0 + 8 * n + lane // 4],
                           b_tile[k1 * LD + col0 + 8 * n + lane // 4])
                          for lane, (k0, k1) in enumerate(b_rows)]
                out[16 * mi:16 * mi + 16, 8 * n:8 * n + 8] += _mma(a_regs,
                                                                    b_regs)
    return out


def _tf32(x):
    return tattn.round_to_tf32(torch.from_numpy(
        np.asarray(x, np.float32))).double().numpy()


def _tile(rows, d, seed):
    """A [rows, LD] ring tile (flattened), D columns of TF32 values, zero
    past D as the kernels stage it."""
    rng = np.random.default_rng(seed)
    tile = np.zeros((rows, LD))
    tile[:, :d] = _tf32(rng.standard_normal((rows, d)))
    return tile.reshape(-1), tile[:, :d]


@pytest.mark.parametrize("d", [136, 512])
@pytest.mark.parametrize("rows", [32, 16], ids=["forward", "backward"])
def test_depth_split_scores_are_the_plain_product(rows, d):
    # S = Q K^T (the forward: 32 rows of Q held; the backward: 16 rows of K
    # or Q held, the other by ldmatrix): each warp's share of its 64
    # columns written to its partial buffer, then each reduction thread's
    # elements summed over the warps that hold D in warp order
    a_tile, a = _tile(rows, d, d + rows)
    b_tile, b = _tile(16, d, 2 * d + rows)
    nw = -(-d // COLS)
    parts = [_partial_scores(a_tile, b_tile, rows, w) for w in range(nw)]
    s = np.full((rows, 16), np.nan)
    for tid in range(256):
        if rows == 32:  # the forward's softmax threads: two keys each
            r, c = _fwd_reduce_map(tid)
            cols = (c, c + 1)
        else:
            r, c = _bwd_reduce_map(tid)
            cols = (c,)
        for cc in cols:
            x = parts[0][r * LDS + cc]
            for w in range(1, nw):
                x = x + parts[w][r * LDS + cc]
            s[r, cc] = x
    want = a @ b.T
    assert np.abs(s - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("d", [136, 512])
@pytest.mark.parametrize("rows", [32, 16], ids=["forward", "backward"])
def test_column_split_products_are_the_plain_product(rows, d):
    # O += P V (the forward, 32 rows), dV += P^T g, dK += dS^T Q, dQ += dS K
    # (the backward, 16 rows): each warp its 64 columns, P from shared
    # memory in (2t, 2t + 1) pairs, B rows 2t and 2t + 1
    rng = np.random.default_rng(rows + d)
    p16 = _tf32(np.exp(rng.standard_normal((rows, 16))))
    b_tile, b = _tile(16, d, 3 * d + rows)
    got = np.concatenate([_product_cols(p16, b_tile, rows, w)
                          for w in range(WARPS)], axis=1)[:, :d]
    want = p16 @ b
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # A's columns t and t + 4 against B's rows 2t and 2t + 1 pair the
    # wrong keys
    wrong = _product_cols(p16, b_tile, rows, 0, mismatch=True)
    assert np.abs(wrong - want[:, :COLS]).max() > 1e-3 * np.abs(want).max()


# -------------------------------------------- the reductions' thread maps ----

def _fwd_reduce_map(tid):
    """The forward's softmax thread: (row, first key) of a [32 x 16] tile."""
    warp, lane = divmod(tid, 32)
    return 4 * warp + ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1), 2 * (lane & 7)


def _bwd_reduce_map(tid):
    """The backward's reduction thread: (row, column) of a [16 x 16] block."""
    warp, lane = divmod(tid, 32)
    return 4 * (warp >> 1) + (warp & 1) + 2 * ((lane >> 4) & 1), lane & 15


def test_reduction_maps_cover_each_element_once_without_bank_conflicts():
    fwd = [_fwd_reduce_map(i) for i in range(256)]
    assert sorted(fwd) == [(r, c) for r in range(32) for c in range(0, 16, 2)]
    bwd = [_bwd_reduce_map(i) for i in range(256)]
    assert sorted(bwd) == [(r, c) for r in range(16) for c in range(16)]
    for w in range(8):
        # a row's 8 lanes are lanes 8 m .. 8 m + 7 (the shuffles xor 1, 2
        # and 4 stay among them), and each half-warp's float2 reads of the
        # partials (row stride LDS) cover 32 distinct banks
        lanes = [(lane, *_fwd_reduce_map(32 * w + lane)) for lane in range(32)]
        for lane, r, _ in lanes:
            m = lane >> 3
            assert sorted(ln for ln, rr, _ in lanes if rr == r) == \
                list(range(8 * m, 8 * m + 8))
        for half in range(2):
            banks = [(r * LDS + c + e) % 32 for ln, r, c in lanes
                     if ln >> 4 == half for e in range(2)]
            assert sorted(banks) == list(range(32))
        # the backward's 32-bit reads: one pass a warp
        banks = [(r * LDS + c) % 32 for r, c in
                 (_bwd_reduce_map(32 * w + lane) for lane in range(32))]
        assert sorted(banks) == list(range(32))


# ------------------------------------------ the kernels' whole algorithm ----

def _wide_forward_emulated(q, k, v, scale, bias=None):
    """The forward kernel's algorithm in float64 without rounding: blocks of
    32 query rows, key tiles of 16, S from the warps' 64-column shares
    summed in warp order, the online softmax with the running max (0 while
    a row has no finite logit), rescale and P V; one [Tq, D] head."""
    tq, d = q.shape
    tk = k.shape[0]
    nw = -(-d // COLS)
    out = np.zeros((tq, d))
    lse = np.zeros(tq)
    for q0 in range(0, tq, 32):
        qb = np.zeros((32, d))
        qb[:min(32, tq - q0)] = q[q0:q0 + 32]
        o = np.zeros((32, d))
        m = np.full(32, -np.inf)
        ell = np.zeros(32)
        for k0 in range(0, tk, 16):
            kb, vb = np.zeros((16, d)), np.zeros((16, d))
            kb[:min(16, tk - k0)] = k[k0:k0 + 16]
            vb[:min(16, tk - k0)] = v[k0:k0 + 16]
            s = sum(qb[:, w * COLS:(w + 1) * COLS]
                    @ kb[:, w * COLS:(w + 1) * COLS].T for w in range(nw))
            s = s * scale
            if bias is not None:
                bb = np.zeros((32, 16))
                bb[:min(32, tq - q0), :min(16, tk - k0)] = \
                    bias[q0:q0 + 32, k0:k0 + 16]
                s = s + bb
            s[:, max(0, tk - k0):] = -np.inf
            mn = np.maximum(m, s.max(1))
            msafe = np.where(mn == -np.inf, 0.0, mn)
            alpha = np.exp(m - msafe)
            p = np.exp(s - msafe[:, None])
            ell = ell * alpha + p.sum(1)
            m = mn
            o = o * alpha[:, None] + p @ vb
        n = min(32, tq - q0)
        out[q0:q0 + n] = (o / ell[:, None])[:n]
        lse[q0:q0 + n] = (m + np.log(np.maximum(ell, 1e-30)))[:n]
    return out, lse


@pytest.mark.parametrize("tq,tk,d", [(40, 37, 136), (33, 50, 512),
                                     (70, 17, 200)])
def test_wide_forward_algorithm_is_softmax_attention(tq, tk, d):
    # ragged rows (a block with one valid row, a tile with one key), a bias
    # of -inf over a whole key tile (the running max stays -inf there)
    rng = np.random.default_rng(tq + tk + d)
    q, k, v = (rng.standard_normal(s) for s in ((tq, d), (tk, d), (tk, d)))
    bias = rng.standard_normal((tq, tk))
    bias[:, :16] = -np.inf
    scale = d ** -0.5
    got, lse = _wide_forward_emulated(q, k, v, scale, bias)
    logits = q @ k.T * scale + bias
    want_lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
        + logits.max(1)
    p = np.exp(logits - want_lse[:, None])
    assert np.abs(got - p @ v).max() <= 1e-12 * np.abs(p @ v).max()
    assert np.abs(lse - want_lse).max() <= 1e-12 * np.abs(want_lse).max()


def _wide_backward_emulated(q, k, v, g, out, lse, scale):
    """The two passes' algorithm in float64 without rounding: pass 1 over
    blocks of 16 keys and tiles of 16 queries, pass 2 over blocks of 16
    queries and tiles of 16 keys; S and dP from the warps' 64-column
    shares summed in warp order; zero past Tq and Tk."""
    tq, d = q.shape
    tk = k.shape[0]
    nw = -(-d // COLS)
    delta = (g * out).sum(1)

    def pad(x, r0, n):
        y = np.zeros((16, d))
        y[:max(0, min(16, n - r0))] = x[r0:r0 + 16]
        return y

    def split(a, b):
        return sum(a[:, w * COLS:(w + 1) * COLS]
                   @ b[:, w * COLS:(w + 1) * COLS].T for w in range(nw))

    dk, dv, dq = np.zeros((tk, d)), np.zeros((tk, d)), np.zeros((tq, d))
    for k0 in range(0, tk, 16):
        kb, vb = pad(k, k0, tk), pad(v, k0, tk)
        acc_k, acc_v = np.zeros((16, d)), np.zeros((16, d))
        for q0 in range(0, tq, 16):
            qb, gb = pad(q, q0, tq), pad(g, q0, tq)
            ok = (np.arange(16)[:, None] + k0 < tk) & \
                (np.arange(16)[None, :] + q0 < tq)
            ls, dl = np.zeros(16), np.zeros(16)
            n = max(0, min(16, tq - q0))
            ls[:n], dl[:n] = lse[q0:q0 + n], delta[q0:q0 + n]
            pt = np.where(ok, np.exp(split(kb, qb) * scale - ls), 0.0)
            dst = pt * (split(vb, gb) - dl) * scale
            acc_v += pt @ gb
            acc_k += dst @ qb
        n = min(16, tk - k0)
        dk[k0:k0 + n], dv[k0:k0 + n] = acc_k[:n], acc_v[:n]
    for q0 in range(0, tq, 16):
        qb, gb = pad(q, q0, tq), pad(g, q0, tq)
        ls, dl = np.zeros(16), np.zeros(16)
        n = min(16, tq - q0)
        ls[:n], dl[:n] = lse[q0:q0 + n], delta[q0:q0 + n]
        acc = np.zeros((16, d))
        for k0 in range(0, tk, 16):
            kb, vb = pad(k, k0, tk), pad(v, k0, tk)
            ok = (np.arange(16)[:, None] + q0 < tq) & \
                (np.arange(16)[None, :] + k0 < tk)
            p = np.where(ok, np.exp(split(qb, kb) * scale - ls[:, None]), 0.0)
            acc += (p * (split(gb, vb) - dl[:, None]) * scale) @ kb
        dq[q0:q0 + n] = acc[:n]
    return dq, dk, dv


@pytest.mark.parametrize("tq,tk,d", [(40, 37, 136), (17, 33, 512)])
def test_wide_backward_algorithm_is_the_plain_gradient(tq, tk, d):
    rng = np.random.default_rng(tq * tk + d)
    q, k, v, g = (rng.standard_normal(s)
                  for s in ((tq, d), (tk, d), (tk, d), (tq, d)))
    scale = d ** -0.5
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    out, lse = tattn.attention_reference_lse(tq_, tk_, torch.from_numpy(v),
                                             scale=scale)
    got = _wide_backward_emulated(q, k, v, g, out.numpy(), lse.numpy(), scale)
    want = tattn.flash_attention_bwd_reference(
        tq_, tk_, torch.from_numpy(v), None, torch.from_numpy(g), out, lse,
        scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = w.numpy()
        assert np.abs(a - w).max() <= 1e-12 * np.abs(w).max(), name
