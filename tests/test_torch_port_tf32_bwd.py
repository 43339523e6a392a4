"""The flash backward's f32 route up to d 128 (csrc/flash_attn_bwd.cu:
flash_bwd_dkdv_tf32_kernel, flash_bwd_dq_tf32_kernel,
flash_bwd_dbias_tf32_kernel), on the CPU: a float64 emulation of the
kernels' fragment reads, their C -> A permutation and their tiles, which
must give the plain gradients.

The kernels are the bf16 register design on mma.m16n8k8 with TF32
operands: blocks of 64 keys (pass 1) or 64 queries (passes 2 and 3), 4
warps of 16 rows, 32 columns of S at a time. Lane (g, t) = (lane // 4,
lane % 4) holds A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
(g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0,
c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1). ldmatrix .x4 of 8 x 8 b16
matrices reads 8 rows x 4 floats each: lane 8 m + i gives row i of matrix
m, and lane l receives element (l // 4, l % 4) of every matrix. Tiles are
[rows][D + 4] floats, D padded to 32, 64 or 128.
"""

import numpy as np
import pytest
import torch

from neurons_tpu_torch.ops import attention as tattn

LANES = np.arange(32)
G, TL = LANES // 4, LANES % 4
RB, RC = 64, 32  # rows a block, columns of S a warp takes at a time


def _dk(d):
    return 32 if d <= 32 else 64 if d <= 64 else 128


# ------------------------------------------------------ fragment reads ----

def _a_offsets(ld):
    """ldmatrix A fragment: lane l's row address (floats) in a [rows][ld]
    tile, rows 0-7 and 8-15 of columns 0-3, then of columns 4-7."""
    return ((LANES & 7) + ((LANES >> 3) & 1) * 8) * ld + (LANES >> 4) * 4


def _nt_offsets(ld):
    """ldmatrix B fragments of two k8 steps of one n8 tile from [n][k]
    rows: columns 0-3, 4-7, 8-11, 12-15 of 8 rows."""
    return (LANES & 7) * ld + (LANES >> 4) * 8 + ((LANES >> 3) & 1) * 4


def _kt_offsets(ld):
    """A k-major B element: row 2t, column g (b1 the row after)."""
    return 2 * TL * ld + G


def _ldmatrix_x4(tile, addr):
    """[32 lanes, 4 registers]: register m of lane l is element (l // 4,
    l % 4) of matrix m, whose row i lane 8 m + i addresses."""
    return np.stack([tile[addr[8 * m + G] + TL] for m in range(4)], axis=1)


def _ldmatrix_elements(addr):
    """The float offsets an ldmatrix x4 reads, [4 matrices, 32 elements]."""
    return np.stack([addr[8 * m + G] + TL for m in range(4)])


def _mma(c, a, b):
    """c += a b on fragments: c [32, 4], a [32, 4], b [32, 2], float64."""
    am = np.zeros((16, 8))
    am[G, TL], am[G + 8, TL], am[G, TL + 4], am[G + 8, TL + 4] = a.T
    bm = np.zeros((8, 8))
    bm[TL, G], bm[TL + 4, G] = b.T
    cm = am @ bm
    return c + np.stack([cm[G, 2 * TL], cm[G, 2 * TL + 1],
                         cm[G + 8, 2 * TL], cm[G + 8, 2 * TL + 1]], axis=1)


def _c_matrix(c):
    m = np.zeros((16, 8))
    m[G, 2 * TL], m[G, 2 * TL + 1] = c[:, 0], c[:, 1]
    m[G + 8, 2 * TL], m[G + 8, 2 * TL + 1] = c[:, 2], c[:, 3]
    return m


def _c_to_a(c):
    """c_to_a_tf32 without the rounding: a = (c0, c2, c1, c3)."""
    return c[:, [0, 2, 1, 3]]


def _two_scores(tile_a, a_addr, tile_b, b_addr, ld, dk, kd8):
    """two_scores_tf32 for one of its products: [RC / 8 n8 tiles, 32, 4]
    C fragments of A B^T over the first kd8 k8 steps (A the 16 rows at
    a_addr, an ldmatrix A fragment a step; B RC rows at b_addr, ldmatrix
    x4 of two steps)."""
    c = np.zeros((RC // 8, 32, 4))
    for ks in range(0, dk // 8, 2):
        if ks >= kd8:
            continue
        x0 = _ldmatrix_x4(tile_a, a_addr + ks * 8)
        x1 = _ldmatrix_x4(tile_a, a_addr + ks * 8 + 8)
        for j in range(RC // 8):
            r = _ldmatrix_x4(tile_b, b_addr + j * 8 * ld + ks * 8)
            c[j] = _mma(c[j], x0, r[:, :2])
            if ks + 1 < kd8:
                c[j] = _mma(c[j], x1, r[:, 2:])
    return c


def _product_d(acc, a, tile_b, b_addr, ld, nv8):
    """product_d_tf32: acc [n8 tiles, 32, 4] += A B over the first nv8 n8
    tiles; A [RC / 8, 32, 4] fragments, B rows 8j + 2t and 8j + 2t + 1 of
    a [k][n] tile at column 8n + g (b_addr: this lane's row 2t, column
    g)."""
    for j in range(RC // 8):
        for n in range(nv8):
            at = b_addr + j * 8 * ld + n * 8
            b = np.stack([tile_b[at], tile_b[at + ld]], axis=1)
            acc[n] = _mma(acc[n], a[j], b)
    return acc


def test_c_to_a_permutation_pairs_columns_2t_with_rows_2t():
    # P (a C fragment, 16 x 8) times a [8][n] tile: a = (c0, c2, c1, c3)
    # against B rows 2t and 2t + 1 is P B; against rows t and t + 4 (B's
    # own layout) it pairs the wrong columns
    rng = np.random.default_rng(0)
    c = rng.standard_normal((32, 4))
    ld = 36
    tile = rng.standard_normal(8 * ld)
    want = _c_matrix(c) @ tile.reshape(8, ld)[:, :8]
    kt = _kt_offsets(ld)
    b = np.stack([tile[kt], tile[kt + ld]], axis=1)
    got = _c_matrix(_mma(np.zeros((32, 4)), _c_to_a(c), b))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    own = np.stack([tile[TL * ld + G], tile[(TL + 4) * ld + G]], axis=1)
    wrong = _c_matrix(_mma(np.zeros((32, 4)), _c_to_a(c), own))
    assert np.abs(wrong - want).max() > 1e-3 * np.abs(want).max()
    # C straight into A (no permutation) is wrong with either B
    direct = _c_matrix(_mma(np.zeros((32, 4)), c, b))
    assert np.abs(direct - want).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("dk", [32, 64, 128])
def test_fragment_reads_cover_each_element_once_in_distinct_banks(dk):
    ld = dk + 4
    # k-major B (g, Q in pass 1; K in pass 2): b0 and b1 of every (k8
    # step j, n8 tile n) read rows 8j + 2t, + 1 at column 8n + g: each
    # (k, n) of the 8 x 8 block once, each read 32 distinct banks
    kt = _kt_offsets(ld)
    for j in range(RC // 8):
        for n in range(dk // 8):
            at = kt + j * 8 * ld + n * 8
            cells = [divmod(int(x), ld) for x in np.concatenate([at, at + ld])]
            assert sorted(cells) == [(8 * j + r, 8 * n + c)
                                     for r in range(8) for c in range(8)]
            for x in (at, at + ld):
                assert sorted(x % 32) == list(range(32))
    # the ldmatrix reads (A fragments; n-major B): each 8-row phase
    # covers 32 distinct banks, each fragment the 16 x 8 (8 x 16) block
    for addr, rows, cols in ((_a_offsets(ld), 16, 8), (_nt_offsets(ld), 8, 16)):
        el = _ldmatrix_elements(addr)
        for m in range(4):
            assert sorted(el[m] % 32) == list(range(32))
        cells = sorted(divmod(int(x), ld) for x in el.reshape(-1))
        assert cells == [(r, c) for r in range(rows) for c in range(cols)]
    # A skew of 8 floats conflicts on the k-major reads
    at = 2 * TL * (dk + 8) + G
    assert len(set(at % 32)) < 32


@pytest.mark.parametrize("dk", [32, 64, 128])
def test_ldmatrix_fragments_are_the_mma_layouts(dk):
    ld = dk + 4
    rng = np.random.default_rng(dk)
    tile = rng.standard_normal(16 * ld)
    m = tile.reshape(16, ld)
    a = _ldmatrix_x4(tile, _a_offsets(ld) + 8)  # the k8 step at column 8
    assert np.array_equal(a[:, 0], m[G, 8 + TL])
    assert np.array_equal(a[:, 1], m[G + 8, 8 + TL])
    assert np.array_equal(a[:, 2], m[G, 12 + TL])
    assert np.array_equal(a[:, 3], m[G + 8, 12 + TL])
    b = _ldmatrix_x4(tile, _nt_offsets(ld) + 8 * ld + 16)  # n rows 8..15
    for step in range(2):  # B[k][n] = tile[n][k]: b0 (t, g), b1 (t + 4, g)
        assert np.array_equal(b[:, 2 * step], m[8 + G, 16 + 8 * step + TL])
        assert np.array_equal(b[:, 2 * step + 1],
                              m[8 + G, 16 + 8 * step + TL + 4])


# ------------------------------------------------ the passes' algorithm ----

def _staged(x, r0, n, d, dk):
    """A [64][dk + 4] tile of rows r0.. of x ([n, d]), zero past n and d,
    flattened."""
    tile = np.zeros((RB, dk + 4))
    rows = max(0, min(RB, n - r0))
    tile[:rows, :d] = x[r0:r0 + rows]
    return tile.reshape(-1)


def _rows(x, r0, n):
    out = np.zeros(RB)
    rows = max(0, min(RB, n - r0))
    out[:rows] = x[r0:r0 + rows]
    return out


def _bias_block(bias, q0, k0, tq, tk):
    blk = np.zeros((RB, RB))
    if bias is not None:
        nq, nk = max(0, min(RB, tq - q0)), max(0, min(RB, tk - k0))
        blk[:nq, :nk] = bias[q0:q0 + nq, k0:k0 + nk]
    return blk


def _pass1(q, k, v, g, lse, delta, bias, scale):
    """dK, dV of one (b, h), as flash_bwd_dkdv_tf32_kernel computes them."""
    tq, d = q.shape
    tk = k.shape[0]
    dk = _dk(d)
    ld, kd8 = dk + 4, -(-d // 8)
    a_off, nt, kt = _a_offsets(ld), _nt_offsets(ld), _kt_offsets(ld)
    dk_out, dv_out = np.zeros((tk, d)), np.zeros((tk, d))
    for k0 in range(0, tk, RB):
        sk, sv = _staged(k, k0, tk, d, dk), _staged(v, k0, tk, d, dk)
        for w in range(4):
            acc_k, acc_v = np.zeros((dk // 8, 32, 4)), np.zeros((dk // 8, 32, 4))
            key_l = w * 16 + G
            key_ok = [k0 + key_l < tk, k0 + key_l + 8 < tk]
            for q0 in range(0, tq, RB):
                sq, sg = _staged(q, q0, tq, d, dk), _staged(g, q0, tq, d, dk)
                s_lse, s_dlt = _rows(lse, q0, tq), _rows(delta, q0, tq)
                blk = _bias_block(bias, q0, k0, tq, tk)
                for qc in range(0, RB, RC):
                    s = _two_scores(sk, w * 16 * ld + a_off, sq,
                                    qc * ld + nt, ld, dk, kd8)
                    dp = _two_scores(sv, w * 16 * ld + a_off, sg,
                                     qc * ld + nt, ld, dk, kd8)
                    pa, da = np.zeros_like(s), np.zeros_like(s)
                    for j in range(RC // 8):
                        ql = qc + j * 8 + 2 * TL
                        pe, de = np.zeros((32, 4)), np.zeros((32, 4))
                        for e in range(4):
                            c, r = e & 1, e >> 1
                            x = s[j][:, e] * scale + blk[ql + c, key_l + 8 * r]
                            ok = key_ok[r] & (q0 + ql + c < tq)
                            pv = np.where(ok, np.exp(x - s_lse[ql + c]), 0.0)
                            pe[:, e] = pv
                            de[:, e] = pv * (dp[j][:, e] - s_dlt[ql + c]) * scale
                        pa[j], da[j] = _c_to_a(pe), _c_to_a(de)
                    acc_v = _product_d(acc_v, pa, sg, qc * ld + kt, ld, kd8)
                    acc_k = _product_d(acc_k, da, sq, qc * ld + kt, ld, kd8)
            for acc, out in ((acc_k, dk_out), (acc_v, dv_out)):
                _write_rows(out, acc, k0 + key_l, tk, d)
    return dk_out, dv_out


def _write_rows(out, acc, row0, n, d):
    for r in range(2):
        rows = row0 + 8 * r
        for t in range(-(-d // 8)):
            for c in range(2):
                col = t * 8 + 2 * TL + c
                ok = (rows < n) & (col < d)
                out[rows[ok], col[ok]] = acc[t][ok, 2 * r + c]


def _pass2(q, k, v, g, lse, delta, bias, scale, own_dbias):
    """dQ of one (b, h) (and, with its own bias slice, dbias), as
    flash_bwd_dq_tf32_kernel computes them."""
    tq, d = q.shape
    tk = k.shape[0]
    dk = _dk(d)
    ld, kd8 = dk + 4, -(-d // 8)
    a_off, nt, kt = _a_offsets(ld), _nt_offsets(ld), _kt_offsets(ld)
    dq = np.zeros((tq, d))
    dbias = np.zeros((tq, tk)) if own_dbias else None
    for q0 in range(0, tq, RB):
        sq, sg = _staged(q, q0, tq, d, dk), _staged(g, q0, tq, d, dk)
        for w in range(4):
            row_l = w * 16 + G
            rows = [q0 + row_l, q0 + row_l + 8]
            ls = [np.where(r < tq, lse[np.minimum(r, tq - 1)], 0.0)
                  for r in rows]
            dl = [np.where(r < tq, delta[np.minimum(r, tq - 1)], 0.0)
                  for r in rows]
            acc = np.zeros((dk // 8, 32, 4))
            for k0 in range(0, tk, RB):
                sk, sv = _staged(k, k0, tk, d, dk), _staged(v, k0, tk, d, dk)
                blk = _bias_block(bias, q0, k0, tq, tk)
                for kc in range(0, RB, RC):
                    s = _two_scores(sq, w * 16 * ld + a_off, sk,
                                    kc * ld + nt, ld, dk, kd8)
                    dp = _two_scores(sg, w * 16 * ld + a_off, sv,
                                     kc * ld + nt, ld, dk, kd8)
                    da = np.zeros_like(s)
                    for j in range(RC // 8):
                        kl = kc + j * 8 + 2 * TL
                        de = np.zeros((32, 4))
                        for r in range(2):
                            for c in range(2):
                                e = 2 * r + c
                                x = s[j][:, e] * scale + blk[row_l + 8 * r, kl + c]
                                ok = (rows[r] < tq) & (k0 + kl + c < tk)
                                pv = np.where(ok, np.exp(x - ls[r]), 0.0)
                                ds = pv * (dp[j][:, e] - dl[r])
                                de[:, e] = ds * scale
                                if own_dbias:
                                    dbias[rows[r][ok], (k0 + kl + c)[ok]] = ds[ok]
                        da[j] = _c_to_a(de)
                    acc = _product_d(acc, da, sk, kc * ld + kt, ld, kd8)
            _write_rows(dq, acc, q0 + row_l, tq, d)
    return dq, dbias


def _row_of(mode, n, r, h):
    """The (b, h) row of replica r of bias slice n (csrc row_of)."""
    return r if mode == 1 else r * h + n if mode == 2 else n


def _pass3(qs, ks, vs, gs, lses, deltas, bias, scale, mode, h):
    """dbias of slice n shared by several rows, as
    flash_bwd_dbias_tf32_kernel sums it: per [64 x 64] tile, each row that
    shares the slice in row order. qs...: per (b, h) row."""
    n_rows = len(qs)
    tq, d = qs[0].shape
    tk = ks[0].shape[0]
    dk = _dk(d)
    ld, kd8 = dk + 4, -(-d // 8)
    a_off, nt = _a_offsets(ld), _nt_offsets(ld)
    slices = 1 if mode == 1 else h
    n_rep = n_rows // slices
    out = np.zeros((slices, tq, tk))
    for n in range(slices):
        for q0 in range(0, tq, RB):
            for k0 in range(0, tk, RB):
                blk = _bias_block(bias[n], q0, k0, tq, tk)
                for w in range(4):
                    row_l = w * 16 + G
                    acc = np.zeros((RB // 8, 32, 4))
                    for rep in range(n_rep):
                        bh = _row_of(mode, n, rep, h)
                        sq = _staged(qs[bh], q0, tq, d, dk)
                        sg = _staged(gs[bh], q0, tq, d, dk)
                        sk = _staged(ks[bh], k0, tk, d, dk)
                        sv = _staged(vs[bh], k0, tk, d, dk)
                        s_lse = _rows(lses[bh], q0, tq)
                        s_dlt = _rows(deltas[bh], q0, tq)
                        for kc in range(0, RB, RC):
                            s = _two_scores(sq, w * 16 * ld + a_off, sk,
                                            kc * ld + nt, ld, dk, kd8)
                            dp = _two_scores(sg, w * 16 * ld + a_off, sv,
                                             kc * ld + nt, ld, dk, kd8)
                            for j in range(RC // 8):
                                jt = kc // 8 + j
                                kl = jt * 8 + 2 * TL
                                for e in range(4):
                                    r, c = e >> 1, e & 1
                                    x = (s[j][:, e] * scale
                                         + blk[row_l + 8 * r, kl + c])
                                    ok = ((q0 + row_l + 8 * r < tq)
                                          & (k0 + kl + c < tk))
                                    pv = np.where(ok, np.exp(
                                        x - s_lse[row_l + 8 * r]), 0.0)
                                    acc[jt][:, e] += pv * (
                                        dp[j][:, e] - s_dlt[row_l + 8 * r])
                    sub = np.zeros((tq, tk))
                    for jt in range(RB // 8):
                        for r in range(2):
                            for c in range(2):
                                rows = q0 + row_l + 8 * r
                                cols = k0 + jt * 8 + 2 * TL + c
                                ok = (rows < tq) & (cols < tk)
                                sub[rows[ok], cols[ok]] = acc[jt][ok, 2 * r + c]
                    out[n] += sub  # each element from exactly one block
    return out


def _emulated_backward(q, k, v, g, out, lse, bias, scale):
    """The kernels' gradients for [B, H, T, D] float64 inputs: pass 1 and
    pass 2 a (b, h), then the shared-slice dbias pass; multi-query dk/dv
    summed over heads as the wrapper does."""
    b, h, tq, d = q.shape
    mq = k.shape[1] == 1 and h > 1
    delta = (g * out).sum(-1)
    kx = np.broadcast_to(k, q.shape[:2] + k.shape[2:])
    vx = np.broadcast_to(v, q.shape[:2] + v.shape[2:])
    mode = 0 if bias is None else {2: 1, 3: 2, 4: 3}[bias.ndim]
    b3 = None if bias is None else bias.reshape(-1, tq, k.shape[2])
    dq, dk, dv = np.zeros_like(q), np.zeros(kx.shape), np.zeros(vx.shape)
    dbias = None if bias is None else np.zeros(b3.shape)
    for bi in range(b):
        for hi in range(h):
            bh = bi * h + hi
            sl = None if b3 is None else b3[0 if mode == 1 else
                                            hi if mode == 2 else bh]
            args = (q[bi, hi], kx[bi, hi], vx[bi, hi], g[bi, hi],
                    lse[bi, hi], delta[bi, hi], sl, scale)
            dk[bi, hi], dv[bi, hi] = _pass1(*args)
            dq[bi, hi], own = _pass2(*args, own_dbias=mode == 3)
            if mode == 3:
                dbias[bh] = own
    if mode in (1, 2):
        flat = lambda x: [x[bi, hi] for bi in range(b) for hi in range(h)]  # noqa: E731
        dbias = _pass3(flat(q), flat(kx), flat(vx), flat(g), flat(lse),
                       flat(delta), b3, scale, mode, h)
    if mq:
        dk, dv = dk.sum(1, keepdims=True), dv.sum(1, keepdims=True)
    if dbias is not None:
        dbias = dbias.reshape(bias.shape)
    return dq, dk, dv, dbias


CASES = [  # (B, H, Tq, Tk, D, kv heads, bias shape)
    (1, 2, 70, 130, 16, 2, None),
    (2, 2, 65, 70, 52, 1, (2, 65, 70)),      # the prior's layout, ragged
    (1, 2, 66, 129, 64, 2, (66, 129)),       # one shared slice
    (2, 1, 70, 65, 128, 1, (2, 1, 70, 65)),  # one slice per (b, h)
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "x".join(map(str, c[:6]))
                         + ("" if c[6] is None else f"_bias{len(c[6])}"))
def test_tf32_backward_tiles_give_the_plain_gradients(case):
    b, h, tq, tk, d, hkv, bshape = case
    rng = np.random.default_rng(tq * tk + d)
    q, g = (rng.standard_normal((b, h, tq, d)) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, tk, d)) for _ in range(2))
    bias = rng.standard_normal(bshape) if bshape else None
    scale = d ** -0.5
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = tattn.attention_reference_lse(tq_, tk_, tv_, bias=tb,
                                             scale=scale)
    got = _emulated_backward(q, k, v, g, out.numpy(), lse.numpy(), bias,
                             scale)
    want = tattn.flash_attention_bwd_reference(
        tq_, tk_, tv_, tb, torch.from_numpy(g), out, lse, scale)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        w = w.numpy()
        assert a.shape == w.shape, name
        assert np.abs(a - w).max() <= 1e-12 * np.abs(w).max(), name


@pytest.mark.parametrize("mode,b,h", [(1, 3, 2), (2, 3, 4)],
                         ids=["shared", "per_head"])
def test_dbias_pass_walks_each_sharing_row_once_in_row_order(mode, b, h):
    # the dbias kernel's replicas of slice n (row_of) are the (b, h) rows
    # whose bias slice (bias_slice) is n, in increasing row order, so the
    # sum over them has one fixed order
    slices = 1 if mode == 1 else h
    n_rep = b * h // slices
    for n in range(slices):
        rows = [_row_of(mode, n, r, h) for r in range(n_rep)]
        owners = [bh for bh in range(b * h)
                  if (0 if mode == 1 else bh % h) == n]
        assert rows == owners
