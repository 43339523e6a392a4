"""CPU emulation of the TF32 wgmma flash backward
(neurons_tpu_torch/csrc/flash_attn_bwd_tf32_sm90.cu), by index, and the
port's f32 backward against the JAX package's.

The kernels run only on the card. These tests replay in numpy what they do
with each index: the TMA boxes' swizzled f32 writes (zero past D and past
the tokens), the producer's rounding of each tile in place and its
transposes Q^T, g^T and K^T (tokens contiguous, each 8-token group in the
order 0 2 4 6 1 3 5 7) with their lane map, the K-major descriptors' reads
of every operand at every DN's swizzle, the m64nNk8 accumulator layout, the
hand-off of P and dS from an accumulator into the TF32 A fragment (a = c0,
c2, c1, c3), the prior's Q and g as register A fragments, delta by thread
and quad, the last tile's p = 0 mask, the prior's on-chip sums (dbias over
the batch in key-tile order, dK/dV over the two consumers and then the
cluster's head groups in rank order) and the full / ready / empty mbarrier
walk, with the odd and even consumers of the prior's passes. The emulated
kernels are held to the plain version as the card tests hold the kernels:
each gradient's error against float64 within 1.5x that of
`flash_attention_bwd_reference(tf32=True)` (TF32-rounded operands), and,
on f32 inputs from a seed, within 1.5x of the plain version's distance
from the JAX package's Pallas backward in interpret mode (`_flash_bwd_pallas`,
`_flash_bwd_pallas_bias`, f32 products), relative to max |JAX|.

The last cases hold the port's f32 `flash_attention_bwd` (its plain version
on the CPU) to the same Pallas kernels: both sides f32 arithmetic up to
summation order, within 1e-4 of max |JAX|."""

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
from test_torch_port_wgmma_tf32 import (PERM, MBarrier, a_layout, a_matrix,
                                        c_layout, hand_off, read_k_major,
                                        swizzle, tf32, tma_box)
from torch_port_utils import rel_err, t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LOG2E = 1.4426950408889634
HEAD_DIMS = [8, 32, 52, 64, 128]


def plan(d):
    (rows_q, bk, stages_q, smem_q, rows_kv, bq, stages_kv, smem_kv, bw,
     nb) = attn.tf32_wgmma_bwd_tiles(d)
    return dict(dn=attn.tf32_wgmma_dn(d), rows_q=rows_q, bk=bk,
                stages_q=stages_q, smem_q=smem_q, rows_kv=rows_kv, bq=bq,
                stages_kv=stages_kv, smem_kv=smem_kv, bw=bw, nb=nb,
                dks=bw * nb, rb=4 * bw, split=attn.tf32_wgmma_dn(d) > 64)


def bias_plan(d, tk):
    dn, bk, st1, smem1, groups, bq, st2, smem2 = (
        attn.tf32_bias_wgmma_bwd_tiles(d, tk))
    bw, nb = attn._tf32_columns(dn)
    return dict(dn=dn, bk=bk, stages1=st1, smem1=smem1, groups=groups,
                bq=bq, stages2=st2, smem2=smem2, bw=bw, nb=nb, dks=bw * nb,
                rb=4 * bw)


# ---------------------------------------------------------------------------
# the producer's transposes (round_transpose): a raw tile of R token rows
# rounded in place and written as T, row n (head column n) holding the
# tokens in 32-token blocks of 128 swizzled bytes, block kb at kb DN 128

def t_jobs(rows, dn):
    """Per piece j (thread j % 128, pass j // 128): the lane position l,
    the 32-token block kb and the 4-column chunk c."""
    nkb, full = rows // 32, (dn // 4) & ~7
    j = np.arange((rows // 8) * 2 * (dn // 4))
    l, rest = j & 7, j >> 3
    kb, m = rest % nkb, rest // nkb
    return l, kb, np.where(m < full, m ^ (l & 6), m)


def t_reads(rows, dn, bw, base):
    """Byte addresses [pieces, u] of the raw tile's float4 reads (tokens
    8 (l >> 1) + 2u + (l & 1) of block kb, columns 4c ..), and the tokens."""
    l, kb, c = t_jobs(rows, dn)
    u = np.arange(4)[None, :]
    tok = 32 * kb[:, None] + 8 * (l[:, None] >> 1) + 2 * u + (l[:, None] & 1)
    col = 4 * c[:, None]
    rb = 4 * bw
    return base + (col // bw) * rows * rb + swizzle(tok * rb + 4 * (col % bw),
                                                    rb), tok


def t_writes(rows, dn, base):
    """Byte addresses [pieces, w] of T's float4 writes (row n = 4c + w,
    positions 8 (l >> 1) + 4 (l & 1) .. + 3 of block kb), and the rows."""
    l, kb, c = t_jobs(rows, dn)
    n = 4 * c[:, None] + np.arange(4)[None, :]
    return base + kb[:, None] * dn * 128 + swizzle(
        n * 128 + 16 * l[:, None], 128), n


def round_transpose(smem, raw, tr, rows, dn, bw):
    """The producer's pass over one tile: each piece read, rounded, written
    back in place and into T."""
    ra, _ = t_reads(rows, dn, bw, raw)
    idx = (ra[:, :, None] // 4) + np.arange(4)
    vals = tf32(smem[idx])                    # [pieces, u, column w]
    smem[idx] = vals
    wa, _ = t_writes(rows, dn, tr)
    for w in range(4):
        for u in range(4):
            smem[wa[:, w] // 4 + u] = vals[:, u, w]


def read_t(smem, tr, kk, dn):
    """The [DN, 8] operand k8 step kk of a product reads from T: 8 tokens
    (positions) of each row."""
    return read_k_major(smem, tr + (kk // 4) * dn * 128 + (kk % 4) * 32, dn,
                        1024, 128)


def read_raw(smem, base, rows_a_block, row0, n, dn, bw):
    """[n, DN] of a raw K-major tile (rows row0 .. of column blocks of
    rows_a_block rows) as the k8 steps' descriptors read it."""
    rb = 4 * bw
    return np.concatenate([read_k_major(
        smem, base + (ks * 8 // bw) * rows_a_block * rb + row0 * rb
        + (ks * 8 % bw) * 4, n, 8 * rb, rb) for ks in range(dn // 8)], 1)


def gather_t(smem, tr, k, dn):
    """[K, DN] of T over K tokens, in the positions' order (each 8-token
    group permuted): the B operand of the gradient products."""
    return np.concatenate([read_t(smem, tr, kk, dn).T
                           for kk in range(k // 8)])


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_transposes_cover_the_tile_once_and_keep_their_banks(d, rows):
    dn = attn.tf32_wgmma_dn(d)
    bw = attn._tf32_columns(dn)[0]
    ra, tok = t_reads(rows, dn, bw, 0)
    wa, n = t_writes(rows, dn, 0)
    # every (token, 4-column chunk) read once, every T slot written once
    seen = np.zeros((rows, dn // 4), int)
    np.add.at(seen, (tok, np.broadcast_to((n // 4)[:, :1], tok.shape)), 1)
    assert (seen == 1).all()
    slots = (wa[:, :, None] + 4 * np.arange(4)).ravel()
    assert sorted(slots.tolist()) == list(range(0, dn * rows * 4, 4))
    # T's rows are bijections of their 128-byte blocks
    addr = swizzle(np.arange(dn)[:, None] * 128 + 4 * np.arange(32)[None],
                   128)
    assert sorted(addr.ravel().tolist()) == list(range(0, dn * 128, 4))
    # the 8 lanes of each 16-byte phase: 8 distinct bank groups on every
    # read (128-byte raw rows) and every write, where the chunk group is
    # whole
    for a in (ra, wa):
        for start in range(0, (len(a) // 8) * 8, 8):
            full = (start // 8) // (rows // 32) < (dn // 4) & ~7
            if bw == 32 and full:
                for col in range(4):
                    assert len(set((a[start:start + 8, col] // 16 % 8)
                                   .tolist())) == 8


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_transposed_descriptors_read_the_permuted_tokens(d, rows):
    # a TMA-written tile rounded and transposed: each k8 step of a gradient
    # product reads 8 tokens of T in PERM's order, and the raw tile's
    # descriptors read it rounded in place
    dn = attn.tf32_wgmma_dn(d)
    bw, nb = attn._tf32_columns(dn)
    rb, dks = 4 * bw, bw * nb
    src = np.random.default_rng(d + rows).standard_normal(
        (rows - 3, d)).astype(np.float32)   # a ragged last tile
    tile = rows * dks * 4
    smem = np.full((tile + dn * rows * 4) // 4, np.nan, np.float32)
    for j in range(nb):
        tma_box(smem, j * rows * rb, src, 0, j * bw, rows, bw, rb)
    round_transpose(smem, 0, tile, rows, dn, bw)
    assert not np.isnan(smem).any()
    pad = np.zeros((rows, dn), np.float32)
    pad[:rows - 3, :d] = src
    for kk in range(rows // 8):
        assert np.array_equal(read_t(smem, tile, kk, dn),
                              tf32(pad[8 * kk + PERM]).T)
    assert np.array_equal(read_raw(smem, 0, rows, 0, rows, dn, bw), tf32(pad))


# ---------------------------------------------------------------------------
# the kernels, emulated (one (b, h) unbiased; the prior's layout whole)

def _exp2(x):
    with np.errstate(over="ignore", invalid="ignore"):
        return np.exp2(x.astype(np.float64)).astype(np.float32)


def quad_delta(g, out, rows, d):
    """delta of `rows` as the threads take it: each lane of a quad sums its
    d / 4 columns in order (f32), the quad adds lanes xor 1, then xor 2."""
    part = np.zeros((len(rows), 4), np.float32)
    ok = rows < g.shape[0]
    for t4 in range(4):
        for j in range(t4 * (d // 4), (t4 + 1) * (d // 4)):
            part[ok, t4] = np.float32(part[ok, t4] + g[rows[ok], j]
                                      * out[rows[ok], j])
    return ((part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])).astype(
        np.float32)


def product(a, b):
    """A B^T of TF32 operands, summed in float64, f32 out."""
    return (a.astype(np.float64) @ b.T.astype(np.float64)).astype(np.float32)


def accumulate(acc, amat, bmat, rows, cols):
    """acc (a register file) += A B over the permuted tokens (f32 sum)."""
    return (acc + (amat.astype(np.float64) @ bmat.astype(np.float64))[
        rows, cols]).astype(np.float32)


def unrows(acc, row, col, d):
    """A register file [128, DN / 2] as the [64, d] rows it holds."""
    out = np.zeros((64, max(col.max() + 1, d)), np.float32)
    out[row, col] = acc
    return out[:, :d]


def emulate_dq(q, k, v, g, out, lse, scale, mask=True):
    """The unbiased dQ pass over one (b, h): q, g, out [Tq, D], k, v [Tk,
    D] f32, lse [Tq]. Returns (dq [Tq, D], delta [Tq])."""
    tq, d = q.shape
    tk = k.shape[0]
    p = plan(d)
    dn, bw, nb, rb, bk, rq = p["dn"], p["bw"], p["nb"], p["rb"], p["bk"], p[
        "rows_q"]
    res, tile = rq * p["dks"] * 4, bk * p["dks"] * 4
    c = np.float32(scale * LOG2E)
    srow, scol = c_layout(bk)
    orow, ocol = c_layout(dn)
    r_of_s = (np.arange(bk // 2) >> 1) & 1
    dq = np.zeros((tq, d), np.float32)
    delta = np.zeros(tq, np.float32)
    for qb in range(-(-tq // rq)):
        smem = np.zeros((2 * res + 2 * tile + dn * bk * 4) // 4, np.float32)
        for j in range(nb):
            tma_box(smem, j * rq * rb, q, qb * rq, j * bw, rq, bw, rb)
            tma_box(smem, res + j * rq * rb, g, qb * rq, j * bw, rq, bw, rb)
        smem[:2 * res // 4] = tf32(smem[:2 * res // 4])
        images = []
        for tt in range(-(-tk // bk)):
            kt = 2 * res
            for j in range(nb):
                tma_box(smem, kt + j * bk * rb, k, tt * bk, j * bw, bk, bw, rb)
                tma_box(smem, kt + tile + j * bk * rb, v, tt * bk, j * bw, bk,
                        bw, rb)
            round_transpose(smem, kt, kt + 2 * tile, bk, dn, bw)
            smem[(kt + tile) // 4:(kt + 2 * tile) // 4] = tf32(
                smem[(kt + tile) // 4:(kt + 2 * tile) // 4])
            images.append(smem.copy())
        for cw in range(rq // 64):
            row0 = qb * rq + cw * 64
            rows = row0 + np.arange(64)
            dl = quad_delta(g, out, rows, d)
            l2 = np.where(rows < tq, lse[np.minimum(rows, tq - 1)]
                          * np.float32(LOG2E), np.inf).astype(np.float32)
            acc = np.zeros((128, dn // 2), np.float32)
            for tt, img in enumerate(images):
                kt = 2 * res
                qm = read_raw(img, cw * 64 * rb, rq, 0, 64, dn, bw)
                gm = read_raw(img, res + cw * 64 * rb, rq, 0, 64, dn, bw)
                s = product(qm, read_raw(img, kt, bk, 0, bk, dn, bw))
                dp = product(gm, read_raw(img, kt + tile, bk, 0, bk, dn, bw))
                sc, dpc = s[srow, scol], dp[srow, scol]
                pv = _exp2(sc * c - l2[srow])
                if mask:
                    pv = np.where(tt * bk + scol >= tk, 0.0, pv).astype(
                        np.float32)
                ds = ((pv * (dpc - dl[srow])).astype(np.float32)
                      * np.float32(scale)).astype(np.float32)
                amat = a_matrix(hand_off(ds))
                acc = accumulate(acc, amat, gather_t(img, kt + 2 * tile, bk,
                                                     dn), orow, ocol)
            keep = rows < tq
            dq[rows[keep]] = unrows(acc, orow, ocol, d)[keep]
            delta[rows[keep]] = dl[keep]
    return dq, delta


def stage_qg(q, g, t0, bq, dn, bw, nb):
    """A dK/dV ring stage as the producer leaves it: Q and g boxes of bq
    rows from token t0, rounded in place, and Q^T, g^T. Returns the image
    and the byte offsets of Q, g, Q^T and g^T."""
    rb, tile, tr = 4 * bw, bq * bw * nb * 4, dn * bq * 4
    smem = np.zeros((2 * tile + 2 * tr) // 4, np.float32)
    for j in range(nb):
        tma_box(smem, j * bq * rb, q, t0, j * bw, bq, bw, rb)
        tma_box(smem, tile + j * bq * rb, g, t0, j * bw, bq, bw, rb)
    round_transpose(smem, 0, 2 * tile, bq, dn, bw)
    round_transpose(smem, tile, 2 * tile + tr, bq, dn, bw)
    return smem, (0, tile, 2 * tile, 2 * tile + tr)


def resident_kv(k, v, row0, rows, dn, bw, nb):
    """K and V boxes of `rows` rows from key row0, rounded in place: the
    dK/dV pass's resident tiles. Returns the image and V's offset."""
    rb, res = 4 * bw, rows * bw * nb * 4
    smem = np.zeros(2 * res // 4, np.float32)
    for j in range(nb):
        tma_box(smem, j * rows * rb, k, row0, j * bw, rows, bw, rb)
        tma_box(smem, res + j * rows * rb, v, row0, j * bw, rows, bw, rb)
    return tf32(smem), res


def dkdv_step(adk, adv, km, vm, img, offs, bq, dn, bw, l2, dl, scale,
              bias=None):
    """One consumer step of a dK/dV pass: S^T = K Q^T and dP^T = V g^T (K,
    V: the consumer's 64 rows as its descriptors read them; Q, g: the
    stage's), P^T and dS^T * scale in registers (l2, dl, bias at S^T's
    registers; the logits scaled and biased first with a bias), then
    dV += P^T g over g^T and dK += (dS^T * scale) Q over Q^T."""
    srow, scol = c_layout(bq)
    orow, ocol = c_layout(dn)
    sct = product(km, read_raw(img, offs[0], bq, 0, bq, dn, bw))[srow, scol]
    dpt = product(vm, read_raw(img, offs[1], bq, 0, bq, dn, bw))[srow, scol]
    c = np.float32(scale * LOG2E)
    if bias is not None:
        sct = (sct * np.float32(scale) + bias).astype(np.float32)
        c = np.float32(LOG2E)
    pv = _exp2(sct * c - l2)
    ds = ((pv * (dpt - dl)).astype(np.float32)
          * np.float32(scale)).astype(np.float32)
    adv = accumulate(adv, a_matrix(hand_off(pv)),
                     gather_t(img, offs[3], bq, dn), orow, ocol)
    adk = accumulate(adk, a_matrix(hand_off(ds)),
                     gather_t(img, offs[2], bq, dn), orow, ocol)
    return adk, adv


def step_stats(lse, delta, t0, bq):
    """The stage's lse * log2(e) (+inf past Tq) and delta (0 past Tq) at
    S^T's registers."""
    _, scol = c_layout(bq)
    qs = t0 + scol
    ok, at = qs < len(lse), np.minimum(qs, len(lse) - 1)
    return (np.where(ok, lse[at] * np.float32(LOG2E), np.inf).astype(
        np.float32), np.where(ok, delta[at], 0.0).astype(np.float32))


def emulate_dkdv(q, k, v, g, lse, delta, scale):
    """The unbiased dK/dV pass over one (b, h): blocks of kRowsKV keys,
    consumer cw on rows 64 cw .. of the resident tiles (past DN 64 both
    consumers on one 64-key block: dV and dK of the same products), query
    tiles of BQ in order. Returns (dk, dv) [Tk, D]."""
    tq, d = q.shape
    tk = k.shape[0]
    p = plan(d)
    dn, bw, nb, bq, rk = p["dn"], p["bw"], p["nb"], p["bq"], p["rows_kv"]
    orow, ocol = c_layout(dn)
    dk = np.zeros((tk, d), np.float32)
    dv = np.zeros((tk, d), np.float32)
    for kb in range(-(-tk // rk)):
        kv, vo = resident_kv(k, v, kb * rk, rk, dn, bw, nb)
        for cw in range(1 if p["split"] else rk // 64):
            km = read_raw(kv, 0, rk, 64 * cw, 64, dn, bw)
            vm = read_raw(kv, vo, rk, 64 * cw, 64, dn, bw)
            adk = np.zeros((128, dn // 2), np.float32)
            adv = np.zeros_like(adk)
            for tt in range(-(-tq // bq)):
                img, offs = stage_qg(q, g, tt * bq, bq, dn, bw, nb)
                l2, dl = step_stats(lse, delta, tt * bq, bq)
                adk, adv = dkdv_step(adk, adv, km, vm, img, offs, bq, dn, bw,
                                     l2, dl, scale)
            rows = kb * rk + 64 * cw + np.arange(64)
            keep = rows < tk
            dk[rows[keep]] = unrows(adk, orow, ocol, d)[keep]
            dv[rows[keep]] = unrows(adv, orow, ocol, d)[keep]
    return dk, dv


def emulate(q, k, v, g, out, lse, scale):
    """The unbiased backward, [B, H, T, D] numpy (k/v [B, Hkv, Tk, D]):
    the dQ pass, then the dK/dV pass, per (b, h); multi-query dk/dv summed
    over heads (the wrapper's f32 sum). Returns (dq, dk, dv)."""
    b, h = q.shape[:2]
    hkv = k.shape[1]
    dq = np.zeros_like(q)
    dk = np.zeros((b, h) + k.shape[2:], np.float32)
    dv = np.zeros_like(dk)
    for bi in range(b):
        for hi in range(h):
            kh = 0 if hkv == 1 else hi
            dq[bi, hi], delta = emulate_dq(q[bi, hi], k[bi, kh], v[bi, kh],
                                           g[bi, hi], out[bi, hi],
                                           lse[bi, hi], scale)
            dk[bi, hi], dv[bi, hi] = emulate_dkdv(
                q[bi, hi], k[bi, kh], v[bi, kh], g[bi, hi], lse[bi, hi],
                delta, scale)
    if hkv != h:
        dk, dv = dk.sum(1, keepdims=True), dv.sum(1, keepdims=True)
    return dq, dk, dv


def emulate_prior(q, k, v, g, out, lse, bias, scale):
    """The prior's two passes, q, g, out [B, H, Tq, D], k/v [B, 1, Tk, D],
    bias [H, Tq, Tk]. Pass 1 per (head, 64 queries): the even and odd
    consumers' key tiles of 32 keys per batch row, Q and g as register A
    fragments, dbias summed over the batch in an f32 accumulator, each
    row's dQ as the even consumer's plus the odd one's. Pass 2 per (batch
    row, 64 keys, head group): the group's (head, 32-query tile) steps
    taken by the consumers in turn, their dK/dV added (first + second),
    then summed over the head groups in rank order from 0. Returns (dq, dk,
    dv, dbias)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    p = bias_plan(d, tk)
    dn, bw, nb, rb, bk = p["dn"], p["bw"], p["nb"], p["rb"], p["bk"]
    tile = bk * p["dks"] * 4
    srow, scol = c_layout(bk)
    orow, ocol = c_layout(dn)
    ar, ak = a_layout()
    ntk = -(-tk // bk)
    dq = np.zeros_like(q)
    delta = np.zeros((b, h, tq), np.float32)
    dbias = np.zeros((h, tq, tk), np.float32)
    for hi in range(h):
        for qt in range(-(-tq // 64)):
            rows = qt * 64 + np.arange(64)
            ok = rows < tq
            acc = np.zeros((ntk, 128, bk // 2), np.float32)
            for bi in range(b):
                # the fragments of thread tid, k8 step ks, register j (a0
                # (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)),
                # rounded, as the A operand's [64, DN] matrix
                qm = np.zeros((64, dn), np.float32)
                gm = np.zeros((64, dn), np.float32)
                for src, dst in ((q, qm), (g, gm)):
                    pad = np.zeros((64, dn), np.float32)
                    pad[ok, :d] = src[bi, hi, rows[ok]]
                    for ks in range(dn // 8):
                        dst[:, 8 * ks:8 * ks + 8] = a_matrix(
                            tf32(pad[ar, 8 * ks + ak])[:, None])
                dl = quad_delta(g[bi, hi], out[bi, hi], rows, d)
                l2 = np.where(ok, lse[bi, hi, np.minimum(rows, tq - 1)]
                              * np.float32(LOG2E), np.inf).astype(np.float32)
                part = []
                for cw in range(2):
                    adq = np.zeros((128, dn // 2), np.float32)
                    for kt in range(cw, ntk, 2):
                        smem = np.zeros((2 * tile + dn * bk * 4) // 4,
                                        np.float32)
                        for j in range(nb):
                            tma_box(smem, j * bk * rb, k[bi, 0], kt * bk,
                                    j * bw, bk, bw, rb)
                            tma_box(smem, tile + j * bk * rb, v[bi, 0],
                                    kt * bk, j * bw, bk, bw, rb)
                        round_transpose(smem, 0, 2 * tile, bk, dn, bw)
                        smem[tile // 4:2 * tile // 4] = tf32(
                            smem[tile // 4:2 * tile // 4])
                        sc = product(qm, read_raw(smem, 0, bk, 0, bk, dn, bw)
                                     )[srow, scol]
                        dpc = product(gm, read_raw(smem, tile, bk, 0, bk, dn,
                                                   bw))[srow, scol]
                        keys, rr = kt * bk + scol, qt * 64 + srow
                        bv = np.where((rr < tq) & (keys < tk),
                                      bias[hi, np.minimum(rr, tq - 1),
                                           np.minimum(keys, tk - 1)], 0.0)
                        x = (sc * np.float32(scale) + bv).astype(np.float32)
                        pv = np.where(keys < tk,
                                      _exp2(x * np.float32(LOG2E) - l2[srow]),
                                      0.0).astype(np.float32)
                        ds = (pv * (dpc - dl[srow])).astype(np.float32)
                        acc[kt] = ds if bi == 0 else (acc[kt] + ds).astype(
                            np.float32)
                        dss = (ds * np.float32(scale)).astype(np.float32)
                        adq = accumulate(adq, a_matrix(hand_off(dss)),
                                         gather_t(smem, 2 * tile, bk, dn),
                                         orow, ocol)
                    part.append(adq)
                adq = part[0] if ntk == 1 else (part[0] + part[1]).astype(
                    np.float32)
                dq[bi, hi, rows[ok]] = unrows(adq, orow, ocol, d)[ok]
                delta[bi, hi, rows[ok]] = dl[ok]
            for kt in range(ntk):
                keys, rr = kt * bk + scol, qt * 64 + srow
                keep = (rr < tq) & (keys < tk)
                dbias[hi, rr[keep], keys[keep]] = acc[kt][keep]
    # pass 2
    groups, bq = p["groups"], p["bq"]
    hg = -(-h // groups)
    srow2, scol2 = c_layout(bq)
    dk = np.zeros((b, 1, tk, d), np.float32)
    dv = np.zeros_like(dk)
    for bi in range(b):
        for kt in range(-(-tk // 64)):
            kv, vo = resident_kv(k[bi, 0], v[bi, 0], kt * 64, 64, dn, bw, nb)
            km = read_raw(kv, 0, 64, 0, 64, dn, bw)
            vm = read_raw(kv, vo, 64, 0, 64, dn, bw)
            keys = kt * 64 + srow2
            parks = []
            for grp in range(groups):
                steps = [(hh, qq) for hh in range(grp * hg,
                                                  min(h, grp * hg + hg))
                         for qq in range(-(-tq // bq))]
                sums = []
                for cw in range(2):
                    adk = np.zeros((128, dn // 2), np.float32)
                    adv = np.zeros_like(adk)
                    for hh, qq in steps[cw::2]:
                        img, offs = stage_qg(q[bi, hh], g[bi, hh], qq * bq,
                                             bq, dn, bw, nb)
                        l2, dl = step_stats(lse[bi, hh], delta[bi, hh],
                                            qq * bq, bq)
                        qs = qq * bq + scol2
                        bv = np.where((qs < tq) & (keys < tk),
                                      bias[hh, np.minimum(qs, tq - 1),
                                           np.minimum(keys, tk - 1)], 0.0
                                      ).astype(np.float32)
                        adk, adv = dkdv_step(adk, adv, km, vm, img, offs, bq,
                                             dn, bw, l2, dl, scale, bv)
                    sums.append((adk, adv))
                parks.append([(sums[0][w] + sums[1][w]).astype(np.float32)
                              for w in range(2)])
            rows = kt * 64 + np.arange(64)
            keep = rows < tk
            for w, dst in enumerate((dk, dv)):
                x = np.zeros((128, dn // 2), np.float32)
                for r in range(groups):
                    x = (x + parks[r][w]).astype(np.float32)
                dst[bi, 0, rows[keep]] = unrows(x, orow, ocol, d)[keep]
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# held to the plain version and to the JAX package

def _case(seed, b, h, hkv, tq, tk, d, biased=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, h, tq, d), dtype=np.float32)
    bias = (rng.standard_normal((h, tq, tk), dtype=np.float32)
            if biased else None)
    return q, k, v, g, bias


def _forward(q, k, v, bias, scale):
    """out and lse by the plain TF32 forward (the kernels' input)."""
    out, lse = attn.attention_reference_tf32(
        *(torch.from_numpy(x) for x in (q, k, v)), scale,
        None if bias is None else torch.from_numpy(bias), return_lse=True)
    return out.numpy(), lse.numpy()


def _errors(got, q, k, v, g, bias, out, lse, scale):
    """{name: (err, plain err)} of each gradient against float64 autograd
    of the same inputs' attention."""
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    bt = None if bias is None else torch.from_numpy(bias)
    ins = [x.double().requires_grad_() for x in (qt, kt, vt)]
    b64 = None if bt is None else bt.double().requires_grad_()
    o64, _ = attn.attention_reference_lse(*ins, b64, scale)
    wrt = ins + ([] if b64 is None else [b64])
    want = torch.autograd.grad(o64, wrt, gt.double())
    plain = attn.flash_attention_bwd_reference(
        qt, kt, vt, bt, gt, torch.from_numpy(out), torch.from_numpy(lse),
        scale, tf32=True)
    return {n: (np.abs(x - w.numpy()).max(), (px.double() - w).abs().max()
                .item())
            for n, x, w, px in zip(("dq", "dk", "dv", "dbias"), got, want,
                                   plain)}


# ragged queries and keys, multi-query k/v, every launched head dim class:
# a partial query block, a last key tile of 1 to BK - 1 keys, one tile
EMU_CASES = [(1, 1, 1, 100, 130, 8), (1, 2, 1, 70, 65, 32),
             (1, 1, 1, 129, 97, 52), (1, 2, 2, 64, 64, 64),
             (1, 1, 1, 70, 33, 128)]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulated_kernels_match_the_plain_version(case):
    b, h, hkv, tq, tk, d = case
    q, k, v, g, _ = _case(sum(case), b, h, hkv, tq, tk, d)
    scale = d ** -0.5
    out, lse = _forward(q, k, v, None, scale)
    got = emulate(q, k, v, g, out, lse, scale)
    assert all(np.isfinite(x).all() for x in got)
    for name, (err, plain_err) in _errors(got, q, k, v, g, None, out, lse,
                                          scale).items():
        assert err <= 1.5 * plain_err, (name, err, plain_err)


def test_last_key_tile_needs_its_mask():
    # TMA fills keys past Tk with zeros: a zero logit, p = exp(-lse) != 0;
    # with a row whose lse is far below -88 (exp(-lse) overflows) an
    # unmasked p times a zero K row poisons its dq
    q, k, v, g, _ = _case(5, 1, 1, 1, 70, 100, 32)
    k[..., 0] = 4.0
    q[0, 0, 3] = 0.0
    q[0, 0, 3, 0] = -300.0
    scale = 32 ** -0.5
    out, lse = _forward(q, k, v, None, scale)
    assert lse[0, 0, 3] < -88.0
    args = (q[0, 0], k[0, 0], v[0, 0], g[0, 0], out[0, 0], lse[0, 0], scale)
    with np.errstate(invalid="ignore"):
        bad, _ = emulate_dq(*args, mask=False)
    assert not np.isfinite(bad[3]).all()
    good, _ = emulate_dq(*args)
    assert np.isfinite(good).all()


@pytest.mark.parametrize("case", [(2, 5, 70, 90, 52), (3, 4, 130, 33, 8),
                                  (2, 9, 65, 140, 64)],
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_prior_kernels_match_the_plain_version(case):
    # the on-chip sums: dbias over the batch, dk/dv over the consumers and
    # a cluster of 4 head groups (5 heads: groups of 2, 2, 1 and none; 9:
    # 3, 3, 3 and none), an odd and an even count of key tiles
    b, h, tq, tk, d = case
    q, k, v, g, bias = _case(sum(case), b, h, 1, tq, tk, d, biased=True)
    scale = d ** -0.5
    out, lse = _forward(q, k, v, bias, scale)
    got = emulate_prior(q, k, v, g, out, lse, bias, scale)
    assert all(np.isfinite(x).all() for x in got)
    for name, (err, plain_err) in _errors(got, q, k, v, g, bias, out, lse,
                                          scale).items():
        assert err <= 1.5 * plain_err, (name, err, plain_err)


def _jax_rel(got, want, plain):
    """(|got - JAX|, |plain - JAX|) relative to max |JAX|."""
    w = np.asarray(want, np.float32)
    scale = np.abs(w).max()
    return (np.abs(got - w).max() / scale,
            np.abs(np.asarray(plain, np.float32) - w).max() / scale)


# The emulated kernels against the JAX package's Pallas backward in
# interpret mode on the same f32 inputs: JAX multiplies in f32, the kernels
# in TF32, so each gradient is held within 1.5x the plain TF32 version's
# distance from JAX (relative to max |JAX|): the same TF32 rounding, summed
# in another order
@pytest.mark.parametrize("biased", [False, True])
def test_emulated_kernels_match_pallas_interpret(biased):
    b, h, tq, tk, d = (2, 3, 70, 90, 52) if biased else (1, 2, 130, 150, 32)
    q, k, v, g, bias = _case(11 + d, b, h, 1 if biased else h, tq, tk, d,
                             biased)
    scale = d ** -0.5
    out, lse = _forward(q, k, v, bias, scale)
    j = jnp.asarray
    if biased:
        got = emulate_prior(q, k, v, g, out, lse, bias, scale)
        want = jattn._flash_bwd_pallas_bias(j(q), j(k), j(v), j(bias), j(g),
                                            j(out), j(lse), scale, True)
    else:
        got = emulate(q, k, v, g, out, lse, scale)
        want = jattn._flash_bwd_pallas(j(q), j(k), j(v), j(g), j(out), j(lse),
                                       scale, True)
    assert want is not None
    plain = attn.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias),
        torch.from_numpy(g), torch.from_numpy(out), torch.from_numpy(lse),
        scale, tf32=True)
    for name, x, w, px in zip(("dq", "dk", "dv", "dbias"), got, want, plain):
        err, plain_err = _jax_rel(x, w, px.numpy())
        assert err <= 1.5 * plain_err, (name, err, plain_err)


# ---------------------------------------------------------------------------
# the mbarrier rings: full (the copies landed), ready (the producer's pass),
# empty (the consumers that read the stage are done); each tile read by
# every consumer (the unbiased passes) or by one, in turn (the prior's)

def ring_walk(ntiles, stages, cons, owner, seed):
    """Random interleavings of the producer (thread 0 issues tiles 0 ..
    S - 1, then, after each tile's pass, tile t - 1 + S once tile t - 1's
    stage is empty; the warpgroup's pass of tile t after its full barrier,
    then 128 arrivals on ready) and `cons` consumers (consumer c reads the
    tiles t with c in owner(t), releasing each stage on empty, whose count
    is the tile's readers), with TMA copies that land at random later
    steps. Asserts that no pass reads a tile before it landed, no consumer
    reads one before its pass, and no copy lands in a stage still read."""
    rnd = random.Random(seed)
    readers = {len(owner(t)) for t in range(ntiles)}
    assert len(readers) == 1
    full = [MBarrier(1) for _ in range(stages)]
    ready = [MBarrier(128) for _ in range(stages)]
    empty = [MBarrier(min(readers)) for _ in range(stages)]
    data, passed = [None] * stages, [None] * stages
    busy = [set() for _ in range(stages)]
    in_flight = []

    def load(t):
        full[t % stages].arrive(expect_tx=1)
        in_flight.append((t % stages, t))

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
            yield
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
            if cw not in owner(t):
                continue
            s, parity = t % stages, (t // stages) & 1
            while not ready[s].try_wait(parity):
                yield
            assert passed[s] == t, "a product read a tile before its pass"
            busy[s].add(cw)
            yield
            busy[s].discard(cw)
            empty[s].arrive()
            yield

    def tma():
        while True:
            if in_flight and rnd.random() < 0.5:
                s, tt = in_flight.pop(rnd.randrange(len(in_flight)))
                assert not busy[s], "a copy landed in a stage in use"
                data[s] = tt
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


@pytest.mark.parametrize("ring", [
    (2, 2, "all"), (3, 2, "all"), (3, 3, "all"),      # the unbiased passes
    (3, 2, "even/odd key tiles"), (3, 2, "in turn")])  # the prior's
@pytest.mark.parametrize("ntiles", [1, 2, 5, 17])
def test_mbarrier_ring_walk(ntiles, ring):
    stages, cons, kind = ring
    if kind == "all":
        def owner(t):
            return set(range(cons))
    elif kind == "in turn":
        def owner(t):
            return {t % 2}
    else:  # (b, key tile) steps of 3 key tiles a row: kt % 2
        def owner(t):
            return {(t % 3) % 2}
    for seed in range(10):
        assert ring_walk(ntiles, stages, cons, owner, seed) > 0


# ---------------------------------------------------------------------------
# plans, routes

@pytest.mark.parametrize("d", list(range(8, 129, 4)))
def test_tiles_fit_shared_memory_and_keep_swizzle_alignment(d):
    p = plan(d)
    dn, dks = p["dn"], p["dks"]
    assert p["smem_q"] <= 232448 and p["smem_kv"] <= 232448
    for rows in (p["rows_q"], p["bk"], p["rows_kv"], p["bq"]):
        assert (rows * dks * 4) % 1024 == 0 and rows % 32 == 0
    for rows in (p["bk"], p["bq"]):
        assert (dn * rows * 4) % 1024 == 0  # the transposes' blocks
    assert p["bw"] <= d and (p["nb"] - 1) * p["bw"] < d and dn <= dks
    # two dK/dV consumers of 64 keys, sharing one 64-key block past DN 64;
    # three dQ consumers up to DN 32
    assert p["rows_kv"] == (64 if dn > 64 else 128)
    assert p["rows_q"] == (192 if dn <= 32 else 128)
    if dn <= 64:
        bp = bias_plan(d, 576)
        assert bp["smem1"] <= 232448 and bp["smem2"] <= 232448
        assert bias_plan(d, 514)["smem1"] == bp["smem1"] - 8192


def test_prior_shared_memory_forces_the_32_key_tiles():
    # a 64-query x 576-key dbias accumulator beside a 3-stage ring of
    # 64-key K, V and K^T tiles at d 52 would pass a block's 232,448 bytes;
    # the 32-key tiles fit at every Tk up to 576
    acc = 64 * 576 * 4
    assert acc + 3 * (2 * 64 * 64 * 4 + 56 * 64 * 4) > 232448
    assert bias_plan(52, 576)["smem1"] <= 232448
    assert bias_plan(52, 514)["smem1"] == (17 * 8192 + 3 * (2 * 32 * 64 * 4
                                                            + 56 * 32 * 4)
                                           + 72 + 1024)


STEP_SHAPES = [(10, 32, 513, 514, 52, True), (60, 1, 256, 256, 128, False),
               (60, 1, 1024, 1024, 64, False), (60, 1, 4096, 4096, 32, False)]


@pytest.mark.parametrize("shape", STEP_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_routes_of_the_f32_step_sites(shape):
    *_, tk, d, biased = shape
    route = attn.flash_bwd_route(d, torch.float32, biased=biased,
                                 head_bias=biased, tk=tk)
    assert route == (attn.TF32_BWD_BIAS_WGMMA_ROUTE if biased
                     else attn.TF32_BWD_WGMMA_ROUTE)
    # the bf16 step's launches keep their kernels
    assert attn.flash_bwd_route(d, torch.bfloat16, biased=biased,
                                head_bias=biased, tk=tk) == (
        attn.BWD_BIAS_WGMMA_ROUTE if biased else attn.BWD_WGMMA_ROUTE)


@pytest.fixture
def register_tiles(monkeypatch):
    """The register backward's library answer at f32 up to d 128 (code 4,
    `flash_attn_bwd_tiles`) without nvcc, the route's cache cleared around
    it, so that a route test can name the register kernels on the CPU."""
    attn.flash_bwd_route.cache_clear()
    monkeypatch.setattr(attn, "_tiles", lambda d, dtype, kernel: (4, None))
    yield
    attn.flash_bwd_route.cache_clear()


REGISTER = "flash_bwd_dkdv_tf32_kernel+flash_bwd_dq_tf32_kernel"


@pytest.mark.parametrize("d", list(range(8, 129, 4)))
def test_routes_by_head_dim(d, register_tiles):
    f32 = torch.float32
    assert attn.flash_bwd_route(d, f32) == attn.TF32_BWD_WGMMA_ROUTE
    biased = attn.flash_bwd_route(d, f32, biased=True, head_bias=True,
                                  tk=514)
    assert biased == (attn.TF32_BWD_BIAS_WGMMA_ROUTE if d <= 64 else REGISTER)


def test_routes_the_register_kernels_keep(register_tiles):
    f32, reg = torch.float32, REGISTER
    for d in (4, 52, 128):
        assert attn.flash_bwd_route(d, f32, aligned=False) == reg
    assert attn.flash_bwd_route(52, f32, biased=True) == reg  # other layouts
    for tk in (0, 577):
        assert attn.flash_bwd_route(52, f32, biased=True, head_bias=True,
                                    tk=tk) == reg
    assert attn.tf32_wgmma_dn(4) == 0
    # the tiny CLI chain's f32 launches (d 8 and 16) take the wgmma kernels
    for d in (8, 16):
        assert attn.flash_bwd_route(d, f32) == attn.TF32_BWD_WGMMA_ROUTE


# ---------------------------------------------------------------------------
# the port's f32 backward against the JAX package's (the Pallas kernels in
# interpret mode; f32 arithmetic on both sides up to summation order)

@pytest.mark.parametrize("biased", [False, True])
def test_port_f32_backward_matches_the_jax_kernels(biased):
    b, h, tq, tk, d = (2, 4, 129, 130, 52) if biased else (1, 2, 130, 140, 64)
    q, k, v, g, bias = _case(d + tq, b, h, 1 if biased else h, tq, tk, d,
                             biased)
    scale = d ** -0.5
    j = jnp.asarray
    out, lse = jattn._flash_attention_impl(
        j(q), j(k), j(v), None if bias is None else j(bias), interpret=True,
        return_lse=True)
    if biased:
        want = jattn._flash_bwd_pallas_bias(j(q), j(k), j(v), j(bias), j(g),
                                            out, lse, scale, True)
    else:
        want = jattn._flash_bwd_pallas(j(q), j(k), j(v), j(g), out, lse,
                                       scale, True)
    got = attn.flash_attention_bwd(
        t(q), t(k), t(v), None if bias is None else t(bias), t(g),
        t(np.asarray(out)), t(np.asarray(lse)), scale)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert x.shape == w.shape, name
        assert rel_err(x, w) <= 1e-4, name


# ---------------------------------------------------------------------------
# chip_smoke.py's gate on the instances

def _ptxas(kernel, dn, registers, spill=0):
    """One -Xptxas -v entry of a TF32 wgmma backward instance (the mangled
    name nvcc gives a kernel in an anonymous namespace)."""
    name = f"flash_bwd_{kernel}_tf32_wgmma_kernel"
    return dict(source="flash_attn_bwd_tf32_sm90", function=(
        f"_ZN60_GLOBAL__N__079e014d_27_flash_attn_bwd_tf32_sm90_cu_f9bac4fd"
        f"{len(name)}{name}ILi{dn}EEEv14CUtensorMap_stS1_S1_S1_NS_"
        f"13BwdTf32ParamsE"), registers=registers, spill_stores=spill,
        spill_loads=spill)


def test_chip_smoke_gates_the_instances():
    # chip_smoke.py reads the 48 instances (the unbiased pair at DN 8 ..
    # 128, the prior's pair at DN 8 .. 64) and raises on a missing one, a
    # spill or a serialized product (C751x in the build log); the register
    # kernels' and the bf16 wgmma kernels' names are not theirs
    ptxas = ([_ptxas(k, dn, 120) for k in ("dq", "dkdv")
              for dn in range(8, 129, 8)]
             + [_ptxas(k, dn, 150) for k in ("dq_bias", "dkdv_bias")
                for dn in range(8, 65, 8)])
    others = [dict(source="flash_attn_bwd", registers=200, function=(
        "_ZN50_GLOBAL__N__0_flash_attn_bwd_cu24flash_bwd_dq_tf32_kernelILi64E"
        "Lb0EEEvNS_6ParamsE")), dict(source="flash_attn_bwd_sm90",
                                     registers=168, function=(
        "_ZN55_GLOBAL__N__0_flash_attn_bwd_sm90_cu25flash_bwd_dq_wgmma_kernel"
        "ILi64EEEv14CUtensorMap_stS1_S1_S1_NS_9BwdParamsE"))]
    got = chip_smoke.tf32_wgmma_bwd_instances(ptxas + others, build_log="")
    assert len(got) == 48
    with pytest.raises(AssertionError):  # an instance is missing
        chip_smoke.tf32_wgmma_bwd_instances(ptxas[1:], build_log="")
    with pytest.raises(AssertionError):  # an instance spills
        chip_smoke.tf32_wgmma_bwd_instances(
            ptxas[1:] + [_ptxas("dq", 8, 128, 20)], build_log="")
    serialized = ("ptxas warning : (C7515) Potential Performance Loss: "
                  "wgmma.mma_async instructions are serialized")
    with pytest.raises(AssertionError):
        chip_smoke.tf32_wgmma_bwd_instances(ptxas, build_log=serialized)
