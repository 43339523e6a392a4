"""The head-bias wgmma kernels of the prior's biased multi-query attention
(neurons_tpu_torch/csrc/flash_attn_fwd_bias_sm90.cu,
csrc/flash_attn_bwd_bias_sm90.cu): CPU emulation by index and card tests.

This file imports no JAX, so its card tests (marker `cuda`, each skipping
without a card, decided in a fixture) also run where JAX is absent:

    python -m pytest tests/test_torch_port_wgmma_bias.py --noconftest -q

On the CPU the tests replay what the kernels do: the 8-byte cp.async
pieces of 104-byte rows written into 128-byte swizzled tiles (pads zero),
read back through the K-major and MN-major descriptors the products use;
the conflict-free reads of pass 2's bias tile; the forward's key-tile walk
(bias, mask, online softmax with expf, P rounded to bf16); the backward's
two passes with their own orders of summation (pass 1: the key tiles split
between two warpgroups, dQ handed over and added in warpgroup order, dbias
summed over the batch rows in order; pass 2: dK/dV summed over each head
group's heads in order and over the cluster's groups in rank order), the
probabilities by ex2 and the rounding points (P and dS * scale to bf16); the
routes and the plan. The emulated kernels are held to the plain versions as
the card tests hold the kernels: within 1.5x the bf16 plain version's error
against float64. On the card each kernel is held to its plain version at the
prior's shape and at small ragged shapes, a rerun giving equal bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from neurons_tpu_torch.ops import attention as attn
from test_torch_port_wgmma_fwd import (a_layout, c_layout, pack_p,
                                       read_k_major, read_mn_major, swizzle)

SMEM_LIMIT = 232448  # the 227 KB a block may use
SM_SMEM = 233472     # an SM's 228 KB, 1 KB of it reserved a block
HEAD_DIMS = [32, 40, 52, 64]
LOG2E = np.float32(1.4426950408889634)
PRIOR = (10, 32, 513, 514, 52)  # B, H, Tq, Tk, D (PriorConfig, stage 2)


# ---------------------------------------------------------------------------
# the routes, the layout, the plan

def test_routes_of_the_prior_launches():
    bf = torch.bfloat16
    fwd = attn.flash_route(52, bf, biased=True, lse=True, head_bias=True,
                           tk=514)
    bwd = attn.flash_bwd_route(52, bf, biased=True, head_bias=True, tk=514)
    assert fwd == attn.BIAS_WGMMA_ROUTE == "flash_fwd_bias_wgmma_kernel"
    assert bwd == attn.BWD_BIAS_WGMMA_ROUTE
    assert bwd.split("+") == ["flash_bwd_dq_bias_wgmma_kernel",
                              "flash_bwd_dkdv_bias_wgmma_kernel"]
    # the forward without the lse takes it too (no path launches it)
    assert attn.flash_route(52, bf, biased=True, head_bias=True,
                            tk=514) == fwd


@pytest.mark.parametrize("case", [
    dict(dtype=torch.float32),            # the f32 step: TF32 kernels
    dict(head_bias=False),                # bias modes 1 / 3, 4-byte rows
    dict(d=68), dict(d=128),              # past 64: no instance
    dict(d=50),                           # off a multiple of 4
    dict(tk=577), dict(tk=0),             # K/V and dbias past shared memory
    dict(biased=False)])
def test_routes_off_the_head_bias_kernels(case):
    kw = dict(d=52, dtype=torch.bfloat16, biased=True, head_bias=True,
              tk=514)
    kw.update(case)
    assert not attn.takes_head_bias_kernels(**kw)
    d, dt = kw.pop("d"), kw.pop("dtype")
    if dt == torch.bfloat16 and kw["biased"] and d <= 128:
        # the register kernels keep them (the forward's route asks the
        # library for its tiles: a card test names it)
        assert attn.flash_bwd_route(d, dt, **kw) == (
            "flash_bwd_dkdv_reg_kernel+flash_bwd_dq_reg_kernel")


def _slices(shape, dtype=torch.bfloat16, pad=0):
    x = torch.zeros(shape[:-1] + (shape[-1] + pad,), dtype=dtype)
    return x[..., :shape[-1]]


@pytest.mark.parametrize("case,want", [
    (dict(), True),                       # the prior's: [H, Tq, Tk], mode 2
    (dict(mode=1), False), (dict(mode=3), False),
    (dict(kv_heads=32), False),           # k/v per head
    (dict(granule=4), False),             # 4-byte rows
    (dict(granule=16), True),
    (dict(pad=1), False),                 # an odd row stride (1030 bytes)
    (dict(pad=2), True)])
def test_head_bias_layout_from_shapes_and_strides(case, want):
    kw = dict(mode=2, h=32, kv_heads=1, granule=8, pad=0)
    kw.update(case)
    bias3 = _slices((32, 513, 514), pad=kw.pop("pad"))
    assert attn.head_bias_layout(bias3, kw["mode"], kw["h"], kw["kv_heads"],
                                 kw["granule"]) is want


def test_prior_rows_move_in_8_byte_pieces():
    # the model's q: one Linear output [B, T, H * 52] viewed as [B, H, T,
    # 52]: 104-byte rows, 3328-byte token strides
    x = torch.zeros((2, 513, 32 * 52), dtype=torch.bfloat16)
    q = x.reshape(2, 513, 32, 52).transpose(1, 2)
    kv = torch.zeros((2, 514, 52), dtype=torch.bfloat16)[:, None]
    strides = (q.stride(0), q.stride(1), q.stride(2)) + \
        attn._kv_strides(kv, 32) * 2
    assert attn._granule(52, 2, strides, (q, kv)) == 8
    # 54-element rows (108 bytes) move in 4: the register kernels
    q54 = torch.zeros((2, 32, 513, 54), dtype=torch.bfloat16)[..., :52]
    assert attn._granule(52, 2, (q54.stride(0), q54.stride(1),
                                 q54.stride(2)), (q54,)) == 4


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_fits_shared_memory(d):
    dn = attn.bias_wgmma_dn(d)
    assert dn >= d and dn % 8 == 0 and dn - d < 24
    fwd, dq, dkdv = attn.bias_wgmma_smem(d)
    assert max(fwd, dq, dkdv) <= SMEM_LIMIT
    # pass 2's blocks an SM (registers at 128 threads x 168; shared memory)
    assert attn.BIAS_WGMMA_MIN_BLOCKS * (dkdv + 1024) <= SM_SMEM
    # pass 2 parks dK and dV (f32, 128 threads) in its Q / g ring
    assert 2 * dn // 2 * 128 * 4 <= 4 * 64 * 128


def test_grids_at_the_prior_shape():
    fwd, dq, dkdv = attn.bias_wgmma_grids(*PRIOR[:4])
    assert fwd == 3 * 10 * 32           # 192 query rows a block
    assert dq == 32 * 9                 # a head and 64 queries a block
    assert dkdv == 10 * 9 * 4           # (b, 64 keys) x 4 head groups
    assert dkdv % attn.BIAS_WGMMA_GROUPS == 0  # whole clusters
    # three pass-2 blocks an SM: one wave on 132 SMs
    assert dkdv <= 132 * attn.BIAS_WGMMA_MIN_BLOCKS


# ---------------------------------------------------------------------------
# shared memory: the 8-byte pieces' swizzled places, the descriptors' reads

def swz(r, j):
    """The kernels' swz (csrc/flash_bias_sm90.cuh): byte offset of 8-byte
    piece j of row r in a tile of 128-byte rows."""
    return r * 128 + (((j >> 1) ^ (r & 7)) << 4) + ((j & 1) << 3)


def stage(mat, tile_rows=64):
    """A [rows, D] bf16-valued matrix staged as the kernels stage it: D / 4
    pieces a row at swz, pads zeroed, rows past the matrix zero-filled.
    Returns the tile as bf16 elements (the byte address // 2)."""
    smem = np.full(tile_rows * 64, np.nan, np.float32)  # unwritten = NaN
    rows, d = mat.shape
    np_ = d // 4
    for r in range(tile_rows):
        for j in range(16):
            at = swz(r, j) // 2
            vals = (mat[r, 4 * j:4 * j + 4] if r < rows and j < np_
                    else np.zeros(4, np.float32))
            smem[at:at + 4] = vals
    return smem


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_staged_pieces_are_the_swizzled_box(d):
    # the pieces land where a 128-byte-swizzled box of the padded rows
    # would: byte (r, c) at swizzle(r * 128 + c)
    rng = np.random.default_rng(d)
    mat = rng.standard_normal((50, d)).astype(np.float32)
    smem = stage(mat)
    want = np.zeros((64, 64), np.float32)
    want[:50, :d] = mat
    r, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    box = np.empty(64 * 64, np.float32)
    box[swizzle(r * 128 + 2 * c, 128) // 2] = want
    assert np.array_equal(smem, box)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_descriptors_read_the_staged_rows(d):
    rng = np.random.default_rng(100 + d)
    mat = rng.standard_normal((64, d)).astype(np.float32)
    smem = stage(mat)
    pad = np.zeros((64, 64), np.float32)
    pad[:, :d] = mat
    ks = (attn.bias_wgmma_dn(d) + 15) // 16
    # K-major (S = Q K^T, S^T = K Q^T): k16 step ks 32 bytes on, SBO 8 rows
    for s in range(ks):
        got = read_k_major(smem, 32 * s, 64, 8 * 128, 128)
        assert np.array_equal(got, pad[:, 16 * s:16 * s + 16])
    # the depth past ks k16 steps is zero: nothing is left out of S
    assert not pad[:, 16 * ks:].any()
    # MN-major (O += P V, dQ += dS K, dV += P^T g, dK += dS^T Q): N = DN
    # columns, a k16 step 16 rows on, LBO one tile, SBO 8 rows
    dn = attn.bias_wgmma_dn(d)
    for kk in range(4):
        got = read_mn_major(smem, kk * 16 * 128, dn, 64 * 128, 8 * 128, 128)
        assert np.array_equal(got, pad[16 * kk:16 * kk + 16, :dn])


def test_pass2_bias_tile_reads_are_conflict_free():
    # pass 2 reads bias[q][k] (2 bytes) at q * 144 + 2 k for its S^T
    # registers: key rows g, g + 8 of its warp, query columns 8 i + 2 t +
    # (e & 1); each warp-wide read hits each bank in one 4-byte word
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for warp in range(4):
        for i in range(8):
            for e in range(4):
                q = 8 * i + 2 * t + (e & 1)
                k = 16 * warp + g + 8 * (e >> 1)
                word = (q * 144 + 2 * k) // 4
                banks = {}
                for bank, w in zip(word % 32, word):
                    banks.setdefault(bank, set()).add(w)
                assert all(len(ws) == 1 for ws in banks.values())


def test_dbias_accumulator_is_each_threads_own():
    # pass 1's [tile][32][128] f32 layout: element (tile, register, thread)
    # of 64 x 576 once, and a warp's access one 128-byte line
    row, col = c_layout(64)  # [128, 32]: the register's (query, key)
    seen = np.zeros((64, 9 * 64), int)
    for kt in range(9):
        np.add.at(seen, (row, 64 * kt + col), 1)
    assert (seen == 1).all()
    addr = (np.arange(32)[None, :] * 128 + np.arange(128)[:, None]) * 4
    for j in range(32):
        for w in range(4):
            lines = set(addr[32 * w:32 * w + 32, j] // 128)
            assert len(lines) == 1


def test_ds_hands_off_to_the_gradient_products():
    # dS * scale (pass 1) and P^T, dS^T * scale (pass 2) go from the S-shaped
    # accumulator into A fragments without a shuffle, as P does forward
    rng = np.random.default_rng(1)
    s = rng.standard_normal((64, 64)).astype(np.float32)
    row, col = c_layout(64)
    pa = pack_p(s[row, col])
    ar, ak = a_layout()
    p = np.zeros_like(s)
    for kk in range(4):
        p[ar, 16 * kk + ak] = pa[:, kk]
    assert np.array_equal(p, s)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, tile by tile

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _mm(a, b):  # a tensor-core product: bf16 operands, sums in f32 (f64 here)
    return _f32(np.asarray(a, np.float64) @ np.asarray(b, np.float64))


def emulate_fwd(q, k, v, bias, scale):
    """The forward kernel on bf16-valued f32 arrays q [B, H, Tq, D], k, v
    [B, 1, Tk, D], bias [H, Tq, Tk]: per (b, h), key tiles of 64 with the
    bias, keys past Tk at -inf, the online softmax with exp, P rounded to
    bf16; (out bf16-valued, lse)."""
    b_, h_, tq, d = q.shape
    tk = k.shape[2]
    out = np.zeros_like(q)
    lse = np.zeros((b_, h_, tq), np.float32)
    for b in range(b_):
        for h in range(h_):
            m = np.full(tq, -np.inf, np.float32)
            l = np.zeros(tq, np.float32)
            o = np.zeros((tq, d), np.float32)
            for t0 in range(0, tk, 64):
                keys = np.arange(t0, t0 + 64)
                kt = np.zeros((64, d), np.float32)
                vt = np.zeros((64, d), np.float32)
                ok = keys < tk
                kt[ok], vt[ok] = k[b, 0, keys[ok]], v[b, 0, keys[ok]]
                bt = np.zeros((tq, 64), np.float32)
                bt[:, ok] = bias[h][:, keys[ok]]
                x = _f32(_mm(q[b, h], kt.T).astype(np.float64) * scale + bt)
                x[:, ~ok] = -np.inf
                mx = np.maximum(m, x.max(1))
                alpha = np.exp(m - mx).astype(np.float32)
                p = np.exp(x - mx[:, None]).astype(np.float32)
                l = _f32(l * alpha + p.sum(1, dtype=np.float64))
                o = _f32(o * alpha[:, None] + _mm(_bf16(p), vt))
                m = mx
            out[b, h] = _bf16(o / l[:, None])
            lse[b, h] = m + np.log(np.maximum(l, 1e-30))
    return out, lse


def emulate_bwd(q, k, v, bias, g, out, lse, scale, groups=4):
    """The backward's two passes on bf16-valued f32 arrays (the kernels'
    loops at tile granularity, their orders of summation and rounding
    points): (dq, dk, dv, dbias), bf16-valued."""
    b_, h_, tq, d = q.shape
    tk = k.shape[2]
    nkt = -(-tk // 64)
    n0 = (nkt + 1) // 2
    keys = [np.arange(64 * t, min(64 * t + 64, tk)) for t in range(nkt)]
    delta = np.zeros((b_, h_, tq), np.float32)
    dq = np.zeros_like(q)
    dbias = np.zeros((h_, tq, tk), np.float32)

    def probs(b, h, kk):
        x = _f32(_mm(q[b, h], k[b, 0, kk].T).astype(np.float64) * scale
                 + bias[h][:, kk])
        return _f32(np.exp2(_f32((x - lse[b, h][:, None]) * LOG2E)))

    # pass 1: per head (the query tiles are independent rows), batch rows
    # in order; the first warpgroup's key tiles, the second's, added in
    # warpgroup order; dbias summed over the rows in order
    for h in range(h_):
        acc = np.zeros((tq, tk), np.float32)
        for b in range(b_):
            delta[b, h] = _f32((np.asarray(g[b, h], np.float64)
                                * out[b, h]).sum(1))
            part = []
            for tiles in (range(n0), range(n0, nkt)):
                dqw = np.zeros((tq, d), np.float32)
                for t in tiles:
                    kk = keys[t]
                    p = probs(b, h, kk)
                    dp = _mm(g[b, h], v[b, 0, kk].T)
                    ds = _f32(p * (dp - delta[b, h][:, None]))
                    acc[:, kk] = ds if b == 0 else _f32(acc[:, kk] + ds)
                    dqw = _f32(dqw + _mm(_bf16(ds * scale), k[b, 0, kk]))
                part.append(dqw)
            dq[b, h] = _bf16(part[0] + part[1])
        dbias[h] = _bf16(acc)
    # pass 2: per (b, key tile), head groups of ceil(H / groups) heads, each
    # summing its heads' dK / dV in order; the groups summed in rank order
    dk = np.zeros((b_, 1, tk, d), np.float32)
    dv = np.zeros_like(dk)
    hg = -(-h_ // groups)
    for b in range(b_):
        for kk in keys:
            gk, gv = [], []
            for grp in range(groups):
                ak = np.zeros((len(kk), d), np.float32)
                av = np.zeros_like(ak)
                for h in range(grp * hg, min(h_, grp * hg + hg)):
                    pt = probs(b, h, kk).T
                    dpt = _mm(v[b, 0, kk], g[b, h].T)
                    dst = _f32(pt * (dpt - delta[b, h][None, :]) * scale)
                    av = _f32(av + _mm(_bf16(pt), g[b, h]))
                    ak = _f32(ak + _mm(_bf16(dst), q[b, h]))
                gk.append(ak)
                gv.append(av)
            sk, sv = gk[0], gv[0]
            for r in range(1, groups):
                sk, sv = _f32(sk + gk[r]), _f32(sv + gv[r])
            dk[b, 0, kk], dv[b, 0, kk] = _bf16(sk), _bf16(sv)
    return dq, dk, dv, dbias


def _case(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return _bf16(rng.standard_normal(shape) * s)

    return (r(b, h, tq, d, s=d ** -0.25), r(b, 1, tk, d, s=d ** -0.25),
            r(b, 1, tk, d), r(h, tq, tk), r(b, h, tq, d))


def _oracle(q, k, v, bias, g, scale):
    ins = [torch.from_numpy(x).double().requires_grad_()
           for x in (q, k, v, bias)]
    o, lse = attn.attention_reference_lse(*ins[:3], ins[3], scale)
    grads = torch.autograd.grad(o, ins, torch.from_numpy(g).double())
    return [x.detach().numpy() for x in (o, lse) + grads]


def _plain(q, k, v, bias, g, scale):
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v, bias, g)]
    o, lse = attn.attention_reference_lse(*t[:3], t[3], scale)
    grads = attn.flash_attention_bwd_reference(*t[:4], t[4], o, lse, scale)
    return [x.float().numpy() for x in (o, lse) + tuple(grads)]


NAMES = ("out", "lse", "dq", "dk", "dv", "dbias")
SMALL = [(2, 3, 129, 130, 52), (1, 5, 70, 64, 52), (2, 6, 65, 193, 40),
         (1, 4, 100, 150, 32), (1, 3, 64, 77, 64)]


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
def test_emulated_kernels_match_the_plain_version(shape):
    q, k, v, bias, g = _case(sum(shape), *shape)
    scale = 0.9
    want = _oracle(q, k, v, bias, g, scale)
    plain = _plain(q, k, v, bias, g, scale)
    out, lse = emulate_fwd(q, k, v, bias, scale)
    grads = emulate_bwd(q, k, v, bias, g, out, lse, scale)
    for name, got, p, w in zip(NAMES, (out, lse) + grads, plain, want):
        err = np.abs(got - w).max()
        perr = np.abs(p - w).max()
        assert err <= 1.5 * perr, (name, err, perr)


def test_emulated_backward_without_the_second_warpgroup():
    # one key tile: pass 1's second warpgroup has no keys and hands nothing
    # over; heads fewer than the cluster's groups leave groups empty
    q, k, v, bias, g = _case(5, 2, 3, 80, 60, 52)
    out, lse = emulate_fwd(q, k, v, bias, 1.0)
    got = emulate_bwd(q, k, v, bias, g, out, lse, 1.0)
    want = _oracle(q, k, v, bias, g, 1.0)[2:]
    plain = _plain(q, k, v, bias, g, 1.0)[2:]
    for x, p, w in zip(got, plain, want):
        assert np.abs(x - w).max() <= 1.5 * np.abs(p - w).max()


def test_masks_are_needed():
    # keys past Tk in the last tile: without the mask the forward's zero-
    # filled rows would take probability (exp(bias) with a zero logit)
    q, k, v, bias, g = _case(9, 1, 2, 64, 70, 52)
    kp = np.concatenate([k, np.zeros((1, 1, 58, 52), np.float32)], 2)
    vp = np.concatenate([v, np.zeros((1, 1, 58, 52), np.float32)], 2)
    bp = np.concatenate([bias, np.zeros((2, 64, 58), np.float32)], 2)
    out, _ = emulate_fwd(q, k, v, bias, 1.0)
    unmasked, _ = emulate_fwd(q, kp, vp, bp, 1.0)
    assert np.abs(out - unmasked).max() > 1e-2


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bias_wgmma_plan_matches_the_python_tables(cuda, d):
    fwd, bwd = attn.bias_wgmma_plan(d)
    smem = attn.bias_wgmma_smem(d)
    dn = attn.bias_wgmma_dn(d)
    assert fwd == (dn, attn.BIAS_WGMMA_BQ, attn.BIAS_WGMMA_BK,
                   attn.BIAS_WGMMA_MAX_TILES, attn.BIAS_WGMMA_BQ * 2,
                   smem[0])
    assert bwd == (dn, 64, 256, smem[1], 64, attn.BIAS_WGMMA_GROUPS,
                   attn.BIAS_WGMMA_MIN_BLOCKS, 128, smem[2])
    assert attn.bias_wgmma_plan(68) is None


def _launch_route(counter, before):
    grown = [r for (r, _), n in counter.by_route.items()
             if n > before.get((r, _), 0)]
    assert len(grown) == 1, grown
    return grown[0]


def _check_on_card(q, k, v, bias, g, scale, route=True):
    """The head-bias kernels (or, route=False, the kernels the route names)
    against float64 autograd, each held to its plain version on the same
    inputs: the forward's out and lse within 1.5x the bf16 plain forward's
    error; the backward, fed the kernel forward's out and lse, within 1.5x
    the error of the plain backward fed the same (a chain of both plain
    passes would also carry the two forwards' different roundings of out
    into delta, and at one query row that alone moved dq's max error by
    1.4-1.6x either way); a rerun gives equal bits. Returns {name: (err,
    plain err)}."""
    fb = dict(attn.FLASH_FWD_LAUNCHES.by_route)
    out, lse = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                        return_lse=True)
    took_f = _launch_route(attn.FLASH_FWD_LAUNCHES, fb)
    bb = dict(attn.FLASH_BWD_LAUNCHES.by_route)
    grads = attn.flash_attention_bwd(q, k, v, bias, g, out, lse, scale)
    took_b = _launch_route(attn.FLASH_BWD_LAUNCHES, bb)
    if route:
        assert took_f == attn.BIAS_WGMMA_ROUTE
        assert took_b == attn.BWD_BIAS_WGMMA_ROUTE
    out2, lse2 = attn.flash_attention_fwd(q, k, v, scale=scale, bias=bias,
                                          return_lse=True)
    again = attn.flash_attention_bwd(q, k, v, bias, g, out, lse, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    torch.cuda.synchronize()
    ins = [x.detach().double().requires_grad_() for x in (q, k, v, bias)]
    wo, wl = attn.attention_reference_lse(*ins[:3], ins[3], scale)
    want = (wo, wl) + torch.autograd.grad(wo, ins, g.double())
    plain = attn.attention_reference_lse(q, k, v, bias, scale) + tuple(
        attn.flash_attention_bwd_reference(q, k, v, bias, g, out, lse,
                                           scale))
    errs = {}
    for name, x, p, w in zip(NAMES, (out, lse) + tuple(grads), plain, want):
        assert x.shape == w.shape and x.dtype == p.dtype, name
        err = (x.double() - w).abs().max().item()
        perr = (p.double() - w).abs().max().item()
        print(f"{tuple(q.shape)} k {tuple(k.shape)} {name}: err {err:.3e}, "
              f"plain {perr:.3e}, ratio {err / perr:.3f}")
        assert torch.isfinite(x).all() and err <= 1.5 * perr, (name, err, perr)
        errs[name] = (err, perr)
    return errs


def _rand(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).bfloat16()


# (B, H, Tq, Tk, D): the prior's, ragged tiles, one key tile, the most keys,
# d 32, 40 and 64 (each instance), one query row; Tk even (a contiguous
# bias's rows then start on 4 bytes: head_bias_layout)
CARD_SHAPES = [PRIOR, (2, 3, 129, 130, 52), (1, 5, 70, 64, 52),
               (3, 4, 200, 576, 52), (2, 6, 65, 194, 40),
               (1, 4, 100, 150, 32), (1, 3, 64, 78, 64), (2, 2, 1, 130, 52),
               (4, 16, 1, 130, 52), (1, 7, 300, 334, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_head_bias_kernels_match_plain(cuda, shape):
    b, h, tq, tk, d = shape
    gen = torch.Generator("cuda").manual_seed(sum(shape))
    q = _rand((b, h, tq, d), gen, d ** -0.25)
    k = _rand((b, 1, tk, d), gen, d ** -0.25)
    v, bias, g = (_rand(s, gen) for s in ((b, 1, tk, d), (h, tq, tk),
                                          (b, h, tq, d)))
    _check_on_card(q, k, v, bias, g, 1.0 if shape == PRIOR else 0.8)


@pytest.mark.cuda
def test_head_bias_kernels_read_the_models_views(cuda):
    # the prior's q: a Linear output [B, T, H * D] viewed as [B, H, T, D];
    # k/v [B, T + 1, D] (the null key first) as [B, 1, T + 1, D]; the bias
    # contiguous [H, T, T + 1], as PriorTransformer makes it
    gen = torch.Generator("cuda").manual_seed(7)
    b, h, t, d = 3, 8, 129, 52
    q = _rand((b, t, h * d), gen, 0.5).reshape(b, t, h, d).transpose(1, 2)
    k = _rand((b, t + 1, d), gen, 0.5)[:, None]
    v = _rand((b, t + 1, d), gen)[:, None]
    bias = _rand((t, t + 1, h), gen).permute(2, 0, 1).contiguous()
    g = _rand((b, h, t, d), gen)
    assert not q.is_contiguous()
    _check_on_card(q, k, v, bias, g, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_slice", "per_row", "rows_4_bytes",
                                    "kv_per_head"])
def test_other_layouts_stay_on_the_register_kernels(cuda, layout):
    gen = torch.Generator("cuda").manual_seed(3)
    b, h, tq, tk, d = 2, 3, 130, 140, 52
    q = _rand((b, h, tq, d), gen, 0.5)
    k, v = _rand((b, 1, tk, d), gen, 0.5), _rand((b, 1, tk, d), gen)
    g = _rand((b, h, tq, d), gen)
    bias = _rand((h, tq, tk), gen)
    if layout == "one_slice":
        bias = _rand((tq, tk), gen)
    elif layout == "per_row":
        bias = _rand((b, h, tq, tk), gen)
    elif layout == "rows_4_bytes":
        def wide(x):
            buf = torch.zeros(x.shape[:-1] + (54,), dtype=x.dtype,
                              device=x.device)
            buf[..., :52] = x
            return buf[..., :52]
        q, k, v = wide(q), wide(k), wide(v)
    else:
        k, v = k.expand(b, h, tk, d).contiguous(), v.expand(
            b, h, tk, d).contiguous()
    fb = dict(attn.FLASH_FWD_LAUNCHES.by_route)
    bb = dict(attn.FLASH_BWD_LAUNCHES.by_route)
    _check_on_card(q, k, v, bias, g, 0.8, route=False)
    assert _launch_route(attn.FLASH_FWD_LAUNCHES, fb) == \
        "flash_fwd_reg_kernel"
    assert _launch_route(attn.FLASH_BWD_LAUNCHES, bb) == (
        "flash_bwd_dkdv_reg_kernel+flash_bwd_dq_reg_kernel")
