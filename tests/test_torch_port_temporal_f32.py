"""Temporal attention's f32 route (csrc/temporal_attn_fwd.cu:
temporal_f32_kernel) on the CPU: an emulation of the kernel's tiles, its
copy ring, its per-warp row split and its order of summation, held to the
plain version, to the float64 result and to the JAX package's Pallas kernel
in interpret mode on the same numpy-seeded inputs.

The kernel: persistent blocks of 4 warps walk tiles of W = 4 / R
consecutive (pixel, head) units (R = 1, 2, 4 warps a unit at hd <= 40,
<= 80, <= 160) through a ring of 2 stages, each 3 x [16 frames][164]
floats holding, for each frame, the tile's run of W * hd floats; rows of
frames F..15 are zero. Warp w of a tile takes unit w // R, query rows
(w % R) * 16 / R on. Its lane (r, n), with NR row groups and NK = 32 / NR
key groups (NR = 8, or 4 at R = 4), holds the logits of rows r + NR i
against keys n + NK m, each four partial f32 FMA sums over hd (one per
element of a 16-byte chunk, the chunks in order) added as (p0 + p1) +
(p2 + p3) and scaled; the row max and the exp sum go across the NK lanes
by xor shuffles (the sum first over the lane's keys in order), each
weight is e / sum, and O = P V sums its 16 keys in order by f32 FMAs, lane
(r, n) taking 16-byte chunks n, n + NK, ... of its rows. The emulation
forms each FMA as the float64 product (exact for f32 operands) plus the
f32 sum, rounded to f32 once more (a double rounding that can differ from
the FMA's one rounding in rare ties), and the exponent with numpy's f32
exp (the kernel's expf may differ by an ulp or two), so it is held to the
kernel's design, not to its bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from neurons_tpu.ops import temporal_attention as jtemporal
from neurons_tpu_torch.ops import temporal_attention as ttemporal
from torch_port_utils import rel_err, t

FRAMES, WARPS, RUN, LD, STAGES, COPIES = 16, 4, 160, 164, 2, 5
TENSOR = FRAMES * LD
LANES = np.arange(32)
f32, f64 = np.float32, np.float64


def split_of(hd):
    """Warps a unit (csrc f32_split)."""
    return 1 if hd <= 40 else 2 if hd <= 80 else 4


def lane_map(r):
    """(W, M, NR, NK, RPL, KPL) of F32Split<R>."""
    nr = 4 if r == 4 else 8
    nk = 32 // nr
    return WARPS // r, FRAMES // r, nr, nk, FRAMES // r // nr, FRAMES // nk


def fma32(a, b, c):
    return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)


class Shape:
    def __init__(self, bf, d, c, f, h):
        self.F, self.hd = f, c // h
        self.DH, self.DC = d * h, d * c
        self.units = bf // f * d * h

    def unit_base(self, u):
        b = u // self.DH
        return b * self.F * self.DC + (u - b * self.DH) * self.hd


def copy_table(s, w):
    """A thread's (src, dst) offsets of one tensor of a usual tile, for the
    128 threads: [128, COPIES] each, src -1 where none."""
    run = w * s.hd // 4
    i = np.arange(128)[:, None] + 128 * np.arange(COPIES)[None, :]
    f, c = i // run, i % run
    return np.where(f < s.F, f * s.DC + 4 * c, -1), f * LD + 4 * c


def issue(s, w, table, tile, srcs, stage):
    """f32_issue: q, k, v of the tile's units into `stage` (flat floats)."""
    u0 = tile * w
    b0, r0 = u0 // s.DH, u0 % s.DH
    if r0 + w <= s.DH and u0 + w <= s.units:
        base = b0 * s.F * s.DC + r0 * s.hd
        src, dst = table
        for ti, x in enumerate(srcs):
            for sk, dk in zip(src[src >= 0], dst[src >= 0]):
                stage[ti * TENSOR + dk:ti * TENSOR + dk + 4] = \
                    x[base + sk:base + sk + 4]
        return
    chunks = s.hd // 4
    row, per = w * chunks, s.F * w * chunks
    for i in range(3 * per):
        ti, fr, wu, c = i // per, i % per // row, i % row // chunks, i % chunks
        if u0 + wu >= s.units:
            continue
        at = s.unit_base(u0 + wu) + fr * s.DC + 4 * c
        d = ti * TENSOR + fr * LD + wu * s.hd + 4 * c
        stage[d:d + 4] = srcs[ti][at:at + 4]


def warp_rows(s, r, stage, w, row0, scale, out, written):
    """f32_rows<R>: rows row0 .. row0 + 16 / R - 1 of the tile's unit w."""
    _, _, nr, nk, rpl, kpl = lane_map(r)
    rg, kg = LANES // nk, LANES % nk
    tile = stage.reshape(3, FRAMES, LD)[:, :, w * s.hd:]
    rows = row0 + rg[:, None] + nr * np.arange(rpl)[None, :]    # [32, RPL]
    keys = kg[:, None] + nk * np.arange(kpl)[None, :]            # [32, KPL]
    acc = np.zeros((32, rpl, kpl, 4), f32)
    for e in range(0, s.hd, 4):
        qv = tile[0][rows, e:e + 4]                               # [32,RPL,4]
        kv = tile[1][keys, e:e + 4]                               # [32,KPL,4]
        acc = fma32(qv[:, :, None, :], kv[:, None, :, :], acc)
    logit = ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) \
        * f32(scale)
    logit = np.where((keys < s.F)[:, None, :], logit, f32(-np.inf))
    mx = logit.max(axis=2)                                        # [32, RPL]
    x = 1
    while x < nk:
        mx = np.maximum(mx, mx[LANES ^ x])
        x *= 2
    with np.errstate(invalid="ignore"):
        e = np.exp(logit - mx[:, :, None]).astype(f32)
    tot = np.zeros((32, rpl), f32)
    for m in range(kpl):
        tot = tot + e[:, :, m]
    x = 1
    while x < nk:
        tot = tot + tot[LANES ^ x]
        x *= 2
    p = e / tot[:, :, None]
    # pw[lane, i, j]: key j from lane (r, j % NK), its slot j // NK
    pw = np.stack([p[rg * nk + j % nk, :, j // nk] for j in range(FRAMES)],
                  axis=2)                                         # [32,RPL,16]
    for c0 in range(0, s.hd // 4, nk):
        c = c0 + kg                                               # [32]
        live = c < s.hd // 4
        cc = np.where(live, c, 0)
        o = np.zeros((32, rpl, 4), f32)
        for jj in range(FRAMES):
            vv = tile[2][jj, 4 * cc[:, None] + np.arange(4)]      # [32, 4]
            o = fma32(pw[:, :, jj, None], vv[:, None, :], o)
        for lane in np.flatnonzero(live):
            for i in range(rpl):
                row = rows[lane, i]
                if row < s.F:
                    at = row * s.DC + 4 * c[lane] + np.arange(4)
                    out[at] = o[lane, i]
                    written[at] += 1


def emulate(q, k, v, n_frames, heads, scale, resident=5, split=None):
    """The f32 route on numpy f32 [(B F), D, C] arrays: `resident` blocks
    (fewer than the tiles, so each block's ring wraps), each with its own
    2-stage ring that keeps what earlier tiles left. Returns (out, the
    number of writes of each output element)."""
    bf, d, c = q.shape
    s = Shape(bf, d, c, n_frames, heads)
    r = split or split_of(s.hd)
    w, m = lane_map(r)[:2]
    srcs = [x.reshape(-1) for x in (q, k, v)]
    out = np.full(bf * d * c, np.nan, f32)
    written = np.zeros(bf * d * c, np.int64)
    tiles = -(-s.units // w)
    grid = min(tiles, resident)
    table = copy_table(s, w)
    for block in range(grid):
        smem = np.full((STAGES, 3 * TENSOR), np.nan, f32)
        for st in range(STAGES):  # rows F..15 zeroed once
            smem[st].reshape(3, FRAMES, LD)[:, s.F:] = 0
        for st in range(STAGES - 1):
            if block + st * grid < tiles:
                issue(s, w, table, block + st * grid, srcs, smem[st])
        for n, tile in enumerate(range(block, tiles, grid)):
            stage = n % STAGES
            ahead = tile + (STAGES - 1) * grid
            if ahead < tiles:
                issue(s, w, table, ahead, srcs,
                      smem[(stage + STAGES - 1) % STAGES])
            for warp in range(WARPS):
                u = tile * w + warp // r
                if u < s.units:
                    warp_rows(s, r, smem[stage], warp // r, warp % r * m,
                              scale, out[s.unit_base(u):], written[
                                  s.unit_base(u):])
    return out.reshape(q.shape), written.reshape(q.shape)


def qkv(seed, bf, d, c):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bf, d, c), dtype=f32) for _ in range(3)]


def plain_errors(q, k, v, f, h, scale):
    """(the f32 plain version, its max error against float64, the float64
    result) on the same inputs."""
    want = ttemporal.temporal_attention_reference(
        *(t(x).double() for x in (q, k, v)), f, h, scale).numpy()
    plain = ttemporal.temporal_attention_reference(
        t(q), t(k), t(v), f, h, scale).numpy()
    return plain, np.abs(plain.astype(f64) - want).max(), want


# (B F, D, C, F, H): validate's F 16, H 8 at hd 40, 80, 160 over 8 pixels
# (the Pallas kernel takes them: F * H == 128, D a multiple of 8), and the
# tiny chain's F 4, H 2 at hd 4 and 8 over 7 pixels (14 units a batch row:
# tiles of 4 cross batch rows, the last tile is partial)
CASES = {"hd40": (32, 8, 320, 16, 8), "hd80": (32, 8, 640, 16, 8),
         "hd160": (16, 8, 1280, 16, 8), "tiny hd4": (8, 7, 8, 4, 2),
         "tiny hd8": (12, 7, 16, 4, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_route_emulation_matches_plain(case):
    bf, d, c, f, h = CASES[case]
    q, k, v = qkv(31, bf, d, c)
    scale = (c // h) ** -0.5
    got, written = emulate(q, k, v, f, h, scale)
    # every output element written once: the tiles, the row split and the
    # lanes' chunks cover each unit's F rows x hd columns exactly
    assert (written == 1).all()
    plain, plain_err, want = plain_errors(q, k, v, f, h, scale)
    err = np.abs(got.astype(f64) - want).max()
    # the card's gate (chip_smoke.py temporal_phase): within 1.5x the f32
    # plain version's error against float64
    assert err <= 1.5 * plain_err, (err, plain_err)
    # and to the plain version itself: both are f32 computations of the
    # same sums in other orders, a few f32 roundings of outputs of order 1
    assert rel_err(got, plain) <= 1e-5


@pytest.mark.parametrize("case", ["hd40", "hd80", "hd160"])
def test_f32_route_emulation_matches_pallas_interpret(case):
    # the Pallas kernel #6 in interpret mode, as tests/test_torch_port_ops.py
    # runs it; both are f32 (the JAX kernel's f32 products, rounded, summed
    # by its selector matmul), so they differ by f32 roundings
    bf, d, c, f, h = CASES[case]
    q, k, v = qkv(32, bf, d, c)
    scale = (c // h) ** -0.5
    assert jtemporal._kernel_eligible(bf, d, c, f, h, jnp.float32)
    ref = jtemporal._temporal_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), f, h, scale, True)
    got, _ = emulate(q, k, v, f, h, scale)
    assert rel_err(got, np.asarray(ref)) <= 1e-5


def test_tiny_chain_emulation_matches_jax_reference():
    # F 4, H 2: the Pallas kernel does not take it (F * H != 128), so the
    # JAX package runs its einsum reference
    bf, d, c, f, h = CASES["tiny hd8"]
    q, k, v = qkv(33, bf, d, c)
    scale = (c // h) ** -0.5
    ref = jtemporal.temporal_attention_reference(q, k, v, f, h, scale)
    got, _ = emulate(q, k, v, f, h, scale)
    assert rel_err(got, np.asarray(ref)) <= 1e-5


def test_row_split_keeps_the_bits_of_each_key_group_layout():
    # at hd 40 a unit may run on 1, 2 or 4 warps: R = 1 and 2 share the
    # lane layout of the keys (NK = 4), so their sums run in one order and
    # give equal bits, K and V shared and nothing recomputed; R = 4 sums
    # each row's exps over 8 key groups, a different order
    bf, d, c, f, h = CASES["hd40"]
    q, k, v = qkv(34, bf, d, c)
    scale = (c // h) ** -0.5
    one, _ = emulate(q, k, v, f, h, scale, split=1)
    two, _ = emulate(q, k, v, f, h, scale, split=2)
    four, _ = emulate(q, k, v, f, h, scale, split=4)
    assert np.array_equal(one, two)
    assert rel_err(four, one) <= 1e-6


@pytest.mark.parametrize("r", [1, 2, 4])
def test_shared_memory_reads_are_conflict_free(r):
    # each warp-wide 16-byte read (q rows, k rows, a V chunk row) asks for
    # at most 8 distinct 16-byte units, in distinct groups of 4 banks: one
    # request each. Rows are 164 floats, 41 16-byte units: odd
    _, m, nr, nk, rpl, kpl = lane_map(r)
    rg, kg = LANES // nk, LANES % nk
    unit = 40 // 4 * 4  # any unit's column offset (w * hd): whole chunks
    patterns = [(rg + nr * i) * LD + unit for i in range(rpl)]
    patterns += [(kg + nk * mm) * LD + unit for mm in range(kpl)]
    patterns += [3 * LD + unit + 4 * (kg + nk * p) for p in range(2)]
    for addr in patterns:
        chunks = np.unique(addr // 4)
        assert len(chunks) <= 8
        assert len(np.unique(chunks % 8)) == len(chunks)


def test_copy_table_covers_each_run_once():
    # a usual tile's copies: each thread's table, over the 128 threads,
    # names every 16-byte chunk of the F x W * hd run once
    for hd in (4, 8, 40, 44, 80, 160):
        s = Shape(32, 8, 8 * hd, 16, 8)
        w = lane_map(split_of(hd))[0]
        src, dst = copy_table(s, w)
        live = src >= 0
        assert live.sum() == s.F * w * hd // 4
        assert len(np.unique(dst[live])) == live.sum()
        assert len(np.unique(src[live])) == live.sum()
        assert w * hd <= RUN and (dst[live] % LD + 4 <= w * hd).all()
