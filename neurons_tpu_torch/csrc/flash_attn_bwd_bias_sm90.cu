// The prior's biased multi-query attention backward on Hopper's warpgroup
// products (sm_90a, wgmma). Bound through a plain C interface and loaded
// with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for bf16 with one bias slice a head shared over the batch
// ([H, Tq, Tk]) over multi-query k/v ([B, 1, Tk, D]) at D <= 64 on rows,
// strides and pointers that are 8-byte multiples and Tk <= 576, the JAX
// package's
//   neurons_tpu/ops/attention.py:458  _flash_bwd_bias_kernel
// (called from _flash_bwd_pallas_bias, :530 / :618, its multi-query sum
// _mq_reduce at :736): the FlashAttention-2 backward from the forward's
// output and log-sum-exp, with s = q k^T * scale + bias in f32,
//   p  = exp(s - lse)
//   dv = p^T g          (p rounded to bf16 first)
//   dp = g v^T,  ds = p (dp - delta),  delta = sum_d g * out
//   dk = (ds*scale)^T q,  dq = (ds*scale) k   (ds*scale rounded to bf16)
//   dbias = ds summed over the batch (the bias is one slice a head)
// and dk, dv summed over the heads (k/v are one head), f32 accumulation
// throughout. Outputs: dq [B, H, Tq, D], dk and dv [B, 1, Tk, D] and dbias
// [H, Tq, Tk], all bf16 and each element written once. Every backward of
// the prior (the stage-2 step's 6 a step, [10, 32, 513, 514, 52]) comes
// here.
//
// What bounds it on an H100: 10 B H Tq Tk D operations (43.9 GFLOP at the
// prior's shape, 44 us at 989 TFLOP/s) against about 120 MB with the bias
// and dbias (36 us), and 2 B H Tq Tk exponentials (169 M, 46 us on the MUFU
// unit's ex2 at 16 a clock an SM, about 3.7 T/s at 1.755 GHz): products and
// exponentials about even. The design recomputes S and dP in both passes
// (7 products where 5 would do with atomics), pads the depth of S and dP to
// 64 (x 1.23 at d 52), and the ragged tiles (9 where 8.02 would do, on each
// side) cost x 1.12 each.
//
// Design: two passes and no atomics, so every sum has one fixed order and a
// rerun gives equal bits. The three reductions run over three index sets:
// dQ[b, h] over the keys, dbias[h] over the batch, dK/dV[b] over the heads
// and the queries. Each pass keeps its own reductions on chip.
//  * Pass 1, dQ + delta + dbias (flash_bwd_dq_bias_wgmma_kernel, launched
//    first): a block owns one head and 64 queries, two warpgroups that split
//    the key tiles (the first ceil(n / 2), the rest). Each walks the batch
//    rows and, within a row, its key tiles. Each thread reads its two query
//    rows' Q, g and out as register A fragments straight from global memory
//    (4-byte words: no shared memory, no copy) and their lse, a batch row
//    ahead, and takes their delta = sum g * out itself (its quad's columns,
//    summed over the quad: no torch pass); the bias pairs of the next
//    step's key tile come the same way a step ahead. K and V tiles of its
//    keys come through the warpgroup's own two-stage ring (8-byte cp.async
//    into swizzled rows, issued by the warpgroup one step ahead). Per tile
//      S = Q K^T, dP = g V^T      wgmma m64n64k16, A from registers, B K-major;
//      p = ex2((S * scale + bias - lse) * log2(e)) (keys past Tk at 0),
//      dS = p (dP - delta) in registers;
//      dbias[h][its 64 queries][the tile's keys] += dS in shared memory: an
//      f32 accumulator of 64 x 576 (147 KB), each element owned by one
//      thread (a [tile][register][thread] layout: no barrier, no bank
//      conflict), summed over the batch rows in order and written once, in
//      bf16, at the end;
//      dQ += (dS * scale) K       wgmma m64nDNk16, A = dS * scale packed to
//                                 bf16 in registers, B = K MN-major.
//    At the end of a batch row the second warpgroup hands its f32 dQ over
//    through shared memory (named barriers) and the first adds it to its own
//    (one fixed order) and writes dQ in bf16, and delta for pass 2.
//  * Pass 2, dK/dV (flash_bwd_dkdv_bias_wgmma_kernel): a block owns one batch
//    row, 64 keys and one group of the heads: a warpgroup with K and V of
//    its keys resident, and a thread-block cluster of kGroups such blocks
//    (one a head group) shares the (b, key tile). The 90 (b, key tile) units
//    of the prior's shape would fill 90 of the 132 SMs; split four ways over
//    the heads they make 360 blocks of one warpgroup, three of which fit an
//    SM (registers, 69 KB of shared memory each). Per (head, query tile),
//    through a two-stage ring (Q, g, their lse and delta, and the bias tile
//    [64 queries x 64 keys], all by cp.async one step ahead):
//      S^T = K Q^T, dP^T = V g^T  wgmma m64n64k16, A (K, V) and B (Q, g) from
//                                 shared memory, K-major;
//      P^T and dS^T * scale in registers (queries past Tq at 0);
//      dV += P^T g, dK += (dS^T * scale) Q   wgmma m64nDNk16, A from
//                                 registers, B (g, Q) MN-major.
//    dK and dV are f32 registers summed over the group's heads in head
//    order; at the end each block parks them in its shared memory, the
//    cluster meets at a barrier, and each block sums its share of the
//    elements over the cluster's blocks in rank order (distributed shared
//    memory) and writes them once, in bf16: no per-(b, h) tensor, no torch
//    sum.
// DN, the N of the products over the head dim, is D rounded up to a
// multiple of 8 (56 at d 52): the real columns only. Each warpgroup waits
// for its own products; the probabilities take one FFMA-like step and
// ex2.approx (the forward, whose lse is an output, the accurate expf).

#include <cooperative_groups.h>

#include "flash_bias_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

template <int DN_>
struct BwdBiasCfg {
  static constexpr int DN = DN_;
  static constexpr int KS = (DN + 15) / 16;  // k16 steps of S and dP
  // pass 1: two warpgroups; the dbias accumulator ([tile][32][128] f32 a
  // warpgroup's tiles), each warpgroup's ring (2 stages of K and V), the dQ
  // hand-off ([DN / 2][128] f32), the alignment slack
  static constexpr int kDqThreads = 256;
  static constexpr int kAccBytes = kMaxKeyTiles * 32 * 128 * 4;
  static constexpr int kRingBytes = 2 * 2 * 2 * kTileBytes;
  static constexpr int kXchBytes = DN / 2 * 128 * 4;
  static constexpr int kDqSmem = kAccBytes + kRingBytes + kXchBytes + 1024;
  // pass 2: one warpgroup a block, kGroups blocks (head groups) a cluster,
  // kMinBlocks blocks an SM; K and V, the ring of Q and g (2 stages), the
  // stages' lse and delta, the stages' bias tiles ([64][kBiasLd] bf16), the
  // alignment slack
  static constexpr int kGroups = 4, kMinBlocks = 3, kDkdvThreads = 128;
  static constexpr int kBiasLd = 72;  // 144-byte rows: conflict-free reads
  static constexpr int kStatBytes = 2 * 2 * 64 * 4;
  static constexpr int kBiasBytes = 64 * kBiasLd * 2;
  static constexpr int kDkdvSmem =
      2 * kTileBytes + 2 * 2 * kTileBytes + kStatBytes + 2 * kBiasBytes + 1024;
  static_assert(2 * DN / 2 * 128 * 4 <= 2 * 2 * kTileBytes,
                "dK and dV park in the ring");
};

struct BwdBiasParams {
  const __nv_bfloat16 *q, *k, *v, *g, *out, *bias;
  const float* lse;   // [B*H, Tq]
  float* delta;       // [B*H, Tq]: written by pass 1, read by pass 2
  __nv_bfloat16* dq;  // [B, H, Tq, D], contiguous
  __nv_bfloat16* dk;  // [B, 1, Tk, D], contiguous
  __nv_bfloat16* dv;
  __nv_bfloat16* dbias;  // [H, Tq, Tk], contiguous
  long long q_sb, q_sh, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_sh, g_st,
      bias_sh, bias_st;
  int B, H, Tq, Tk, D;
  float scale;
};

// acc (64 x 64) = A B^T over KS k16 steps: A the bf16 fragments a[KS] in
// registers, B a K-major swizzled tile; issued under one fence, not
// committed; the first step overwrites acc
template <int KS>
__device__ __forceinline__ void issue_rk64(float* acc, uint32_t (*a)[4],
                                           uint32_t b) {
  uint64_t db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    db[ks] = gmma_desc(b + 32 * ks, 16, 8 * kRowBytes, kMode);
  pin<KS>(db);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  fence_regs<4 * KS>(&a[0][0]);
  wgmma_fence();
  Wgmma<64>::rk0(acc, a[0], db[0], zero);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) Wgmma<64>::rk(acc, a[ks], db[ks], one);
}

// ---------------------------------------------------------------------------
// pass 1: dQ, delta and dbias

template <int DN>
__global__ void __launch_bounds__(BwdBiasCfg<DN>::kDqThreads, 1)
flash_bwd_dq_bias_wgmma_kernel(const BwdBiasParams p) {
  using C = BwdBiasCfg<DN>;
  constexpr int KS = C::KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* acc = reinterpret_cast<float*>(smem);  // [tile][32][128]
  unsigned char* ring = smem + C::kAccBytes;    // [wg][stage][K, V][tile]
  float* xch = reinterpret_cast<float*>(ring + C::kRingBytes);  // [DN/2][128]

  const int nqt = (p.Tq + 63) / 64;
  const int qt = blockIdx.x % nqt, h = blockIdx.x / nqt;
  const int nkt = (p.Tk + 63) / 64, n0 = (nkt + 1) / 2;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int kt0 = wg ? n0 : 0, nk = wg ? nkt - n0 : n0;
  const bool pair = nkt > 1;  // the second warpgroup has key tiles
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31,
            t4 = lane & 3;
  const int np = p.D >> 2;
  unsigned char* my_ring = ring + wg * 4 * kTileBytes;
  const uint32_t ring_addr = smem_u32(my_ring);
  zero_pads(my_ring, 4 * kTileRows, np, tid, 128);

  const int nsteps = p.B * nk;
  auto stage_step = [&](int s) {
    const int b = s / nk, kt = kt0 + s % nk;
    const uint32_t at = ring_addr + (s & 1) * 2 * kTileBytes;
    stage_tile(at, p.k + b * p.k_sb, p.k_st, kt * 64, p.Tk, np, tid, 128);
    stage_tile(at + kTileBytes, p.v + b * p.v_sb, p.v_st, kt * 64, p.Tk, np,
               tid, 128);
    cp_async_commit();
  };
  if (nsteps > 0) stage_step(0);

  // this lane's query rows, and their bias rows (one slice a head)
  const int row0 = qt * 64 + warp * 16 + (lane >> 2);
  const __nv_bfloat16* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    brow[r] = row0 + 8 * r < p.Tq
                  ? p.bias + h * p.bias_sh +
                        (long long)(row0 + 8 * r) * p.bias_st
                  : nullptr;

  // a batch row's Q, g and out as A fragments and its lse, issued a row
  // ahead; its delta = sum g * out (this lane's columns, then its quad's)
  auto load_row = [&](int b, uint32_t (*q_)[4], uint32_t (*g_)[4],
                      uint32_t (*o_)[4], float* l_) {
    const long long bh = (long long)b * p.H + h;
    const __nv_bfloat16 *qr[2], *gr[2], *orow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < p.Tq;
      qr[r] = ok ? p.q + b * p.q_sb + h * p.q_sh + (long long)row * p.q_st
                 : nullptr;
      gr[r] = ok ? p.g + b * p.g_sb + h * p.g_sh + (long long)row * p.g_st
                 : nullptr;
      orow[r] = ok ? p.out + (bh * p.Tq + row) * p.D : nullptr;
      l_[r] = ok ? p.lse[bh * p.Tq + row] : INFINITY;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_a_frag(q_[kk], qr[0], qr[1], kk, t4, p.D);
      load_a_frag(g_[kk], gr[0], gr[1], kk, t4, p.D);
      load_a_frag(o_[kk], orow[0], orow[1], kk, t4, p.D);
    }
  };
  // the bias pairs of key tile kt (one slice a head: every batch row's),
  // issued a step ahead
  auto load_bias = [&](uint32_t (*to)[8], int kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        to[r][i] = brow[r] ? load_pair(brow[r], kt * 64 + 8 * i + 2 * t4,
                                       p.Tk)
                           : 0u;
  };

  float dq[DN / 2];
  uint32_t qf[KS][4], gf[KS][4], nq[KS][4], ng[KS][4], no[KS][4], da[4][4];
  uint32_t bv[2][8], bn[2][8];
  float lse[2], dl[2], nl[2];
  if (nsteps > 0) {
    load_row(0, nq, ng, no, nl);
    load_bias(bn, kt0);
  }

  for (int s = 0; s < nsteps; ++s) {
    const int b = s / nk, kl = s % nk, kt = kt0 + kl;
    const int bh = b * p.H + h;
    if (kl == 0) {  // a new batch row: its fragments, lse, delta
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qf[kk][j] = nq[kk][j];
          gf[kk][j] = ng[kk][j];
          const float2 gv = bf16x2_to_float2(ng[kk][j]);
          const float2 ov = bf16x2_to_float2(no[kk][j]);
          sum[j & 1] = fmaf(gv.x, ov.x, sum[j & 1]);
          sum[j & 1] = fmaf(gv.y, ov.y, sum[j & 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        dl[r] = sum[r];
        lse[r] = nl[r];
      }
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
      if (b + 1 < p.B) load_row(b + 1, nq, ng, no, nl);
    }

    cp_async_wait<0>();
    fence_proxy_async_smem();
    named_bar_sync(1 + wg, 128);  // step s landed; step s - 1 read
    if (s + 1 < nsteps) stage_step(s + 1);
    const uint32_t k_addr = ring_addr + (s & 1) * 2 * kTileBytes;
    const uint32_t v_addr = k_addr + kTileBytes;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) bv[r][i] = bn[r][i];
    if (s + 1 < nsteps) load_bias(bn, kt0 + (s + 1) % nk);

    float sc[32], dp[32];
    issue_rk64<KS>(sc, qf, k_addr);
    issue_rk64<KS>(dp, gf, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    // dS; its sum over the batch into dbias; dS * scale for dQ
    float* at = acc + (kt * 32) * 128 + tid;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = kt * 64 + 8 * i + 2 * t4 + (e & 1);
        const float2 bp = bf16x2_to_float2(bv[r][i]);
        const float x = fmaf(sc[4 * i + e], p.scale, (e & 1) ? bp.y : bp.x);
        const float pv = key < p.Tk ? ex2_approx((x - lse[r]) * kLog2e) : 0.f;
        const float ds = pv * (dp[4 * i + e] - dl[r]);
        float* a = at + (4 * i + e) * 128;
        *a = b == 0 ? ds : *a + ds;
        dp[4 * i + e] = ds * p.scale;
      }
    pack_frags<64>(da, dp);
    issue_rs<DN>(dq, da, k_addr);  // dQ += (dS * scale) K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DN / 2>(dq);

    if (kl == nk - 1) {  // the batch row's dQ: both warpgroups' keys
      if (wg == 1) {
        if (b > 0) named_bar_sync(4, 256);  // the first read the last one
#pragma unroll
        for (int i = 0; i < DN / 2; ++i) xch[i * 128 + tid] = dq[i];
        named_bar_arrive(3, 256);
      } else {
        if (pair) {
          named_bar_sync(3, 256);
#pragma unroll
          for (int i = 0; i < DN / 2; ++i) dq[i] += xch[i * 128 + tid];
          if (b + 1 < p.B) named_bar_arrive(4, 256);
        }
        __nv_bfloat16* og = p.dq + (long long)bh * p.Tq * p.D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row >= p.Tq) continue;
          __nv_bfloat16* orow = og + (long long)row * p.D;
#pragma unroll
          for (int i = 0; i < DN / 8; ++i) {
            const int col = 8 * i + 2 * t4;
            if (col < p.D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack_bf16x2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
          }
          if (t4 == 0) p.delta[(long long)bh * p.Tq + row] = dl[r];
        }
      }
    }
  }

  // dbias of this warpgroup's key tiles, once, in bf16
  __nv_bfloat16* db = p.dbias + (long long)h * p.Tq * p.Tk;
  const bool even = (p.Tk & 1) == 0;
  for (int kl = 0; kl < nk; ++kl) {
    const int kt = kt0 + kl;
    const float* at = acc + (kt * 32) * 128 + tid;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      __nv_bfloat16* drow = db + (long long)row * p.Tk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = kt * 64 + 8 * i + 2 * t4;
        const float x = at[(4 * i + 2 * r) * 128];
        const float y = at[(4 * i + 2 * r + 1) * 128];
        if (even && key + 1 < p.Tk) {
          *reinterpret_cast<uint32_t*>(drow + key) = pack_bf16x2(x, y);
        } else {
          if (key < p.Tk) drow[key] = __float2bfloat16_rn(x);
          if (key + 1 < p.Tk) drow[key + 1] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV, summed over the heads in a cluster

template <int DN>
__global__ void __cluster_dims__(BwdBiasCfg<DN>::kGroups, 1, 1)
__launch_bounds__(BwdBiasCfg<DN>::kDkdvThreads, BwdBiasCfg<DN>::kMinBlocks)
flash_bwd_dkdv_bias_wgmma_kernel(const BwdBiasParams p) {
  using C = BwdBiasCfg<DN>;
  constexpr int KS = C::KS, G = C::kGroups, LD = C::kBiasLd;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;                   // [64][128 B]
  unsigned char* sV = sK + kTileBytes;
  unsigned char* sQ = sV + kTileBytes;        // [stage][64][128 B]
  unsigned char* sG = sQ + 2 * kTileBytes;
  float* sStat = reinterpret_cast<float*>(sG + 2 * kTileBytes);  // [stage][lse, delta][64]
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(
      sG + 2 * kTileBytes + C::kStatBytes);   // [stage][64 queries][LD]

  cg::cluster_group cluster = cg::this_cluster();
  const int grp = (int)cluster.block_rank();
  const int unit = blockIdx.x / G;
  const int nkt = (p.Tk + 63) / 64;
  const int kt = unit % nkt, b = unit / nkt;
  const int hg = (p.H + G - 1) / G;
  const int h0 = grp * hg, h1 = min(p.H, h0 + hg);
  const int nqt = (p.Tq + 63) / 64;
  const int nsteps = h1 > h0 ? (h1 - h0) * nqt : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31,
            t4 = lane & 3;
  const int np = p.D >> 2;

  zero_pads(sK, 2 * kTileRows, np, tid, 128);  // K, V
  zero_pads(sQ, 4 * kTileRows, np, tid, 128);  // the ring's Q and g
  stage_tile(smem_u32(sK), p.k + b * p.k_sb, p.k_st, kt * 64, p.Tk, np, tid,
             128);
  stage_tile(smem_u32(sV), p.v + b * p.v_sb, p.v_st, kt * 64, p.Tk, np, tid,
             128);
  auto stage_step = [&](int s) {
    const int h = h0 + s / nqt, qt = s % nqt, st = s & 1;
    const long long bh = (long long)b * p.H + h;
    stage_tile(smem_u32(sQ) + st * kTileBytes, p.q + b * p.q_sb + h * p.q_sh,
               p.q_st, qt * 64, p.Tq, np, tid, 128);
    stage_tile(smem_u32(sG) + st * kTileBytes, p.g + b * p.g_sb + h * p.g_sh,
               p.g_st, qt * 64, p.Tq, np, tid, 128);
    {  // lse (threads 0-63) and delta (64-127) of the tile's queries
      const int q = qt * 64 + (tid & 63);
      const float* src = (tid < 64 ? p.lse : p.delta) + bh * p.Tq;
      cp_async<4>(smem_u32(sStat) + 4 * (st * 128 + tid),
                  src + (q < p.Tq ? q : 0), q < p.Tq ? 4 : 0);
    }
    // the bias tile [64 queries][64 keys] in 4-byte pairs, zero past Tq
    // and Tk (a lone last key at an odd Tk moves 2 bytes)
    const int j = tid & 31, key = kt * 64 + 2 * j;
    const int kbytes = key + 1 < p.Tk ? 4 : key < p.Tk ? 2 : 0;
    const uint32_t bt = smem_u32(sB) + st * C::kBiasBytes + 4 * j;
    for (int r = tid >> 5; r < 64; r += 4) {
      const int q = qt * 64 + r;
      const int n = q < p.Tq ? kbytes : 0;
      const __nv_bfloat16* src =
          n ? p.bias + h * p.bias_sh + (long long)q * p.bias_st + key : p.bias;
      cp_async<4>(bt + r * LD * 2, src, n);
    }
    cp_async_commit();
  };
  if (nsteps > 0) stage_step(0);
  else cp_async_commit();

  // this lane's keys: rows key0, key0 + 8 of the tile; the query columns of
  // its S^T registers: 8 i + 2 (lane % 4) + (e & 1)
  const int krow = warp * 16 + (lane >> 2);
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[4][4], da[4][4];

  for (int s = 0; s < nsteps; ++s) {
    const int qt = s % nqt, st = s & 1;
    cp_async_wait<0>();
    fence_proxy_async_smem();
    __syncthreads();  // step s landed; step s - 1 read
    if (s + 1 < nsteps) stage_step(s + 1);
    const uint32_t q_addr = smem_u32(sQ) + st * kTileBytes;
    const uint32_t g_addr = smem_u32(sG) + st * kTileBytes;
    float sc[32], dp[32];
    issue_ss64<KS>(sc, smem_u32(sK), q_addr);  // S^T = K Q^T
    issue_ss64<KS>(dp, smem_u32(sV), g_addr);  // dP^T = V g^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    const float* stl = sStat + st * 128;
    const __nv_bfloat16* bt = sB + st * (C::kBiasBytes / 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qc = 8 * i + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(stl + qc);
      const float2 dl = *reinterpret_cast<const float2*>(stl + 64 + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qe = qc + (e & 1), kr = krow + 8 * (e >> 1);
        const float bb = __bfloat162float(bt[qe * LD + kr]);
        const float x = fmaf(sc[4 * i + e], p.scale, bb) - ((e & 1) ? l2.y : l2.x);
        const float pv = qt * 64 + qe < p.Tq ? ex2_approx(x * kLog2e) : 0.f;
        sc[4 * i + e] = pv;
        dp[4 * i + e] = pv * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x)) * p.scale;
      }
    }
    pack_frags<64>(pa, sc);
    pack_frags<64>(da, dp);
    issue_rs<DN>(dv, pa, g_addr);  // dV += P^T g
    issue_rs<DN>(dk, da, q_addr);  // dK += (dS^T * scale) Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DN / 2>(dv);
    fence_regs<DN / 2>(dk);
  }

  // the cluster's head groups: park dK, dV in the ring, meet, and each block
  // sums its share of the pairs over the blocks in rank order
  cp_async_wait<0>();
  __syncthreads();
  float* park = reinterpret_cast<float*>(sQ);  // [dK, dV][DN / 2][128]
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    park[i * 128 + tid] = dk[i];
    park[(DN / 2 + i) * 128 + tid] = dv[i];
  }
  cluster.sync();
  const float* peer[G];
#pragma unroll
  for (int r = 0; r < G; ++r) peer[r] = cluster.map_shared_rank(park, r);
  for (int pj = grp; pj < DN / 4; pj += G) {  // pair pj: registers 2pj, 2pj+1
    const int i = pj >> 1, rr = pj & 1;
    const int key = kt * 64 + krow + 8 * rr, col = 8 * i + 2 * t4;
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // dK, dV
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        x += peer[r][(w * DN / 2 + 2 * pj) * 128 + tid];
        y += peer[r][(w * DN / 2 + 2 * pj + 1) * 128 + tid];
      }
      if (key < p.Tk && col < p.D)
        *reinterpret_cast<uint32_t*>((w ? p.dv : p.dk) +
                                     ((long long)b * p.Tk + key) * p.D + col) =
            pack_bf16x2(x, y);
    }
  }
  cluster.sync();  // the peers' shared memory stays until all have read it
}

// ---------------------------------------------------------------------------
// host side

// the instance's DN by head dim: 32 up to d 32, 56 up to 56, 64 up to 64;
// 0 past 64 or off a multiple of 4 (no instance)
inline int bwd_dn(int D) {
  if (D <= 0 || D > 64 || D % 4) return 0;
  return D <= 32 ? 32 : D <= 56 ? 56 : 64;
}

template <class F>
int with_config(int D, F&& f) {
  switch (bwd_dn(D)) {
    case 32: return f(BwdBiasCfg<32>{});
    case 56: return f(BwdBiasCfg<56>{});
    case 64: return f(BwdBiasCfg<64>{});
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, g [B, H, Tq, D] and k, v [B, 1, Tk, D] bf16 with element strides over
// batch, head and token (multiples of 4 elements, pointers on 8 bytes, unit
// stride over D); out a contiguous [B, H, Tq, D] bf16 (the forward's
// output); lse [B*H, Tq] f32; delta a [B*H, Tq] f32 scratch pass 1 writes
// and pass 2 reads; bias [H, Tq, Tk] bf16 (strides bias_sh, bias_st even,
// unit stride over keys, the pointer on 4 bytes); dq a contiguous [B, H,
// Tq, D], dk and dv contiguous [B, 1, Tk, D], dbias a contiguous [H, Tq, Tk],
// all bf16. 0 < D <= 64 with D % 4 == 0, Tk <= 576; no input aliases an
// output. Launches pass 1, then pass 2, on `stream`. Returns a cudaError_t
// (0 on success).
int flash_attn_bwd_bias_sm90(const void* q, const void* k, const void* v,
                             const void* g, const void* out, const void* bias,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, void* dbias, long long q_sb,
                             long long q_sh, long long q_st, long long k_sb,
                             long long k_st, long long v_sb, long long v_st,
                             long long g_sb, long long g_sh, long long g_st,
                             long long bias_sh, long long bias_st, int B,
                             int H, int Tq, int Tk, int D, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      Tk > kMaxKeyTiles * kTileRows || (bias_st & 1) || (bias_sh & 1))
    return (int)cudaErrorInvalidValue;
  BwdBiasParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dbias = static_cast<__nv_bfloat16*>(dbias);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_st = k_st; p.v_sb = v_sb; p.v_st = v_st;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_st = g_st;
  p.bias_sh = bias_sh; p.bias_st = bias_st;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    auto dqk = flash_bwd_dq_bias_wgmma_kernel<C::DN>;
    auto dkdv = flash_bwd_dkdv_bias_wgmma_kernel<C::DN>;
    cudaError_t e = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvSmem);
    if (e != cudaSuccess) return (int)e;
    const long long nqt = (Tq + 63) / 64, nkt = (Tk + 63) / 64;
    // pass 1 first: it writes delta, which pass 2 reads
    dqk<<<(unsigned)(H * nqt), C::kDqThreads, C::kDqSmem, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dkdv<<<(unsigned)(B * nkt * C::kGroups), C::kDkdvThreads, C::kDkdvSmem,
           s>>>(p);
    return (int)cudaGetLastError();
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The plan of the instance serving head dim D: its DN; pass 1's queries a
// block, threads and shared memory; pass 2's keys a block, head groups (the
// cluster), blocks an SM, threads and shared memory; 0 where none serves D.
int flash_attn_bwd_bias_sm90_plan(int D, int* dn, int* rows1, int* threads1,
                                  int* smem1, int* rows2, int* groups,
                                  int* min_blocks, int* threads2,
                                  int* smem2) {
  return with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *dn = C::DN;
    *rows1 = 64;
    *threads1 = C::kDqThreads;
    *smem1 = C::kDqSmem;
    *rows2 = 64;
    *groups = C::kGroups;
    *min_blocks = C::kMinBlocks;
    *threads2 = C::kDkdvThreads;
    *smem2 = C::kDkdvSmem;
    return 1;
  }) == 1;
}

const char* flash_attn_bwd_bias_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
