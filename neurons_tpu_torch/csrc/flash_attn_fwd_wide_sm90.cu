// Flash-attention forward at head dims 128 < D <= 512 on Hopper's own
// instructions (sm_90a): TMA tile loads into an mbarrier ring and
// warpgroup products (wgmma) in two warpgroups that split O by columns.
// Bound through a plain C interface and loaded with ctypes
// (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for bf16 without a bias and without the log-sum-exp at
// 128 < D <= 512, D a multiple of 64, on 16-byte rows, the JAX package's
//   neurons_tpu/ops/attention.py:137  _flash_kernel_smallkv  (whole K/V resident)
//   neurons_tpu/ops/attention.py:226  _flash_kernel          (K/V streamed by block)
// at the VAE's mid attention (d = 512, one head: the keyframe and blurry
// decodes, the video decode, the served batch, the engine, SVD's encoder
// and temporal decoder). out = softmax(q k^T * scale) v with f32 logits,
// f32 running max and sum and f32 accumulation, P rounded to bf16 for the
// P V product, the output in bf16: the function of flash_fwd_wgmma_kernel
// (flash_attn_fwd_sm90.cu). flash_fwd_wide_kernel (flash_attn_fwd.cu)
// keeps the biased and lse launches, rows TMA cannot address and head
// dims between multiples of 64.
//
// What bounds it on an H100: 4 Tq Tk D operations at 989 TFLOP/s (0.176 ms
// at [1, 1, 9216, 9216, 512]); the Tq Tk exponentials (about 3.9 T/s) are
// an eighth of that at d 512. A unit of 64 query rows streams all of K
// and V from L2 for 4 * 64 Tk D operations, 64 FLOP a byte.
//
// Design. A unit is one (b, h), 64 query rows and one part of the keys; a
// grid of at most one block an SM deals the units to its blocks in turn,
// each block's ring running on from one unit to the next. A block has
// two warpgroups and no producer warp, so that ptxas may give a thread 255
// registers (a ninth warp puts three warps on one SM sub-partition's 16 K
// registers: 168, and then O, Q, S and P serialize the products, C7512).
// Thread 0 issues every copy, each one TMA box of all the column blocks
// (a 5-D map that splits D into blocks of 64: [D / 64][rows][64], each
// row of 128 bytes swizzled): Q once a unit, then each key tile of
// kWideBK keys, K and V apart, into a ring of two stages with a full and
// an empty mbarrier each. The two warpgroups own the same 64 rows; O
// (64 x 512 f32, 256 registers a thread in one warpgroup) is split by
// columns, 256 each (128 registers), and so is the depth of S = Q K^T.
// Per key tile:
//   S = Q K^T   each warpgroup over its half of the depth: 16 k16 steps of
//               wgmma m64nBKk16 under one fence, A = this half of Q from
//               registers (loaded once by ldmatrix), B = K from shared
//               memory, K-major;
//   exchange    each writes its f32 partial to shared memory (double
//               buffered by tile), a named barrier, and each adds the
//               other's: IEEE addition of two terms commutes, so both hold
//               the same S bits, the same softmax and the same P; past the
//               barrier both are done with K of tile i and V of i - 1, and
//               thread 0 refills their stages with K of i + 2, V of i + 1;
//   softmax     online, in registers (row max and sum over quads); O
//               rescaled only where the row max moved (x 1 is exact);
//   O += P V    wgmma m64n256k16 per k16 step, A = P from registers (S's
//               accumulator packed to bf16 pairs), B = V's 256 columns of
//               this half, MN-major through the transpose bit; S of tile
//               i + 1 is issued right behind it, and the two are waited
//               for together.
// Small grids split the keys into parts (the host's choice, from the
// shape: ops/attention.py wide_wgmma_parts): each part writes its
// unnormalized O in f32 and its row max and sum, and
// flash_fwd_wide_combine_kernel merges the parts in a fixed order, so a
// rerun gives equal bits. Column
// blocks past D are zeroed once and never loaded; TMA zero-fills past Tk
// and Tq, and a zero logit is not -inf, so the last key tile masks its
// columns past Tk; rows past Tq are not written. The exponentials are
// ex2.approx of one FFMA (scale * log2(e) folded in).

#include <climits>

#include "sm90.cuh"

namespace {

// keys a tile
constexpr int kWideBK = 32;
// the key parts the combine merges at most
constexpr int kMaxParts = 8;

template <int BK_>
struct WideCfg {
  static constexpr int BK = BK_;
  static constexpr int BW = 64, NB = 8, DK = BW * NB;  // column blocks
  static constexpr int kRowBytes = 2 * BW, kMode = swizzle_mode(kRowBytes);
  static constexpr int kCons = 2, kBQ = 64, kStages = 2;
  // the two warpgroups and no producer warp: each SM sub-partition holds
  // two of the 8 warps, so ptxas may give a thread 255 registers (a ninth
  // warp puts three on one sub-partition's 16 K: 168, and O's 128 beside
  // S, P and the descriptors then serialize the products, C7512)
  static constexpr int kThreads = 128 * kCons;
  static constexpr int kHalf = DK / kCons;          // columns of O a consumer
  static constexpr int kHalfBlocks = kHalf / BW;
  static constexpr int kSteps = kHalf / 16;  // S's k16 steps a warpgroup
  static constexpr int kSGroup = 16;                // k16 steps under one fence
  static constexpr int kBlockQ = kBQ * kRowBytes;   // one column block of Q
  static constexpr int kBlockKV = BK * kRowBytes;   // ... of a K or V tile
  static constexpr int kQBytes = NB * kBlockQ;
  static constexpr int kTileBytes = NB * kBlockKV;
  static constexpr int kXFloats = kCons * (BK / 2) * 128;  // one exchange
  static constexpr int kXOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBarOffset = kXOffset + 2 * kXFloats * 4;
  // tiles, the exchange, barriers (full q; full and empty k and v a
  // stage), and the slack that aligns the tiles to 1024 bytes
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kSmem <= 232448, "the block's shared memory");
  static_assert(kSteps % kSGroup == 0, "S's groups");
};

using Cfg = WideCfg<kWideBK>;

struct WideParams {
  void* o;        // [B, H, Tq, D] bf16, contiguous (parts == 1)
  float* opart;   // [parts, B*H, Tq, D] f32 unnormalized O (parts > 1)
  float2* ml;     // [parts, B*H, Tq] (row max of the logits, row sum)
  int BH, H, Hkv, Tq, Tk, D, parts, part_tiles;
  float scale_log2;
};

// four 8 x 8 bf16 matrices from shared memory, lane l addressing row
// l % 8 of matrix l / 8: the A fragment of one k16 step of a warp's 16
// rows (a wgmma register A operand)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// This warpgroup's half of Q's depth as the A fragments of S's k16 steps:
// warp w's rows 16w.., lane l's address row l % 16, 16-byte chunk l / 16
// of the step, through the 128-byte swizzle (chunk c of row r sits at
// c ^ (r % 8))
template <class C>
__device__ __forceinline__ void load_q(uint32_t (*qa)[4], uint32_t q_half,
                                       int warp, int lane) {
  const int row = warp * 16 + (lane & 15);
#pragma unroll
  for (int ks = 0; ks < C::kSteps; ++ks) {
    const int blk = ks * 16 / C::BW;
    const int chunk = (ks * 16 % C::BW) / 8 + (lane >> 4);
    ldmatrix_x4(qa[ks], q_half + blk * C::kBlockQ + row * C::kRowBytes +
                            ((chunk ^ (row & 7)) << 4));
  }
}

// S's partial with Q's fragments in registers (qa): k16 step ks reads 16
// columns of K inside column block ks * 16 / BW of the half (K-major);
// issued and committed, not waited for
template <class C>
__device__ __forceinline__ void s_issue(float* sc, uint32_t (*qa)[4],
                                        uint32_t k_tile) {
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
#pragma unroll
  for (int g = 0; g < C::kSteps / C::kSGroup; ++g) {
    uint64_t dk[C::kSGroup];
#pragma unroll
    for (int j = 0; j < C::kSGroup; ++j) {
      const int ks = g * C::kSGroup + j;
      const int blk = ks * 16 / C::BW, off = (ks * 16 % C::BW) * 2;
      dk[j] = gmma_desc(k_tile + blk * C::kBlockKV + off, 16,
                        8 * C::kRowBytes, C::kMode);
    }
    pin<C::kSGroup>(dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < C::kSGroup; ++j) {
      const int ks = g * C::kSGroup + j;
      if (ks == 0)
        Wgmma<C::BK>::rk0(sc, qa[0], dk[0], zero);
      else
        Wgmma<C::BK>::rk(sc, qa[ks], dk[j], one);
    }
    wgmma_commit();
  }
}

// O += P V over one key tile: k16 step kk reads 16 rows of V's columns of
// this half (MN-major: LBO = one column block of the tile, SBO = 8 rows);
// issued and committed, not waited for
template <class C>
__device__ __forceinline__ void pv_issue(float* o, uint32_t (*pa)[4],
                                         uint32_t v_tile) {
  uint64_t dv[C::BK / 16];
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    dv[kk] = gmma_desc(v_tile + kk * 16 * C::kRowBytes, C::kBlockKV,
                       8 * C::kRowBytes, C::kMode);
  pin<C::BK / 16>(dv);
  int one = 1;
  asm volatile("" : "+r"(one));
  fence_regs<C::kHalf / 2>(o);
  fence_regs<C::BK / 4>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    Wgmma<C::kHalf>::rs(o, pa[kk], dv[kk], one);
  wgmma_commit();
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const WideParams p) {
  constexpr int BW = C::BW, NB = C::NB, BK = C::BK, kBQ = C::kBQ,
                kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                     // [NB][kBQ][BW]
  unsigned char* sK = sQ + C::kQBytes;          // [kStages][NB][BK][BW]
  unsigned char* sV = sK + kStages * C::kTileBytes;
  float* sX = reinterpret_cast<float*>(smem + C::kXOffset);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  // the grid's units: query blocks x key parts x (b, h)
  const int nq = (p.Tq + kBQ - 1) / kBQ;
  const int ntiles = (p.Tk + BK - 1) / BK;
  const int live = p.D / BW;  // column blocks the boxes fill
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  // column blocks past D: zero once in Q and every K and V stage (never
  // loaded), seen by the async proxy that the products read through
  if (live < NB) {
    uint4* zq = reinterpret_cast<uint4*>(sQ + live * C::kBlockQ);
    for (int i = threadIdx.x; i < (NB - live) * C::kBlockQ / 16;
         i += blockDim.x)
      zq[i] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < 2 * kStages; ++s) {
      uint4* zt = reinterpret_cast<uint4*>(sK + s * C::kTileBytes +
                                           live * C::kBlockKV);
      for (int i = threadIdx.x; i < (NB - live) * C::kBlockKV / 16;
           i += blockDim.x)
        zt[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async_smem();
  }
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, C::kCons);
      mbar_init(empty_v + s, C::kCons);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the block's units, every gridDim.x-th in turn (at most one block an
  // SM): the ring's stages and phases, the exchange's buffers and Q's
  // phase run on across them (`base` key tiles and `done` units before
  // this one)
  int base = 0;
  for (int u = blockIdx.x, done = 0; u < nq * p.parts * p.BH;
       u += gridDim.x, ++done) {
    const int qb = u % nq, rest = u / nq;
    const int part = rest % p.parts, bh = rest / p.parts;
    const int b = bh / p.H, h = bh % p.H;
    const int t0 = part * p.part_tiles;
    const int n = min(t0 + p.part_tiles, ntiles) - t0;  // >= 1 (the host's)
    const int hk = p.Hkv == 1 ? 0 : h;

    // thread 0 issues every copy, each one box of all the column blocks:
    // Q (both warpgroups read the last unit's into registers before that
    // unit's first exchange) and the first two tiles now, then each later
    // tile once both warpgroups have released its stage (below)
    auto load = [&](int kv, int i) {
      const int t = t0 + i, s = (base + i) % kStages;
      uint64_t* full = (kv ? full_v : full_k) + s;
      unsigned char* tile = (kv ? sV : sK) + s * C::kTileBytes;
      const CUtensorMap* map = kv ? &map_v : &map_k;
      mbar_wait((kv ? empty_v : empty_k) + s,
                (((base + i) / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(full, live * C::kBlockKV);
      tma_load_5d(tile, map, full, 0, t * BK, 0, hk, b);
    };
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, live * C::kBlockQ);
      tma_load_5d(sQ, &map_q, full_q, 0, qb * kBQ, 0, h, b);
      for (int i = 0; i < min(n, kStages); ++i) {
        load(0, i);
        load(1, i);
      }
    }

    // each warpgroup: the unit's 64 rows (warp w rows 16w.., lane rows g
    // and g + 8), columns cw * kHalf.. of O, the same half of S's depth
    // (derived a unit: ptxas schedules the loop 2% faster than with them
    // hoisted out of it)
    const int cw = wg, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
    const float c = p.scale_log2;
    const uint32_t q_addr = smem_u32(sQ) + cw * C::kHalfBlocks * C::kBlockQ;
    const uint32_t k_addr = smem_u32(sK) + cw * C::kHalfBlocks * C::kBlockKV;
    const uint32_t v_addr = smem_u32(sV) + cw * C::kHalfBlocks * C::kBlockKV;
    const int row0 = qb * kBQ + warp * 16 + (lane >> 2);

    float o[C::kHalf / 2];
#pragma unroll
    for (int i = 0; i < C::kHalf / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];  // P of the tile, A fragments of P V
    uint32_t qa[C::kSteps][4];  // Q's half, the A fragments of S

    float sc[BK / 2];  // S of the tile, then its P in f32
    mbar_wait(full_q, done & 1);
    load_q<C>(qa, q_addr, warp, lane);
    fence_regs<4 * C::kSteps>(&qa[0][0]);
    mbar_wait(full_k + base % kStages, (base / kStages) & 1);
    s_issue<C>(sc, qa, k_addr + base % kStages * C::kTileBytes);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    if (tid == 0) mbar_arrive(empty_k + base % kStages);
    // per tile i, S of i done: the exchange, the softmax, then P V of i with
    // S of i + 1 behind it at the tensor cores, both waited for together
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i, s = (base + i) % kStages;
      const uint32_t parity = ((base + i) / kStages) & 1;

      // the exchange: this half's partial out, the other's in (buffer
      // (base + i) & 1: a warpgroup writes it again only past the next
      // tile's barrier, which the other passes after its read)
      float* xb = sX + ((base + i) & 1) * C::kXFloats;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        xb[(cw * (BK / 2) + r) * 128 + tid] = sc[r];
      named_bar_sync(1, C::kThreads);
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        sc[r] += xb[((cw ^ 1) * (BK / 2) + r) * 128 + tid];
      // past the barrier both warpgroups are done with K of tile i and V of
      // tile i - 1 in this unit: their stages take K of i + 2, V of i + 1
      if (threadIdx.x == 0) {
        if (i + 2 < n) load(0, i + 2);
        if (i >= 1 && i + 1 < n) load(1, i + 1);
      }

      // the online softmax, rows row0 and row0 + 8: the last tile's keys
      // past Tk are -inf; O to this tile's max; P of the tile
      if ((t + 1) * BK > p.Tk) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t * BK + 8 * j + 2 * t4 + (e & 1) >= p.Tk)
              sc[4 * j + e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mc[r] = mx[r] * c;
        alpha[r] = ex2_approx(fmaf(m[r], c, -mc[r]));
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        const float x = ex2_approx(fmaf(sc[j], c, -mc[r]));
        sc[j] = x;
        rs[r] += x;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int j = 0; j < C::kHalf / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      mbar_wait(full_v + s, parity);
      pv_issue<C>(o, pa, v_addr + s * C::kTileBytes);
      const int s1 = (base + i + 1) % kStages;
      if (i + 1 < n) {
        mbar_wait(full_k + s1, ((base + i + 1) / kStages) & 1);
        s_issue<C>(sc, qa, k_addr + s1 * C::kTileBytes);
      }
      wgmma_wait<0>();
      fence_regs<C::kHalf / 2>(o);
      fence_regs<BK / 2>(sc);
      if (tid == 0) {
        mbar_arrive(empty_v + s);
        if (i + 1 < n) mbar_arrive(empty_k + s1);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const long long bht = (long long)bh * p.Tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      if (p.parts == 1) {
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) +
                              (bht + row) * p.D;
#pragma unroll
        for (int j = 0; j < C::kHalf / 8; ++j) {
          const int col = cw * C::kHalf + 8 * j + 2 * t4;
          if (col < p.D)  // D is a multiple of 8: col + 1 < D too
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                      o[4 * j + 2 * r + 1] / l[r]);
        }
      } else {
        const long long prow = (long long)part * p.BH * p.Tq + bht + row;
        float* orow = p.opart + prow * p.D;
#pragma unroll
        for (int j = 0; j < C::kHalf / 8; ++j) {
          const int col = cw * C::kHalf + 8 * j + 2 * t4;
          if (col < p.D)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        }
        if (cw == 0 && t4 == 0) p.ml[prow] = make_float2(m[r], l[r]);
      }
    }
    base += n;
  }
}

// The parts of each row merged in part order: weights 2^((m_p - M) c)
// over the parts' row maxima M, out = sum_p w_p O_p / sum_p w_p l_p in
// bf16. One block a row of [B*H*Tq], four columns a thread.
__global__ void __launch_bounds__(128)
flash_fwd_wide_combine_kernel(const float* __restrict__ opart,
                              const float2* __restrict__ ml,
                              __nv_bfloat16* __restrict__ o, long long rows,
                              int D, int parts, float c) {
  const long long row = blockIdx.x;
  float mx = -INFINITY;
  for (int q = 0; q < parts; ++q) mx = fmaxf(mx, ml[q * rows + row].x);
  float w[kMaxParts], lsum = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxParts; ++q) {
    w[q] = 0.f;
    if (q < parts) {
      const float2 x = ml[q * rows + row];
      w[q] = exp2f((x.x - mx) * c);
      lsum += w[q] * x.y;
    }
  }
  for (int col = 4 * threadIdx.x; col < D; col += 4 * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q) {
      if (q < parts) {
        const float4 x = *reinterpret_cast<const float4*>(
            opart + (q * rows + row) * D + col);
        acc.x += w[q] * x.x;
        acc.y += w[q] * x.y;
        acc.z += w[q] * x.z;
        acc.w += w[q] * x.w;
      }
    }
    __nv_bfloat16* out = o + row * D + col;
    *reinterpret_cast<__nv_bfloat162*>(out) =
        __floats2bfloat162_rn(acc.x / lsum, acc.y / lsum);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) =
        __floats2bfloat162_rn(acc.z / lsum, acc.w / lsum);
  }
}

// ---------------------------------------------------------------------------
// host side

// the scratch bytes of a launch with `parts` parts: O's parts in f32,
// then the rows' (max, sum)
inline long long work_bytes(int parts, int B, int H, int Tq, int D) {
  if (parts == 1) return 0;
  const long long rows = (long long)parts * B * H * Tq;
  return rows * D * 4 + rows * 8;
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k/v [B, Hkv, Tk, D] bf16 (Hkv 1 or H) with element
// strides over batch, head and token (each a multiple of 8 elements, the
// pointers 16-byte aligned, unit stride over D), 128 < D <= 512 and a
// multiple of 64; o a contiguous [B, H, Tq, D] bf16; work the plan's
// scratch (work_bytes of them, 16-byte aligned; null where the plan needs
// none). The keys split into `parts` parts of `part_tiles` tiles of
// kWideBK keys, none empty, at most kMaxParts; `grid` blocks (at most the
// units, query blocks x parts x B x H) deal the units among them
// (ops/attention.py wide_wgmma_parts chooses all three). scale > 0.
// Returns a cudaError_t (0 on success), or 10000 + the CUresult of a
// failed tensor-map encode.
int flash_attn_fwd_wide_sm90(const void* q, const void* k, const void* v,
                             void* o, void* work, long long work_len,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             int B, int H, int Hkv, int Tq, int Tk, int D,
                             int parts, int part_tiles, int grid,
                             float scale, void* stream) {
  using C = Cfg;
  const int ntiles = (Tk + C::BK - 1) / C::BK;
  const long long units =
      (long long)(Tq + C::kBQ - 1) / C::kBQ * B * H * parts;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      (Hkv != 1 && Hkv != H) || D <= 128 || D > C::DK || D % C::BW ||
      parts < 1 || parts > kMaxParts || part_tiles < 1 ||
      (long long)(parts - 1) * part_tiles >= ntiles ||
      (long long)parts * part_tiles < ntiles || grid < 1 || grid > units ||
      units > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long need = work_bytes(parts, B, H, Tq, D);
  if (need > 0 && (work == nullptr || work_len < need))
    return (int)cudaErrorInvalidValue;
  WideParams p;
  p.o = o;
  p.opart = static_cast<float*>(work);
  p.ml = need > 0 ? reinterpret_cast<float2*>(
                        static_cast<char*>(work) +
                        (long long)parts * B * H * Tq * D * 4)
                  : nullptr;
  p.BH = B * H; p.H = H; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.parts = parts;
  p.part_tiles = part_tiles;
  p.scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap mq, mk, mv;
  int e = encode_token_blocks(&mq, q, D, Tq, H, B, q_st, q_sh, q_sb, C::kBQ);
  if (!e)
    e = encode_token_blocks(&mk, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, C::BK);
  if (!e)
    e = encode_token_blocks(&mv, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, C::BK);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = flash_fwd_wide_wgmma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, C::kThreads, C::kSmem, s>>>(mq, mk, mv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const long long rows = (long long)B * H * Tq;
  flash_fwd_wide_combine_kernel<<<(unsigned)rows, 128, 0, s>>>(
      p.opart, p.ml, static_cast<__nv_bfloat16*>(o), rows, D, parts,
      p.scale_log2);
  return (int)cudaGetLastError();
}

// The kernel's constants, for the host's plan (ops/attention.py): query
// rows and keys a block, ring stages, the most key parts the combine
// merges, and the shared memory a block.
void flash_attn_fwd_wide_sm90_plan(int* bq, int* bk, int* stages,
                                   int* max_parts, int* smem) {
  using C = Cfg;
  *bq = C::kBQ;
  *bk = C::BK;
  *stages = C::kStages;
  *max_parts = kMaxParts;
  *smem = C::kSmem;
}

const char* flash_attn_fwd_wide_sm90_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
