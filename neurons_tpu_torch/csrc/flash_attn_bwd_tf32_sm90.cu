// Flash-attention backward on f32 input at head dims up to 128 on Hopper's
// own instructions (sm_90a): TF32 warpgroup products (wgmma m64nNk8) fed by
// TMA tile loads into an mbarrier ring. Bound through a plain C interface
// and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for f32 at 8 <= D <= 128 (D % 4 == 0) on rows, strides and
// pointers that are 16-byte multiples, the JAX package's
//   neurons_tpu/ops/attention.py:276  _flash_bwd_kernel
//     (via _flash_bwd_pallas, :349): unbiased, over one or H kv heads
//   neurons_tpu/ops/attention.py:458  _flash_bwd_bias_kernel
//     (via _flash_bwd_pallas_bias, :530, its multi-query head sum
//     _mq_reduce at :736): with the prior's layout, one bias slice a head
//     shared over the batch ([H, Tq, Tk]) over multi-query k/v
//     ([B, 1, Tk, D]), at D <= 64 and Tk <= 576
// with the numerics of the f32 route (`flash_attention_bwd_reference(...,
// tf32=True)`): s = q k^T * scale (+ bias) from q and k rounded to TF32 by
// cvt.rna (to nearest, ties away from zero), p = exp(s - lse), delta =
// sum_d g * out (unrounded, f32), dv = p^T g (p and g rounded), dp = g v^T
// (g and v rounded), ds = p (dp - delta), dk = (ds*scale)^T q and dq =
// (ds*scale) k (ds*scale, q and k rounded), dbias = ds summed over the
// batch; every sum in f32. The probabilities take one FFMA and ex2.approx
// (the register kernels the accurate expf; the error gate holds either).
// Outputs, all f32 and each element written once: dq [B*H, Tq, D], dk and
// dv [B*H, Tk, D] (unbiased; the caller sums multi-query ones over heads),
// or [B, 1, Tk, D] summed over the heads on chip and dbias [H, Tq, Tk]
// summed over the batch on chip (the prior's). Every f32 backward of the
// paths at d <= 128 comes here: the f32 stage-2 step's DecoderVideo
// [60, 1, T, T, D] at (T, D) = (256, 128), (1024, 64), (4096, 32) and the
// prior's [10, 32, 513, 514, 52], and the tiny CLI chain's;
// flash_attn_bwd.cu's TF32 register kernels keep rows off 16 bytes, d 4
// and the other f32 bias layouts.
//
// What bounds it on an H100: 10 B H Tq Tk D operations (5 products; the
// two passes below make 7) at the TF32 rate (495 TFLOP/s) and 2 B H Tq Tk
// exponentials (one a pass, the MUFU unit's ex2, about 3.7 T/s); the bytes
// (q, k, v, g, out, lse, the bias in; dq, dk, dv, dbias out) are below
// both at the paths' shapes: the prior's 43.9 GFLOP take 88.6 us, its
// 169 M exponentials 46 us and its 120 MB 36 us. The register kernels
// reached a tenth of it: mma.sync m16n8k8 per warp of 16 rows, every ring
// tile rounded in shared memory by all threads under a block barrier (one
// stage at large d, where the next load waited for every warp), scalar
// 4-byte B-operand reads, the head dim padded to 32, 64 or 128, and at the
// prior three passes (the dbias pass recomputing S and dP per batch row,
// 9 products) with per-(b, h) dK/dV summed by torch.
//
// Design. TF32 wgmma takes K-major operands only (no transpose bit), so
// every B operand lies with its depth along the row:
//  * a producer warpgroup: one thread issues TMA boxes (maps of the real
//    (D, T, H, B) strides; a multi-query k/v is a head extent of 1) of f32
//    tiles, each box one column block of BW floats swizzled by its row
//    width, into a ring of kStages stages under full / ready / empty
//    mbarriers; then the warpgroup rounds each tile in place once and
//    writes the transposes the gradient products read (`round_transpose`):
//    T's row n (the tile's column n) holds the tile's rows in 32-row
//    blocks of 128 swizzled bytes, each 8-row group in the order 0 2 4 6
//    1 3 5 7, so that P (or dS) goes from an accumulator into the A
//    operand as a = (c0, c2, c1, c3) without a shuffle (the TF32 forward's
//    V^T trick); no consumer rounds a tile, and no block barrier sits
//    between a load and the products;
//  * consumer warpgroups of 64 rows issue the products, the real k8 steps
//    of the head dim only (d 52: 7, not 8), and take the exponentials; a
//    consumer waits for its own products, so the overlap of exponentials
//    and products is between the warpgroups.
// Two passes and no atomics, so every sum has one fixed order and a rerun
// gives equal bits. Unbiased (BwdTf32Cfg):
//  * dQ pass (flash_bwd_dq_tf32_wgmma_kernel, launched first): a block owns
//    one (b, h) and 64 kConsQ queries, Q and g resident (rounded once);
//    K, V and K^T tiles of kBK keys stream. S = Q K^T and dP = g V^T (ss),
//    dS * scale in registers (keys past Tk at p = 0: TMA fills them with
//    zeros, and a zero logit is not -inf), dQ += (dS * scale) K (rs, B =
//    K^T). Each thread takes its two rows' delta = sum g * out from global
//    memory (its quad's columns, summed over the quad) and writes it for
//    the dK/dV pass: no torch pass.
//  * dK/dV pass (flash_bwd_dkdv_tf32_wgmma_kernel): a block owns one (b, h)
//    and 64 keys a consumer (at DN > 64 two consumers share 64 keys, one
//    accumulating dV, recomputing S^T, the other dK: 64 registers a thread
//    each), K and V resident; Q, g, Q^T, g^T tiles of kBQ queries and their
//    lse * log2(e) and delta stream. S^T = K Q^T, dP^T = V g^T (ss), P^T and
//    dS^T * scale in registers, dV += P^T g (rs, B = g^T), dK += (dS^T *
//    scale) Q (rs, B = Q^T).
// With the prior's bias (BiasTf32Cfg), the three reductions run over three
// index sets, and each pass keeps its own on chip:
//  * dQ + delta + dbias (flash_bwd_dq_bias_tf32_wgmma_kernel, first): a
//    block owns one head and 64 queries; two consumers split the key tiles
//    (even and odd) and walk the batch rows, each row's Q and g as TF32 A
//    fragments read from global memory into registers (rounded there once
//    a row) beside its delta and lse; K, V and K^T tiles of 32 keys stream
//    for (b, key tile) in order. dbias[h][its 64 queries][keys] += dS in an
//    f32 accumulator in shared memory ([tile][register][thread]: no
//    barrier, no bank conflict), summed over the batch rows in order and
//    written once. Shared memory sets the split: the accumulator of 64
//    queries x Tk keys (147,456 bytes at 576 keys) beside a 3-stage ring of
//    64-key K, V and K^T tiles (3 x 47,104 at d 52) would pass the 232,448
//    a block may have, so the tiles are 32 keys (23,552 a stage) and the
//    accumulator is sized by Tk at launch (139,264 at the prior's 514). At
//    the end of a batch row the odd consumer hands its f32 dQ over through
//    the dq output (the same thread's elements; named barriers) and the even
//    one adds it to its own and writes dQ and delta.
//  * dK/dV (flash_bwd_dkdv_bias_tf32_wgmma_kernel): a block owns one batch
//    row, 64 keys (K, V resident) and one of kGroups head groups, a
//    thread-block cluster of the kGroups blocks shares (b, keys); two
//    consumers take the group's (head, 32-query tile) steps in turn, each
//    with the bias read from global memory while its products run; at the
//    end the second consumer's dK/dV go to the first through shared memory,
//    and each block sums its share of the elements over the cluster's
//    blocks in rank order (distributed shared memory) and writes them once
//    into [B, 1, Tk, D]: no per-(b, h) tensor, no torch sum, no dbias pass.
// What was measured (an H100 at 700 W, device time; PERF.md has the runs):
// the prior's backward 1.76 ms against 2.95 on the register kernels and
// 2.59 for the library's backward alone, its two passes about even; the
// decoder's [60, 1, 4096^2, 32] 2.87 ms against 6.0 and 16.1, its dK/dV
// pass 1.62 of it. The accurate expf in place of one FFMA and ex2.approx
// costs 19% there; a third dK/dV consumer at DN <= 32 spilled and was 3.5%
// slower than two; 32-query tiles there 12% slower; 8 head groups a cluster
// for the prior no better than 4 (tools/torch_flash_bwd_variants.py).

#include <cooperative_groups.h>

#include "mma_sm80.cuh"  // to_tf32
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemMax = 232448;  // the shared memory a block may use

// The column blocks of a K-major f32 tile at DN (the head dim rounded up to
// 8): BW floats a block, one swizzled row of RB bytes (at most d: a TMA
// box may not be wider than its map), NB blocks of DKS columns in all;
// KS k8 steps over the head dim (the TF32 forward's Tf32Cfg)
template <int DN_>
struct Cols {
  static constexpr int DN = DN_, KS = DN / 8;
  static constexpr int BW = DN <= 16 ? 8 : DN <= 32 ? 16 : 32;
  static constexpr int NB = (DN + BW - 1) / BW, DKS = BW * NB;
  static constexpr int RB = 4 * BW;
  static constexpr int kMode = swizzle_mode(RB);
  static_assert(DN % 8 == 0 && DN >= 8 && DN <= 128, "DN");
};

// The unbiased instance at DN. dQ pass: kConsQ consumers of 64 queries
// (3 at DN <= 32, within 128 registers; else 2), K/V tiles of kBK keys (64,
// 32 past DN 64: dQ's registers and the shared memory), kStagesQ stages.
// dK/dV pass: kConsKV = 2 consumers of 64 keys each (at DN > 64, kSplit,
// both on 64 keys, one for dV and one for dK), Q/g tiles of kBQ queries
// (64, 32 past DN 64), kStagesKV stages. A third dK/dV consumer at DN <= 32
// held its registers to 128 and spilled; two were 3.5% faster at the
// decoder's 64 x 64 site (tools/torch_flash_bwd_variants.py, PERF.md).
template <int DN_>
struct BwdTf32Cfg : Cols<DN_> {
  using B = Cols<DN_>;
  static constexpr int kConsQ = DN_ <= 32 ? 3 : 2;
  static constexpr int kRowsQ = 64 * kConsQ;
  static constexpr int kBK = DN_ <= 64 ? 64 : 32;
  static constexpr int kStagesQ = DN_ <= 64 ? 3 : 2;
  static constexpr int kResQ = kRowsQ * B::DKS * 4;  // a resident Q or g
  static constexpr int kTileK = kBK * B::DKS * 4;    // a K or V tile
  static constexpr int kTileKt = DN_ * kBK * 4;      // K^T
  static constexpr int kStageQ = 2 * kTileK + kTileKt;
  // Q, g, the ring, the barriers (full and ready Q/g; full, ready and
  // empty a stage), the slack that aligns the tiles to 1024 bytes
  static constexpr int kBarQ = 2 * kResQ + kStagesQ * kStageQ;
  static constexpr int kSmemQ = kBarQ + 8 * (2 + 3 * kStagesQ) + 1024;
  static constexpr int kThreadsQ = 128 * (1 + kConsQ);

  static constexpr bool kSplit = DN_ > 64;
  static constexpr int kConsKV = 2;
  static constexpr int kRowsKV = kSplit ? 64 : 64 * kConsKV;
  static constexpr int kBQ = DN_ <= 64 ? 64 : 32;
  static constexpr int kStagesKV = DN_ <= 32 ? 3 : 2;
  static constexpr int kResKV = kRowsKV * B::DKS * 4;  // a resident K or V
  static constexpr int kTileQ = kBQ * B::DKS * 4;      // a Q or g tile
  static constexpr int kTileQt = DN_ * kBQ * 4;        // Q^T or g^T
  static constexpr int kStageKV = 2 * kTileQ + 2 * kTileQt;
  // K, V, the ring, each stage's lse * log2(e) and delta, the barriers
  static constexpr int kStatKV = 2 * kResKV + kStagesKV * kStageKV;
  static constexpr int kBarKV = kStatKV + kStagesKV * 2 * kBQ * 4;
  static constexpr int kSmemKV = kBarKV + 8 * (2 + 3 * kStagesKV) + 1024;
  static constexpr int kThreadsKV = 128 * (1 + kConsKV);
  static_assert(kSmemQ <= kSmemMax && kSmemKV <= kSmemMax, "shared memory");
  static_assert(kResQ % 1024 == 0 && kTileK % 1024 == 0 &&
                    kTileKt % 1024 == 0 && kResKV % 1024 == 0 &&
                    kTileQ % 1024 == 0 && kTileQt % 1024 == 0,
                "alignment");
};

// The prior's instance at DN <= 64. dQ pass: 2 consumers, key tiles of 32,
// 3 stages, the dbias accumulator (one 8 KB tile of 64 queries x 32 keys a
// key tile) sized by Tk at launch. dK/dV pass: kGroups head groups a
// cluster, 2 consumers, 64 keys, query tiles of 32, 3 stages.
template <int DN_>
struct BiasTf32Cfg : Cols<DN_> {
  using B = Cols<DN_>;
  static constexpr int kThreads = 384;
  static constexpr int kBK1 = 32, kStages1 = 3;
  static constexpr int kTileK = kBK1 * B::DKS * 4;
  static constexpr int kTileKt = DN_ * kBK1 * 4;
  static constexpr int kStage1 = 2 * kTileK + kTileKt;
  static constexpr int kAccTile = kBK1 * 64 * 4;
  static constexpr int kMaxKeyTiles = 18;  // Tk <= 576
  // the ring, the barriers (full, ready, empty a stage), the slack; the
  // accumulator's key tiles come on top (smem1)
  static constexpr int kFixed1 = kStages1 * kStage1 + 8 * 3 * kStages1 + 1024;
  static constexpr int smem1(int ntk) { return ntk * kAccTile + kFixed1; }
  static constexpr int kGroups = 4, kBQ2 = 32, kStages2 = 3;
  static constexpr int kRes2 = 64 * B::DKS * 4;
  static constexpr int kTileQ = kBQ2 * B::DKS * 4;
  static constexpr int kTileQt = DN_ * kBQ2 * 4;
  static constexpr int kStage2 = 2 * kTileQ + 2 * kTileQt;
  static constexpr int kStat2 = 2 * kRes2 + kStages2 * kStage2;
  static constexpr int kBar2 = kStat2 + kStages2 * 2 * kBQ2 * 4;
  static constexpr int kSmem2 = kBar2 + 8 * (2 + 3 * kStages2) + 1024;
  static_assert(DN_ <= 64, "the prior's instances");
  static_assert(kMaxKeyTiles * kAccTile + kFixed1 <= kSmemMax &&
                    kSmem2 <= kSmemMax,
                "shared memory");
  static_assert(2 * DN_ / 2 * 128 * 4 <= kStages2 * kStage2,
                "dK and dV park in the ring");
};

struct BwdTf32Params {
  const float *q, *g, *out, *bias;  // q, g, bias read directly (the prior)
  const float* lse;                 // [B*H, Tq]
  float* delta;  // [B*H, Tq]: written by the dQ pass, read by dK/dV's
  float* dq;     // [B*H, Tq, D]
  float* dk;     // [B*H, Tk, D], or [B, 1, Tk, D] summed over heads
  float* dv;
  float* dbias;  // [H, Tq, Tk]
  long long q_sb, q_sh, q_st, g_sb, g_sh, g_st, bias_sh, bias_sq;
  int B, H, Hkv, Tq, Tk, D;
  float scale, scale_log2;
};

// the swizzled place of byte `off` of a region aligned to the swizzle's
// period, in rows of RB bytes: 16-byte chunk bits XOR address bits 7..
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = RB / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

__device__ __forceinline__ float rna(float x) {
  return __uint_as_float(to_tf32(x));
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(rna(v.x), rna(v.y), rna(v.z), rna(v.w));
}

__device__ __forceinline__ float comp(const float4& x, int w) {
  return w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
}

// `kBytes` of f32 at `base` rounded to TF32 in place by the 128 threads of
// a warpgroup, 16 bytes a thread a step
template <int kBytes>
__device__ __forceinline__ void round_in_place(unsigned char* base, int tid) {
#pragma unroll 4
  for (int i = tid; i < kBytes / 16; i += 128) {
    float4* p = reinterpret_cast<float4*>(base + 16 * i);
    *p = round4(*p);
  }
}

// A raw tile of R token rows (column blocks of BW floats, TMA's swizzle)
// rounded to TF32 in place, and its transpose written rounded to `tr`: row
// n (head column n < DN) holds the R tokens in 32-token blocks of 128
// swizzled bytes, block kb at kb * DN * 128, each 8-token group in the
// order 0 2 4 6 1 3 5 7. A piece j (the TF32 forward's transpose_v): lane
// position l = j % 8 (tokens 8 (l >> 1) + 2u + (l & 1) of a 32-token
// block, u = 0..3: positions 8 (l >> 1) + 4 (l & 1) + u of T's rows), block
// kb and 4-column chunk c from j / 8; the 8 lanes of a phase share (kb, m)
// and take chunk m ^ (l & 6) where m's group of 8 chunks is whole, so their
// 16-byte reads and writes each hit 8 distinct bank groups. The transpose
// goes to its own region, so a thread writes each piece back in place as
// soon as it has read it. Columns D .. DN of the tile are TMA's zeros.
template <int R, int DN, int BW>
__device__ __forceinline__ void round_transpose(unsigned char* raw,
                                                unsigned char* tr, int tid) {
  constexpr int RB = 4 * BW, NKB = R / 32, FULL = (DN / 4) & ~7;
  constexpr int NJ = (R / 8) * 2 * (DN / 4);
  static_assert(R % 32 == 0, "32-token blocks");
#pragma unroll 2
  for (int j = tid; j < NJ; j += 128) {
    const int l = j & 7, rest = j >> 3, kb = rest % NKB, m = rest / NKB;
    const int c = m < FULL ? (m ^ (l & 6)) : m;
    const int col = 4 * c, blk = col / BW, cc = col % BW;
    unsigned char* src = raw + blk * R * RB;
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = 32 * kb + 8 * (l >> 1) + 2 * u + (l & 1);
      float4* at = reinterpret_cast<float4*>(src + swz<RB>(key * RB + cc * 4));
      x[u] = round4(*at);
      *at = x[u];
    }
    unsigned char* dst = tr + kb * DN * 128;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      *reinterpret_cast<float4*>(dst + swz<128>((4 * c + w) * 128 + l * 16)) =
          make_float4(comp(x[0], w), comp(x[1], w), comp(x[2], w),
                      comp(x[3], w));
  }
}

// an address the compiler cannot see through: descriptors are computed
// from it afresh at each tile instead of being held across the loop
__device__ __forceinline__ uint32_t fresh(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// acc = A B^T over the head dim, issued under one fence, not committed: A
// 64 rows at a (kARows rows a column block), B N rows at b (kBRows rows a
// column block), both raw K-major tiles; k8 step ks reads 8 columns inside
// column block ks * 8 / BW. The first step overwrites acc.
template <class C, int N, int kARows, int kBRows>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a, uint32_t b) {
  constexpr int KS = C::KS, RB = C::RB;
  uint64_t da[KS], db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int blk = ks * 8 / C::BW, off = (ks * 8 % C::BW) * 4;
    da[ks] = gmma_desc(a + blk * kARows * RB + off, 16, 8 * RB, C::kMode);
    db[ks] = gmma_desc(b + blk * kBRows * RB + off, 16, 8 * RB, C::kMode);
  }
  pin<KS>(da);
  pin<KS>(db);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  wgmma_fence();
  WgmmaTf32<N>::ss0(acc, da[0], db[0], zero);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) WgmmaTf32<N>::ss(acc, da[ks], db[ks], one);
}

// acc = A B^T over the head dim with A the TF32 fragments a[KS] in
// registers, B a raw K-major tile of kBRows rows a column block at b;
// issued under one fence, not committed, the first step overwriting acc
template <class C, int kBRows>
__device__ __forceinline__ void issue_rk(float* acc, uint32_t (*a)[4],
                                         uint32_t b) {
  constexpr int KS = C::KS, RB = C::RB;
  uint64_t db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int blk = ks * 8 / C::BW, off = (ks * 8 % C::BW) * 4;
    db[ks] = gmma_desc(b + blk * kBRows * RB + off, 16, 8 * RB, C::kMode);
  }
  pin<KS>(db);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  fence_regs<4 * KS>(&a[0][0]);
  wgmma_fence();
  WgmmaTf32<32>::rs0(acc, a[0], db[0], zero);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) WgmmaTf32<32>::rs(acc, a[ks], db[ks], one);
}

// acc (64 x DN) += A B over K tokens: A the TF32 fragments a[K / 8] in
// registers (each 8-token group in the permuted order), B a transposed tile
// at tr (DN rows of 32-token blocks of 128 bytes); issued under one fence,
// not committed
template <int DN, int K>
__device__ __forceinline__ void issue_rt(float* acc, uint32_t (*a)[4],
                                         uint32_t tr) {
  uint64_t db[K / 8];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    db[kk] = gmma_desc(tr + (kk / 4) * DN * 128 + (kk % 4) * 32, 16, 1024, 1);
  pin<K / 8>(db);
  int one = 1;
  asm volatile("" : "+r"(one));
  fence_regs<DN / 2>(acc);
  fence_regs<K / 2>(&a[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) WgmmaTf32<DN>::rs(acc, a[kk], db[kk], one);
}

// an accumulator of N columns rounded into the TF32 A fragments of the
// N / 8 k8 steps over its columns: a = c0, c2, c1, c3 of chunk kk (A's
// column t is column 2t of the chunk, t + 4 is 2t + 1, as the transposes
// hold them)
template <int N>
__device__ __forceinline__ void hand_off(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = to_tf32(c[4 * kk + 0]);
    a[kk][1] = to_tf32(c[4 * kk + 2]);
    a[kk][2] = to_tf32(c[4 * kk + 1]);
    a[kk][3] = to_tf32(c[4 * kk + 3]);
  }
}

// p = exp(x - lse) = 2^(x * c - lse * log2(e)): one FFMA and ex2.approx
// (c = log2(e), or scale * log2(e) for a raw logit; l2 = lse * log2(e))
__device__ __forceinline__ float prob(float x, float c, float l2) {
  return ex2_approx(fmaf(x, c, -l2));
}

// 64 rows' accumulator (DN columns) into rows of D floats at `to` (row
// stride D), rows row0 and row0 + 8 of this lane, up to n rows
template <int DN>
__device__ __forceinline__ void write_rows(float* to, const float* acc,
                                           int row0, int n, int D, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    float* at = to + (long long)row * D;
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      if (col < D)  // D % 4 == 0: col + 1 < D too
        *reinterpret_cast<float2*>(at + col) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// unbiased, dQ pass: dQ of kRowsQ queries of one (b, h), and their delta

template <int DN>
__global__ void __launch_bounds__(BwdTf32Cfg<DN>::kThreadsQ, 1)
flash_bwd_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_g,
                               const BwdTf32Params p) {
  using C = BwdTf32Cfg<DN>;
  constexpr int BK = C::kBK, S = C::kStagesQ, R = C::kRowsQ, RB = C::RB,
                BW = C::BW, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;  // [NB][R][BW]
  unsigned char* sG = sQ + C::kResQ;
  unsigned char* ring = sG + C::kResQ;  // a stage: K [NB][BK][BW], V, K^T
  uint64_t* full_qg = reinterpret_cast<uint64_t*>(smem + C::kBarQ);
  uint64_t* ready_qg = full_qg + 1;  // Q and g rounded
  uint64_t* full = ready_qg + 1;     // a stage's K and V landed
  uint64_t* ready = full + S;        // K and V rounded, K^T written
  uint64_t* empty = ready + S;       // the consumers are done with it

  const int nq = (p.Tq + R - 1) / R;
  const int qb = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int ntiles = (p.Tk + BK - 1) / BK;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    mbar_init(full_qg, 1);
    mbar_init(ready_qg, 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 128);
      mbar_init(empty + s, C::kConsQ);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: the copies, then each tile's pass
    const int hk = p.Hkv == 1 ? 0 : h;
    auto load = [&](int t) {  // K and V of key tile t into stage t % S
      unsigned char* st = ring + (t % S) * C::kStageQ;
      mbar_arrive_expect_tx(full + t % S, 2 * C::kTileK);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(st + j * BK * RB, &map_k, full + t % S, j * BW, t * BK,
                    hk, b);
        tma_load_4d(st + C::kTileK + j * BK * RB, &map_v, full + t % S,
                    j * BW, t * BK, hk, b);
      }
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(full_qg, 2 * C::kResQ);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sQ + j * R * RB, &map_q, full_qg, j * BW, qb * R, h, b);
        tma_load_4d(sG + j * R * RB, &map_g, full_qg, j * BW, qb * R, h, b);
      }
      for (int t = 0; t < S && t < ntiles; ++t) load(t);
    }
    mbar_wait(full_qg, 0);
    round_in_place<C::kResQ>(sQ, tid);
    round_in_place<C::kResQ>(sG, tid);
    fence_proxy_async_smem();
    mbar_arrive(ready_qg);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      unsigned char* st = ring + s * C::kStageQ;
      mbar_wait(full + s, (t / S) & 1);
      round_transpose<BK, DN, BW>(st, st + 2 * C::kTileK, tid);
      round_in_place<C::kTileK>(st + C::kTileK, tid);
      fence_proxy_async_smem();
      mbar_arrive(ready + s);
      // stage (t - 1) % S takes tile t - 1 + S once the consumers are done
      // with tile t - 1 (after this tile's pass, so that the wait does not
      // hold it up)
      if (tid == 0 && t >= 1 && t - 1 + S < ntiles) {
        mbar_wait(empty + (t - 1) % S, ((t - 1) / S) & 1);
        load(t - 1 + S);
      }
    }
    return;
  }

  // a consumer: 64 queries, warp w rows 16w.., lane rows g and g + 8; the
  // key columns of its S registers: 8 i + 2 (lane % 4) + (e & 1)
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int row0 = qb * R + cw * 64 + warp * 16 + (lane >> 2);
  const float c = p.scale_log2;
  // lse * log2(e) and delta = sum_d g * out of rows row0, row0 + 8 (+inf
  // and 0 past Tq), from the unrounded g: each lane of a quad sums its D / 4
  // columns in order, the quad adds the four sums (lanes xor 1, then xor
  // 2); written for the dK/dV pass
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < p.Tq;
    const long long at = ((long long)bh * p.Tq + row) * p.D + t4 * (p.D / 4);
    float acc = 0.f;
    if (ok)
      for (int j = 0; j < p.D / 4; ++j) acc = fmaf(p.g[at + j], p.out[at + j], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    l2[r] = ok ? p.lse[(long long)bh * p.Tq + row] * kLog2e : INFINITY;
    if (ok && t4 == 0) p.delta[(long long)bh * p.Tq + row] = acc;
  }

  float dq[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
  uint32_t da[BK / 8][4];
  mbar_wait(ready_qg, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    const uint32_t qa = fresh(smem_u32(sQ)) + cw * 64 * RB;
    const uint32_t ga = fresh(smem_u32(sG)) + cw * 64 * RB;
    const uint32_t kt = fresh(smem_u32(ring)) + s * C::kStageQ;
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(ready + s, (t / S) & 1);
    issue_ss<C, BK, R, BK>(sc, qa, kt);              // S = Q K^T
    issue_ss<C, BK, R, BK>(dp, ga, kt + C::kTileK);  // dP = g V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    fence_regs<BK / 2>(dp);
    // dS * scale; keys past Tk (the last tile's zero rows) give p = 0
    const bool last = (t + 1) * BK > p.Tk;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = prob(sc[4 * i + e], c, l2[r]);
        if (last && t * BK + 8 * i + 2 * t4 + (e & 1) >= p.Tk) pv = 0.f;
        dp[4 * i + e] = pv * (dp[4 * i + e] - dl[r]) * p.scale;
      }
    hand_off<BK>(da, dp);
    issue_rt<DN, BK>(dq, da, kt + 2 * C::kTileK);  // dQ += (dS * scale) K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DN / 2>(dq);
    if (tid == 0) mbar_arrive(empty + s);
  }
  write_rows<DN>(p.dq + (long long)bh * p.Tq * p.D, dq, row0, p.Tq, p.D, t4);
}

// ---------------------------------------------------------------------------
// the dK/dV passes' consumer step: one tile of kBQ queries against this
// warpgroup's 64 keys (k_addr, v_addr: its rows of the resident tiles,
// kRes rows a column block): S^T = K Q^T (and, for dK, dP^T = V g^T), P^T
// (and dS^T * scale), then dV += P^T g (kDV) and dK += (dS^T * scale) Q
// (kDK). st: the tile's lse * log2(e) [BQ] and delta [BQ]; kBias: the
// logits scaled and biased first, the bias of the tile's first query and
// this lane's first key at bias_at (query stride bsq), tq of its queries
// inside Tq, krow_ok the lane's two keys inside Tk (bits 0 and 1)

template <class C, int BQ, int kRes, bool kDV, bool kDK, bool kBias>
__device__ __forceinline__ void dkdv_step(float* dk, float* dv,
                                          uint32_t k_addr, uint32_t v_addr,
                                          uint32_t stage, const float* st,
                                          const float* bias_at, long long bsq,
                                          int tq, int krow_ok,
                                          const BwdTf32Params& p) {
  constexpr int DN = C::DN, TQ = BQ * C::DKS * 4, TQT = DN * BQ * 4;
  const int tid = threadIdx.x & 127, t4 = tid & 3;
  float sc[BQ / 2], dp[kDK ? BQ / 2 : 1];
  issue_ss<C, BQ, kRes, BQ>(sc, k_addr, stage);         // S^T = K Q^T
  if constexpr (kDK) issue_ss<C, BQ, kRes, BQ>(dp, v_addr, stage + TQ);
  wgmma_commit();
  float bv[kBias ? BQ / 2 : 1];
  if constexpr (kBias) {  // bias[q][key]: keys key, key + 8 of this lane
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * i + 2 * t4 + (e & 1);
        const bool ok = q < tq && ((krow_ok >> (e >> 1)) & 1);
        bv[4 * i + e] = ok ? bias_at[(long long)q * bsq + 8 * (e >> 1)] : 0.f;
      }
  }
  wgmma_wait<0>();
  fence_regs<BQ / 2>(sc);
  if constexpr (kDK) fence_regs<BQ / 2>(dp);
  const float c = kBias ? kLog2e : p.scale_log2;
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * i + 2 * t4);
    const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * i + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e];
      if constexpr (kBias) x = fmaf(x, p.scale, bv[4 * i + e]);
      const float pv = prob(x, c, (e & 1) ? l2.y : l2.x);
      sc[4 * i + e] = pv;
      if constexpr (kDK)
        dp[4 * i + e] = pv * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x)) * p.scale;
    }
  }
  uint32_t pa[BQ / 8][4];
  if constexpr (kDV) {  // dV += P^T g
    hand_off<BQ>(pa, sc);
    issue_rt<DN, BQ>(dv, pa, stage + 2 * TQ + TQT);
  }
  uint32_t da[kDK ? BQ / 8 : 1][4];
  if constexpr (kDK) {  // dK += (dS^T * scale) Q
    hand_off<BQ>(da, dp);
    issue_rt<DN, BQ>(dk, da, stage + 2 * TQ);
  }
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (kDV) fence_regs<DN / 2>(dv);
  if constexpr (kDK) fence_regs<DN / 2>(dk);
}

// The dK/dV producer's pass of one stage: Q and g rounded in place, Q^T and
// g^T written, the tile's lse * log2(e) (+inf past Tq, so p = 0 there) and
// delta (0 past Tq) beside them
template <class C, int BQ>
__device__ __forceinline__ void dkdv_stage_pass(unsigned char* stage,
                                                float* st, const float* lse,
                                                const float* delta, int q0,
                                                int tq, int tid) {
  constexpr int TQ = BQ * C::DKS * 4, TQT = C::DN * BQ * 4;
  round_transpose<BQ, C::DN, C::BW>(stage, stage + 2 * TQ, tid);
  round_transpose<BQ, C::DN, C::BW>(stage + TQ, stage + 2 * TQ + TQT, tid);
  if (tid < BQ) {
    const int q = q0 + tid;
    st[tid] = q < tq ? lse[q] * kLog2e : INFINITY;
    st[BQ + tid] = q < tq ? delta[q] : 0.f;
  }
}

// the unbiased dK/dV consumer's view of its block: its keys' rows of the
// resident K and V, the ring, the stages' stats and barriers
struct Ring {
  uint32_t k, v, ring;
  const float* stat;
  uint64_t *ready, *empty;
};

// An unbiased dK/dV consumer warpgroup over every query tile: dV (kDV)
// and dK (kDK) of its 64 keys (this lane's first: key0), written once into
// [B*H, Tk, D] at `out`
template <class C, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_consumer(const Ring& r, int nq,
                                              long long out, int key0,
                                              const BwdTf32Params& p) {
  constexpr int DN = C::DN, BQ = C::kBQ, S = C::kStagesKV;
  const int tid = threadIdx.x & 127;
  float dk[kDK ? DN / 2 : 1], dv[kDV ? DN / 2 : 1];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    if constexpr (kDK) dk[i] = 0.f;
    if constexpr (kDV) dv[i] = 0.f;
  }
  for (int t = 0; t < nq; ++t) {
    const int s = t % S;
    mbar_wait(r.ready + s, (t / S) & 1);
    dkdv_step<C, BQ, C::kRowsKV, kDV, kDK, false>(
        dk, dv, fresh(r.k), fresh(r.v), fresh(r.ring) + s * C::kStageKV,
        r.stat + s * 2 * BQ, nullptr, 0, 0, 0, p);
    if (tid == 0) mbar_arrive(r.empty + s);
  }
  if constexpr (kDK) write_rows<DN>(p.dk + out, dk, key0, p.Tk, p.D, tid & 3);
  if constexpr (kDV) write_rows<DN>(p.dv + out, dv, key0, p.Tk, p.D, tid & 3);
}

// unbiased, dK/dV pass: dK and dV of kRowsKV keys of one (b, h)
template <int DN>
__global__ void __launch_bounds__(BwdTf32Cfg<DN>::kThreadsKV, 1)
flash_bwd_dkdv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_g,
                                 const BwdTf32Params p) {
  using C = BwdTf32Cfg<DN>;
  constexpr int BQ = C::kBQ, S = C::kStagesKV, R = C::kRowsKV, RB = C::RB,
                BW = C::BW, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;  // [NB][R][BW]
  unsigned char* sV = sK + C::kResKV;
  unsigned char* ring = sV + C::kResKV;  // a stage: Q, g, Q^T, g^T
  float* sStat = reinterpret_cast<float*>(smem + C::kStatKV);  // [S][2][BQ]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBarKV);
  uint64_t* ready_kv = full_kv + 1;
  uint64_t* full = ready_kv + 1;
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  const int nk = (p.Tk + R - 1) / R;
  const int kb = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + BQ - 1) / BQ;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(ready_kv, 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 128);
      mbar_init(empty + s, C::kConsKV);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    const int hk = p.Hkv == 1 ? 0 : h;
    auto load = [&](int t) {  // Q and g of query tile t into stage t % S
      unsigned char* st = ring + (t % S) * C::kStageKV;
      mbar_arrive_expect_tx(full + t % S, 2 * C::kTileQ);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(st + j * BQ * RB, &map_q, full + t % S, j * BW, t * BQ,
                    h, b);
        tma_load_4d(st + C::kTileQ + j * BQ * RB, &map_g, full + t % S,
                    j * BW, t * BQ, h, b);
      }
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(full_kv, 2 * C::kResKV);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sK + j * R * RB, &map_k, full_kv, j * BW, kb * R, hk, b);
        tma_load_4d(sV + j * R * RB, &map_v, full_kv, j * BW, kb * R, hk, b);
      }
      for (int t = 0; t < S && t < nq; ++t) load(t);
    }
    mbar_wait(full_kv, 0);
    round_in_place<C::kResKV>(sK, tid);
    round_in_place<C::kResKV>(sV, tid);
    fence_proxy_async_smem();
    mbar_arrive(ready_kv);
    const float* lse = p.lse + (long long)bh * p.Tq;
    const float* delta = p.delta + (long long)bh * p.Tq;
    for (int t = 0; t < nq; ++t) {
      const int s = t % S;
      mbar_wait(full + s, (t / S) & 1);
      dkdv_stage_pass<C, BQ>(ring + s * C::kStageKV, sStat + s * 2 * BQ, lse,
                             delta, t * BQ, p.Tq, tid);
      fence_proxy_async_smem();
      mbar_arrive(ready + s);
      if (tid == 0 && t >= 1 && t - 1 + S < nq) {
        mbar_wait(empty + (t - 1) % S, ((t - 1) / S) & 1);
        load(t - 1 + S);
      }
    }
    return;
  }

  // a consumer: 64 keys, warp w keys 16w.., lane keys g and g + 8; the
  // query columns of its S^T registers: 8 i + 2 (lane % 4) + (e & 1)
  const int cw = wg - 1;
  const int rows = C::kSplit ? 0 : cw * 64;  // its keys in the block
  const int key0 = kb * R + rows + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const Ring ring_at{smem_u32(sK) + rows * RB, smem_u32(sV) + rows * RB,
                     smem_u32(ring), sStat, ready, empty};
  const long long out = (long long)bh * p.Tk * p.D;
  mbar_wait(ready_kv, 0);
  if constexpr (!C::kSplit)
    dkdv_consumer<C, true, true>(ring_at, nq, out, key0, p);
  else if (cw == 0)
    dkdv_consumer<C, true, false>(ring_at, nq, out, key0, p);
  else
    dkdv_consumer<C, false, true>(ring_at, nq, out, key0, p);
}

// ---------------------------------------------------------------------------
// the prior, dQ pass: dQ, delta and dbias of one head's 64 queries

template <int DN>
__global__ void __launch_bounds__(BiasTf32Cfg<DN>::kThreads, 1)
flash_bwd_dq_bias_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,
                                    const __grid_constant__ CUtensorMap map_v,
                                    const BwdTf32Params p) {
  using C = BiasTf32Cfg<DN>;
  constexpr int BK = C::kBK1, S = C::kStages1, RB = C::RB, BW = C::BW,
                NB = C::NB, KS = C::KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ntk = (p.Tk + BK - 1) / BK;
  float* acc = reinterpret_cast<float*>(smem);  // [tile][16][128]
  unsigned char* ring = smem + ntk * C::kAccTile;  // a stage: K, V, K^T
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStage1);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  const int nqt = (p.Tq + 63) / 64;
  const int qt = blockIdx.x % nqt, h = blockIdx.x / nqt;
  const int nsteps = p.B * ntk;  // (b, key tile) in order
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 128);
      mbar_init(empty + s, 1);  // each tile has one consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    auto load = [&](int j) {  // K and V of step j into stage j % S
      const int b = j / ntk, kt = j % ntk;
      unsigned char* st = ring + (j % S) * C::kStage1;
      mbar_arrive_expect_tx(full + j % S, 2 * C::kTileK);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(st + c * BK * RB, &map_k, full + j % S, c * BW, kt * BK,
                    0, b);
        tma_load_4d(st + C::kTileK + c * BK * RB, &map_v, full + j % S,
                    c * BW, kt * BK, 0, b);
      }
    };
    if (tid == 0)
      for (int j = 0; j < S && j < nsteps; ++j) load(j);
    for (int j = 0; j < nsteps; ++j) {
      const int s = j % S;
      unsigned char* st = ring + s * C::kStage1;
      mbar_wait(full + s, (j / S) & 1);
      round_transpose<BK, DN, BW>(st, st + 2 * C::kTileK, tid);
      round_in_place<C::kTileK>(st + C::kTileK, tid);
      fence_proxy_async_smem();
      mbar_arrive(ready + s);
      if (tid == 0 && j >= 1 && j - 1 + S < nsteps) {
        mbar_wait(empty + (j - 1) % S, ((j - 1) / S) & 1);
        load(j - 1 + S);
      }
    }
    return;
  }

  // a consumer: the key tiles kt % 2 == cw of every batch row; 64 queries,
  // warp w rows 16w.., lane rows g and g + 8
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int row0 = qt * 64 + warp * 16 + (lane >> 2);
  const bool pair = ntk > 1;  // the odd consumer has key tiles
  if (cw == 1 && !pair) return;
  const float* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    brow[r] = row0 + 8 * r < p.Tq
                  ? p.bias + h * p.bias_sh + (long long)(row0 + 8 * r) * p.bias_sq
                  : nullptr;
  float dq[DN / 2];
  uint32_t qf[KS][4], gf[KS][4], da[BK / 8][4];
  for (int b = 0; b < p.B; ++b) {
    const long long bh = (long long)b * p.H + h;
    // the row's Q and g as TF32 A fragments (a0 (g, t), a1 (g + 8, t), a2
    // (g, t + 4), a3 (g + 8, t + 4) of each k8 step; zero past D and Tq),
    // delta from the unrounded g and out at the same places, summed over
    // the quad, and lse * log2(e)
    float sum[2] = {0.f, 0.f}, l2[2];
    const float *qr[2], *gr[2], *orow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < p.Tq;
      qr[r] = ok ? p.q + b * p.q_sb + h * p.q_sh + (long long)row * p.q_st : nullptr;
      gr[r] = ok ? p.g + b * p.g_sb + h * p.g_sh + (long long)row * p.g_st : nullptr;
      orow[r] = ok ? p.out + (bh * p.Tq + row) * p.D : nullptr;
      l2[r] = ok ? p.lse[bh * p.Tq + row] * kLog2e : INFINITY;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j & 1, col = 8 * ks + t4 + 4 * (j >> 1);
        const bool in = qr[r] != nullptr && col < p.D;
        const float qv = in ? qr[r][col] : 0.f;
        const float gv = in ? gr[r][col] : 0.f;
        if (in) sum[r] = fmaf(gv, orow[r][col], sum[r]);
        qf[ks][j] = to_tf32(qv);
        gf[ks][j] = to_tf32(gv);
      }
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      dl[r] = sum[r];
    }
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;

    for (int kt = cw; kt < ntk; kt += 2) {
      const int j = b * ntk + kt, s = j % S;
      const uint32_t kt_addr = fresh(smem_u32(ring)) + s * C::kStage1;
      float sc[BK / 2], dp[BK / 2], bv[BK / 2];
      mbar_wait(ready + s, (j / S) & 1);
      issue_rk<C, BK>(sc, qf, kt_addr);              // S = Q K^T
      issue_rk<C, BK>(dp, gf, kt_addr + C::kTileK);  // dP = g V^T
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)  // the bias, while the products run
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt * BK + 8 * i + 2 * t4 + (e & 1);
          const float* br = brow[e >> 1];
          bv[4 * i + e] = (br != nullptr && key < p.Tk) ? br[key] : 0.f;
        }
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);
      // dS; its sum over the batch into dbias; dS * scale for dQ
      float* at = acc + (kt * 16) * 128 + tid;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, key = kt * BK + 8 * i + 2 * t4 + (e & 1);
          const float x = fmaf(sc[4 * i + e], p.scale, bv[4 * i + e]);
          const float pv = key < p.Tk ? prob(x, kLog2e, l2[r]) : 0.f;
          const float ds = pv * (dp[4 * i + e] - dl[r]);
          float* a = at + (4 * i + e) * 128;
          *a = b == 0 ? ds : *a + ds;
          dp[4 * i + e] = ds * p.scale;
        }
      hand_off<BK>(da, dp);
      issue_rt<DN, BK>(dq, da, kt_addr + 2 * C::kTileK);  // dQ += (dS * scale) K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DN / 2>(dq);
      if (tid == 0) mbar_arrive(empty + s);
    }

    // the batch row's dQ over both consumers' keys: the odd one's f32 sum
    // goes through dq (each thread its own elements), the even one adds
    // it to its own (one fixed order) and writes dQ and delta
    float* og = p.dq + bh * p.Tq * p.D;
    if (cw == 1) {
      if (b > 0) named_bar_sync(2, 256);  // the even one read the last row
      write_rows<DN>(og, dq, row0, p.Tq, p.D, t4);
      __threadfence_block();
      named_bar_arrive(1, 256);
    } else {
      if (pair) {
        named_bar_sync(1, 256);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row >= p.Tq) continue;
#pragma unroll
          for (int i = 0; i < DN / 8; ++i) {
            const int col = 8 * i + 2 * t4;
            if (col < p.D) {
              const float2 o = *reinterpret_cast<const float2*>(
                  og + (long long)row * p.D + col);
              dq[4 * i + 2 * r] += o.x;
              dq[4 * i + 2 * r + 1] += o.y;
            }
          }
        }
        if (b + 1 < p.B) named_bar_arrive(2, 256);
      }
      write_rows<DN>(og, dq, row0, p.Tq, p.D, t4);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < p.Tq && t4 == 0)
          p.delta[bh * p.Tq + row0 + 8 * r] = dl[r];
    }
  }

  // dbias of this consumer's key tiles, once
  float* db = p.dbias + (long long)h * p.Tq * p.Tk;
  for (int kt = cw; kt < ntk; kt += 2) {
    const float* at = acc + (kt * 16) * 128 + tid;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      float* drow = db + (long long)row * p.Tk;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt * BK + 8 * i + 2 * t4 + e;
          if (key < p.Tk) drow[key] = at[(4 * i + 2 * r + e) * 128];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// the prior, dK/dV pass: dK and dV of one batch row's 64 keys over one head
// group, summed over the cluster's head groups

template <int DN>
__global__ void __cluster_dims__(BiasTf32Cfg<DN>::kGroups, 1, 1)
__launch_bounds__(BiasTf32Cfg<DN>::kThreads, 1)
flash_bwd_dkdv_bias_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                      const __grid_constant__ CUtensorMap map_k,
                                      const __grid_constant__ CUtensorMap map_v,
                                      const __grid_constant__ CUtensorMap map_g,
                                      const BwdTf32Params p) {
  using C = BiasTf32Cfg<DN>;
  constexpr int BQ = C::kBQ2, S = C::kStages2, RB = C::RB, BW = C::BW,
                NB = C::NB, G = C::kGroups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;  // [NB][64][BW]
  unsigned char* sV = sK + C::kRes2;
  unsigned char* ring = sV + C::kRes2;  // a stage: Q, g, Q^T, g^T
  float* sStat = reinterpret_cast<float*>(smem + C::kStat2);  // [S][2][BQ]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBar2);
  uint64_t* ready_kv = full_kv + 1;
  uint64_t* full = ready_kv + 1;
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  cg::cluster_group cluster = cg::this_cluster();
  const int grp = (int)cluster.block_rank();
  const int unit = blockIdx.x / G;
  const int nkt = (p.Tk + 63) / 64;
  const int kt = unit % nkt, b = unit / nkt;
  const int hg = (p.H + G - 1) / G;
  const int h0 = grp * hg, h1 = min(p.H, h0 + hg);
  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int nsteps = h1 > h0 ? (h1 - h0) * nqt : 0;  // (head, query tile)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31,
            t4 = lane & 3;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(ready_kv, 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 128);
      mbar_init(empty + s, 1);  // each step has one consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
  const int krow = warp * 16 + (lane >> 2);  // this lane's keys: + 0, + 8
  if (wg == 0) {  // the producer (on to the cluster's sums after its steps)
    auto load = [&](int j) {
      const int h = h0 + j / nqt, qt = j % nqt;
      unsigned char* st = ring + (j % S) * C::kStage2;
      mbar_arrive_expect_tx(full + j % S, 2 * C::kTileQ);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(st + c * BQ * RB, &map_q, full + j % S, c * BW, qt * BQ,
                    h, b);
        tma_load_4d(st + C::kTileQ + c * BQ * RB, &map_g, full + j % S,
                    c * BW, qt * BQ, h, b);
      }
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(full_kv, 2 * C::kRes2);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sK + c * 64 * RB, &map_k, full_kv, c * BW, kt * 64, 0, b);
        tma_load_4d(sV + c * 64 * RB, &map_v, full_kv, c * BW, kt * 64, 0, b);
      }
      for (int j = 0; j < S && j < nsteps; ++j) load(j);
    }
    mbar_wait(full_kv, 0);
    round_in_place<C::kRes2>(sK, tid);
    round_in_place<C::kRes2>(sV, tid);
    fence_proxy_async_smem();
    mbar_arrive(ready_kv);
    for (int j = 0; j < nsteps; ++j) {
      const int s = j % S, h = h0 + j / nqt, qt = j % nqt;
      const long long bh = (long long)b * p.H + h;
      mbar_wait(full + s, (j / S) & 1);
      dkdv_stage_pass<C, BQ>(ring + s * C::kStage2, sStat + s * 2 * BQ,
                             p.lse + bh * p.Tq, p.delta + bh * p.Tq, qt * BQ,
                             p.Tq, tid);
      fence_proxy_async_smem();
      mbar_arrive(ready + s);
      if (tid == 0 && j >= 1 && j - 1 + S < nsteps) {
        mbar_wait(empty + (j - 1) % S, ((j - 1) / S) & 1);
        load(j - 1 + S);
      }
    }
  } else {  // consumer wg - 1: the steps j % 2 == wg - 1
    const int key = kt * 64 + krow;
    const int krow_ok = (key < p.Tk ? 1 : 0) | (key + 8 < p.Tk ? 2 : 0);
    mbar_wait(ready_kv, 0);
    for (int j = wg - 1; j < nsteps; j += 2) {
      const int s = j % S, h = h0 + j / nqt, qt = j % nqt;
      const uint32_t st = fresh(smem_u32(ring)) + s * C::kStage2;
      mbar_wait(ready + s, (j / S) & 1);
      dkdv_step<C, BQ, 64, true, true, true>(
          dk, dv, fresh(smem_u32(sK)), fresh(smem_u32(sV)), st,
          sStat + s * 2 * BQ,
          p.bias + h * p.bias_sh + (long long)qt * BQ * p.bias_sq +
              min(key, p.Tk - 1),
          p.bias_sq, p.Tq - qt * BQ, krow_ok, p);
      if (tid == 0) mbar_arrive(empty + s);
    }
  }

  // the block's two consumers: the second parks its sums in the ring, the
  // first adds them to its own (one fixed order) and parks the block's sum;
  // then each block sums its share of the pairs over the cluster's blocks
  // in rank order (distributed shared memory) and writes them once
  __syncthreads();  // every step done: the ring is free
  float* park = reinterpret_cast<float*>(ring);  // [dK, dV][DN / 2][128]
  if (wg == 2) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      park[i * 128 + tid] = dk[i];
      park[(DN / 2 + i) * 128 + tid] = dv[i];
    }
  }
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      park[i * 128 + tid] = dk[i] + park[i * 128 + tid];
      park[(DN / 2 + i) * 128 + tid] = dv[i] + park[(DN / 2 + i) * 128 + tid];
    }
  }
  cluster.sync();
  if (wg == 1) {
    const float* peer[G];
#pragma unroll
    for (int r = 0; r < G; ++r) peer[r] = cluster.map_shared_rank(park, r);
    for (int pj = grp; pj < DN / 4; pj += G) {  // registers 2 pj, 2 pj + 1
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
          *reinterpret_cast<float2*>((w ? p.dv : p.dk) +
                                     ((long long)b * p.Tk + key) * p.D + col) =
              make_float2(x, y);
      }
    }
  }
  cluster.sync();  // the peers' shared memory stays until all have read it
}

// ---------------------------------------------------------------------------
// host side

// f(Cfg<DN>{}) for the instance serving head dim D (DN = D rounded up to
// 8), up to `most`; -1 where none does (D below 8, past `most` or off a
// multiple of 4)
#define TF32_BWD_CASE(Cfg, dn) \
  case dn: return f(Cfg<dn>{});
template <class F>
int with_config(int D, F&& f) {
  if (D < 8 || D > 128 || D % 4) return -1;
  switch ((D + 7) / 8 * 8) {
    TF32_BWD_CASE(BwdTf32Cfg, 8) TF32_BWD_CASE(BwdTf32Cfg, 16)
    TF32_BWD_CASE(BwdTf32Cfg, 24) TF32_BWD_CASE(BwdTf32Cfg, 32)
    TF32_BWD_CASE(BwdTf32Cfg, 40) TF32_BWD_CASE(BwdTf32Cfg, 48)
    TF32_BWD_CASE(BwdTf32Cfg, 56) TF32_BWD_CASE(BwdTf32Cfg, 64)
    TF32_BWD_CASE(BwdTf32Cfg, 72) TF32_BWD_CASE(BwdTf32Cfg, 80)
    TF32_BWD_CASE(BwdTf32Cfg, 88) TF32_BWD_CASE(BwdTf32Cfg, 96)
    TF32_BWD_CASE(BwdTf32Cfg, 104) TF32_BWD_CASE(BwdTf32Cfg, 112)
    TF32_BWD_CASE(BwdTf32Cfg, 120) TF32_BWD_CASE(BwdTf32Cfg, 128)
    default: return -1;
  }
}

template <class F>
int with_bias_config(int D, F&& f) {
  if (D < 8 || D > 64 || D % 4) return -1;
  switch ((D + 7) / 8 * 8) {
    TF32_BWD_CASE(BiasTf32Cfg, 8) TF32_BWD_CASE(BiasTf32Cfg, 16)
    TF32_BWD_CASE(BiasTf32Cfg, 24) TF32_BWD_CASE(BiasTf32Cfg, 32)
    TF32_BWD_CASE(BiasTf32Cfg, 40) TF32_BWD_CASE(BiasTf32Cfg, 48)
    TF32_BWD_CASE(BiasTf32Cfg, 56) TF32_BWD_CASE(BiasTf32Cfg, 64)
    default: return -1;
  }
}
#undef TF32_BWD_CASE

struct Operands {
  const void *q, *k, *v, *g;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, g_sb, g_sh,
      g_st;
  int B;
};

// the maps of q, k, v and g for one pass: boxes of q_rows rows of q and g,
// of kv_rows rows of k and v (a block's resident rows, or a ring tile's)
template <class C>
int encode_maps(CUtensorMap* m, const Operands& o, const BwdTf32Params& p,
                int q_rows, int kv_rows) {
  const int D = p.D, H = p.H, B = o.B;
  int e = encode_tokens_f32(m + 0, o.q, D, p.Tq, H, B, o.q_st, o.q_sh, o.q_sb,
                            C::BW, q_rows);
  if (!e)
    e = encode_tokens_f32(m + 1, o.k, D, p.Tk, p.Hkv, B, o.k_st, o.k_sh,
                          o.k_sb, C::BW, kv_rows);
  if (!e)
    e = encode_tokens_f32(m + 2, o.v, D, p.Tk, p.Hkv, B, o.v_st, o.v_sh,
                          o.v_sb, C::BW, kv_rows);
  if (!e)
    e = encode_tokens_f32(m + 3, o.g, D, p.Tq, H, B, o.g_st, o.g_sh, o.g_sb,
                          C::BW, q_rows);
  return e;
}

// the shared-memory opt-in once a device (a bit a device), not a call
template <class K>
cudaError_t opt_in(K kernel, int bytes, unsigned long long& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((opted >> dev) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted |= 1ull << dev;
  }
  return cudaSuccess;
}

template <class C>
int launch_unbiased(const Operands& o, const BwdTf32Params& p,
                    cudaStream_t stream) {
  CUtensorMap mq[4], mkv[4];
  int e = encode_maps<C>(mq, o, p, C::kRowsQ, C::kBK);
  if (!e) e = encode_maps<C>(mkv, o, p, C::kBQ, C::kRowsKV);
  if (e) return e;
  auto dq = flash_bwd_dq_tf32_wgmma_kernel<C::DN>;
  auto dkdv = flash_bwd_dkdv_tf32_wgmma_kernel<C::DN>;
  static unsigned long long opted_q = 0, opted_kv = 0;
  cudaError_t err = opt_in(dq, C::kSmemQ, opted_q);
  if (err == cudaSuccess) err = opt_in(dkdv, C::kSmemKV, opted_kv);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)o.B * p.H;
  const long long nq = (p.Tq + C::kRowsQ - 1) / C::kRowsQ;
  const long long nk = (p.Tk + C::kRowsKV - 1) / C::kRowsKV;
  // the dQ pass first: it writes delta, which the dK/dV pass reads
  dq<<<(unsigned)(bh * nq), C::kThreadsQ, C::kSmemQ, stream>>>(
      mq[0], mq[1], mq[2], mq[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)(bh * nk), C::kThreadsKV, C::kSmemKV, stream>>>(
      mkv[0], mkv[1], mkv[2], mkv[3], p);
  return (int)cudaGetLastError();
}

template <class C>
int launch_bias(const Operands& o, const BwdTf32Params& p,
                cudaStream_t stream) {
  CUtensorMap m1[4], m2[4];
  int e = encode_maps<C>(m1, o, p, 64, C::kBK1);
  if (!e) e = encode_maps<C>(m2, o, p, C::kBQ2, 64);
  if (e) return e;
  auto dq = flash_bwd_dq_bias_tf32_wgmma_kernel<C::DN>;
  auto dkdv = flash_bwd_dkdv_bias_tf32_wgmma_kernel<C::DN>;
  static unsigned long long opted_q = 0, opted_kv = 0;
  cudaError_t err = opt_in(dq, C::smem1(C::kMaxKeyTiles), opted_q);
  if (err == cudaSuccess) err = opt_in(dkdv, C::kSmem2, opted_kv);
  if (err != cudaSuccess) return (int)err;
  const int ntk = (p.Tk + C::kBK1 - 1) / C::kBK1;
  const long long nqt = (p.Tq + 63) / 64, nkt = (p.Tk + 63) / 64;
  // the dQ pass first: it writes delta, which the dK/dV pass reads
  dq<<<(unsigned)(p.H * nqt), C::kThreads, C::smem1(ntk), stream>>>(
      m1[1], m1[2], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)(o.B * nkt * C::kGroups), C::kThreads, C::kSmem2,
         stream>>>(m2[0], m2[1], m2[2], m2[3], p);
  return (int)cudaGetLastError();
}

BwdTf32Params params(const void* q, const void* g, const void* out,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int H, int Hkv, int Tq, int Tk, int D,
                     float scale) {
  BwdTf32Params p{};
  p.q = static_cast<const float*>(q);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<const float*>(out);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B; p.H = H; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

extern "C" {

// Unbiased: q, g [B, H, Tq, D] and k, v [B, Hkv, Tk, D] f32 (Hkv 1 or H)
// with element strides over batch, head and token (each a multiple of 4
// elements where its extent passes 1, the pointers 16-byte aligned, unit
// stride over D; g also contiguous); out, the forward's output, a
// contiguous [B, H, Tq, D] f32; lse [B*H, Tq] f32; delta a [B*H, Tq] f32
// scratch the kernels write and read; dq a contiguous [B*H, Tq, D], dk and
// dv contiguous [B*H, Tk, D] (one per (b, h): the caller sums multi-query
// ones over heads), all f32. 8 <= D <= 128, D % 4 == 0, scale > 0; no input
// aliases an output. Launches the dQ pass, then the dK/dV pass, on
// `stream`. Returns a cudaError_t (0 on success), or 10000 + the CUresult
// of a failed tensor-map encode.
int flash_attn_bwd_tf32_sm90(const void* q, const void* k, const void* v,
                             const void* g, const void* out, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long g_sb, long long g_sh, long long g_st,
                             int B, int H, int Hkv, int Tq, int Tk, int D,
                             float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      (Hkv != 1 && Hkv != H))
    return (int)cudaErrorInvalidValue;
  const Operands o{q, k, v, g, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                   v_sb, v_sh, v_st, g_sb, g_sh, g_st, B};
  const BwdTf32Params p =
      params(q, g, out, lse, delta, dq, dk, dv, B, H, Hkv, Tq, Tk, D, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, [&](auto cfg) {
    return launch_unbiased<decltype(cfg)>(o, p, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The prior's layout: q, g [B, H, Tq, D] and k, v [B, 1, Tk, D] f32 with
// element strides over batch, head and token (as above); out a contiguous
// [B, H, Tq, D] f32; lse [B*H, Tq] f32; delta a [B*H, Tq] f32 scratch; bias
// [H, Tq, Tk] f32 (strides bias_sh, bias_sq, unit stride over keys); dq a
// contiguous [B, H, Tq, D], dk and dv contiguous [B, 1, Tk, D] (summed over
// the heads), dbias a contiguous [H, Tq, Tk] (summed over the batch), all
// f32. 8 <= D <= 64 with D % 4 == 0, Tk <= 576, scale > 0; no input aliases
// an output. Launches the dQ pass, then the dK/dV pass, on `stream`.
// Returns a cudaError_t (0 on success), or 10000 + the CUresult of a failed
// tensor-map encode.
int flash_attn_bwd_bias_tf32_sm90(const void* q, const void* k, const void* v,
                                  const void* g, const void* out,
                                  const void* bias, const float* lse,
                                  float* delta, void* dq, void* dk, void* dv,
                                  void* dbias, long long q_sb, long long q_sh,
                                  long long q_st, long long k_sb,
                                  long long k_st, long long v_sb,
                                  long long v_st, long long g_sb,
                                  long long g_sh, long long g_st,
                                  long long bias_sh, long long bias_sq, int B,
                                  int H, int Tq, int Tk, int D, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      Tk > 32 * BiasTf32Cfg<8>::kMaxKeyTiles)
    return (int)cudaErrorInvalidValue;
  const Operands o{q, k, v, g, q_sb, q_sh, q_st, k_sb, 0, k_st,
                   v_sb, 0, v_st, g_sb, g_sh, g_st, B};
  BwdTf32Params p =
      params(q, g, out, lse, delta, dq, dk, dv, B, H, 1, Tq, Tk, D, scale);
  p.bias = static_cast<const float*>(bias);
  p.dbias = static_cast<float*>(dbias);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_st = g_st;
  p.bias_sh = bias_sh; p.bias_sq = bias_sq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_bias_config(D, [&](auto cfg) {
    return launch_bias<decltype(cfg)>(o, p, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The unbiased instance's plan at head dim D: the dQ pass's queries a
// block, keys a ring tile, stages and shared memory; the dK/dV pass's keys
// a block, queries a ring tile, stages and shared memory; the column
// block's width (floats) and the blocks; 0 where none serves D.
int flash_attn_bwd_tf32_sm90_plan(int D, int* rows_q, int* bk, int* stages_q,
                                  int* smem_q, int* rows_kv, int* bq,
                                  int* stages_kv, int* smem_kv, int* bw,
                                  int* nb) {
  return with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *rows_q = C::kRowsQ;
    *bk = C::kBK;
    *stages_q = C::kStagesQ;
    *smem_q = C::kSmemQ;
    *rows_kv = C::kRowsKV;
    *bq = C::kBQ;
    *stages_kv = C::kStagesKV;
    *smem_kv = C::kSmemKV;
    *bw = C::BW;
    *nb = C::NB;
    return 1;
  }) == 1;
}

// The prior's instance's plan at head dim D and Tk keys: its DN; the dQ
// pass's keys a ring tile, stages and shared memory (the dbias accumulator
// sized by Tk); the dK/dV pass's head groups (the cluster), queries a ring
// tile, stages and shared memory; 0 where none serves (D, Tk).
int flash_attn_bwd_bias_tf32_sm90_plan(int D, int Tk, int* dn, int* bk,
                                       int* stages1, int* smem1, int* groups,
                                       int* bq, int* stages2, int* smem2) {
  if (Tk <= 0 || Tk > 32 * BiasTf32Cfg<8>::kMaxKeyTiles) return 0;
  return with_bias_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *dn = C::DN;
    *bk = C::kBK1;
    *stages1 = C::kStages1;
    *smem1 = C::smem1((Tk + C::kBK1 - 1) / C::kBK1);
    *groups = C::kGroups;
    *bq = C::kBQ2;
    *stages2 = C::kStages2;
    *smem2 = C::kSmem2;
    return 1;
  }) == 1;
}

const char* flash_attn_bwd_tf32_sm90_error_string(int err) {
  if (err >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
