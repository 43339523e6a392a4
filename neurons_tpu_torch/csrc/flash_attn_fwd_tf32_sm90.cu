// Flash-attention forward on f32 input at head dims up to 128 on Hopper's
// own instructions (sm_90a): TF32 warpgroup products (wgmma m64nNk8) fed by
// TMA tile loads into an mbarrier ring. Bound through a plain C interface
// and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for f32 at 8 <= D <= 128 (D % 4 == 0) on rows, strides and
// pointers that are 16-byte multiples, with or without a bias and the lse,
// over one or H kv heads, the JAX package's
//   neurons_tpu/ops/attention.py:137  _flash_kernel_smallkv       (whole K/V resident)
//   neurons_tpu/ops/attention.py:226  _flash_kernel               (K/V streamed by block)
//   neurons_tpu/ops/attention.py:185  _flash_kernel_smallkv_bias  (#137 plus a bias)
// with the numerics of the f32 route (`attention_reference_tf32`): every
// operand of both products (Q, K, the probabilities P and V) rounded to
// TF32 by cvt.rna (to nearest, ties away from zero; the tensor core would
// only drop the low 13 mantissa bits), f32 sums, an optional additive bias
// [N, Tq, Tk] added after the scale, the lse m + log(max(l, 1e-30)) [B*H,
// Tq] with the accurate expf when asked for (ex2.approx of one FFMA
// otherwise). Every f32 launch of the paths at d <= 128 comes here
// (validate's UNet2D/UNet3D/SparseCtrl, stage 6's classifiers, stage e and
// the seg panels' DecoderVideo, precompute's bigG at d 104, the f32
// stage-2 step with the prior's biased multi-query launches, the tiny CLI
// chain at d 8); flash_fwd_tf32_kernel (flash_attn_fwd.cu) keeps rows,
// strides or pointers off 16 bytes, which TMA cannot address, and d 4.
//
// What bounds it on an H100: 4 Tq Tk D operations at the TF32 rate (495
// TFLOP/s), Tq Tk exponentials (the MUFU unit, about 3.9 T/s; 80-99% of
// the bound at d 32-40) and, at validate's 256-token launches, the bytes
// (a launch of [2, 20, 256, 256, 64] moves 10.5 MB, 3.1 us). The register
// kernel it replaces reached none of them: mma.sync m16n8k8 per warp of 16
// rows with S -> softmax -> P V in series in each warp, the head dim padded
// to 32, 64 or 128 (d 40 and 52 ran as 64, d 80 and 104 as 128), every K/V
// tile rounded in shared memory by all threads under a block barrier, V's
// B fragments read as scalars.
//
// Design. A block owns one (b, h) and 64 kCons query rows: warpgroup 0 is
// the producer, kCons consumer warpgroups own 64 rows each. TF32 wgmma
// takes K-major operands only (no transpose bit), so:
//   * one thread of the producer issues TMA boxes (maps of the real (D, T,
//     H, B) strides; a multi-query k/v is a head extent of 1) of Q once and
//     of raw f32 K and V key tiles into a ring of kStages stages, each box
//     one column block of BW floats swizzled by its row width (4 BW bytes);
//   * the producer warpgroup then rounds K in place and transposes V in
//     place into V^T (keys contiguous, rows of 32 keys swizzled by 128
//     bytes), rounded, each 8-key group in the order 0 2 4 6 1 3 5 7: P's
//     A fragment wants columns t and t + 4 where S's accumulator holds keys
//     2t and 2t + 1, so the product sums over keys in that permuted order
//     and P goes from S's registers into the A operand without a shuffle
//     (a = c0, c2, c1, c3, as mma_sm80.cuh's TF32 kernels); each thread
//     holds its 4 x 4 pieces in registers across a named barrier, and the 8
//     lanes of each 16-byte phase take 8 distinct bank groups on both the
//     reads and the writes;
//   * each consumer rounds its Q rows in place once, then per key tile:
//       S = Q K^T   wgmma m64nBKk8 ss, the real k8 steps of the head dim
//                   only (d 52: 7, not 8);
//       the online softmax in registers (bias read from global memory while
//       S runs; keys past Tk at -inf);
//       O += P V    wgmma m64nDNk8 rs, DN = d rounded up to 8, B = V^T.
// The consumers only issue products and take exponentials; with two
// consumer warpgroups (or two blocks an SM) one's softmax overlaps the
// other's products. Two regimes, chosen on the host from the shape
// (`ops/attention.py:tf32_wgmma_consumers`): 1 consumer (BQ 64) while its
// blocks fit two waves at d <= 64, where a 2-stage ring lets two blocks
// share an SM (validate's [2, 20, 256^2, 64]: 160 blocks in one wave), or
// one wave past it; else 3 consumers a block at d <= 64 (BQ 192, 512
// threads, 128 registers each; validate's [32, 8, 1024^2, 40]: 1536
// blocks) and 2 past it (BQ 128: O's registers), a 3-stage ring. Three
// took 11-21% off two at every such shape (tools/torch_flash_fwd_variants.py
// --preset cons2 forces two, PERF.md). Key tiles of 64 keys at d <= 64, 32 past it
// (S's registers beside O's). Shared memory: Q 64 kCons x DKS x 4 bytes
// (DKS = the column blocks' width: d 40 and 52 hold 64, d 104 128) and per
// stage K and V tiles of BK x DKS x 4 bytes, V^T written over V: 80 KB a
// block at d 64 with one consumer, 144 KB with three, 160 KB at d 128 with
// two. Sums run in one fixed order with no atomics: a rerun gives equal
// bits.

#include "mma_sm80.cuh"  // to_tf32
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// DN: the head dim rounded up to 8 (the N of P V; DN / 8 k8 steps of S);
// kCons: consumer warpgroups of 64 query rows (1; or 3 at DN <= 64, 2
// past it)
template <int DN_, int kCons_>
struct Tf32Cfg {
  static constexpr int DN = DN_, kCons = kCons_;
  static constexpr int KS = DN / 8;
  // a column block: BW floats, one swizzled row of RB bytes, at most d
  // (a TMA box may not be wider than its map)
  static constexpr int BW = DN <= 16 ? 8 : DN <= 32 ? 16 : 32;
  static constexpr int NB = (DN + BW - 1) / BW, DKS = BW * NB;
  static constexpr int RB = 4 * BW;
  static constexpr int kMode = swizzle_mode(RB);
  static constexpr int kVtMode = swizzle_mode(128);  // V^T's 32-key rows
  static constexpr int kBK = DN <= 64 ? 64 : 32;
  static constexpr int PK = kBK / 8;  // k8 steps of P V
  static constexpr int kBQ = 64 * kCons;
  // one consumer at d <= 64: a block small enough for two an SM
  static constexpr bool kPair = kCons == 1 && DN <= 64;
  static constexpr int kStages = kPair ? 2 : 3;
  static constexpr int kMinBlocks = kPair ? 2 : 1;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kQBytes = kBQ * DKS * 4;
  static constexpr int kTileBytes = kBK * DKS * 4;  // a K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // tiles, barriers (full q; full, ready and empty a stage), and the slack
  // that aligns the tiles to 1024 bytes
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
  // the V transpose's pieces: (8-key group, half, 4-column chunk)
  static constexpr int kVJobs = (kBK / 8) * 2 * (DN / 4);
  static constexpr int kVJobsPerThread = (kVJobs + 127) / 128;
  static_assert(DN % 8 == 0 && DN >= 8 && DN <= 128, "DN");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "alignment");
  static_assert(DN * kBK * 4 <= kTileBytes, "V^T fits V's tile");
};

struct Tf32Params {
  float* o;              // [B, H, Tq, D], contiguous
  const float* bias;     // [N, Tq, Tk] (unit key stride) or null
  float* lse;            // [B*H, Tq] or null
  long long bias_sn, bias_sq;
  int bias_mode;         // 1: one slice, 2: one a head, 3: one a (b, h)
  int H, Hkv, Tq, Tk, D;
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

__device__ __forceinline__ uint4 round4(uint4 v) {
  return make_uint4(to_tf32(__uint_as_float(v.x)), to_tf32(__uint_as_float(v.y)),
                    to_tf32(__uint_as_float(v.z)), to_tf32(__uint_as_float(v.w)));
}

// `bytes` of f32 at `base` rounded to TF32 in place by the 128 threads of a
// warpgroup, 16 bytes a thread a step
template <int kBytes>
__device__ __forceinline__ void round_in_place(unsigned char* base, int tid) {
#pragma unroll 4
  for (int i = tid; i < kBytes / 16; i += 128) {
    uint4* p = reinterpret_cast<uint4*>(base + 16 * i);
    *p = round4(*p);
  }
}

__device__ __forceinline__ float comp(const float4& x, int w) {
  return w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
}

// V's raw tile (column blocks of BW floats, TMA's swizzle) into V^T in
// place, rounded: V^T row n (head column n) holds the tile's keys in 32-key
// blocks of 128 swizzled bytes, block kb at kb * DN * 128, each 8-key group
// in the order 0 2 4 6 1 3 5 7. A piece j: lane position l = j % 8 (keys
// 8 (l >> 1) + 2u + (l & 1) of a 32-key block, u = 0..3: positions
// 8 (l >> 1) + 4 (l & 1) + u of V^T's rows), block kb and 4-column chunk c
// from j / 8; the 8 lanes of a phase share (kb, m) and take chunk
// m ^ (l & 6) where m's group of 8 chunks is whole, so their 16-byte reads
// (chunk c ^ (key % 8) of a 128-byte row) and writes (chunk l ^ (n % 8))
// each hit 8 distinct bank groups. Every piece is read before the named
// barrier and written after it.
template <class C>
__device__ __forceinline__ void transpose_v(unsigned char* v, int tid) {
  constexpr int NJ = C::kVJobs, NPT = C::kVJobsPerThread;
  constexpr int NKB = C::kBK / 32, FULL = (C::DN / 4) & ~7;
  float4 x[NPT][4];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = tid + 128 * i;
    if (NJ % 128 == 0 || j < NJ) {
      const int l = j & 7, rest = j >> 3, kb = rest % NKB, m = rest / NKB;
      const int c = m < FULL ? (m ^ (l & 6)) : m;
      const int col = 4 * c, blk = col / C::BW, cc = col % C::BW;
      const unsigned char* src = v + blk * C::kBK * C::RB;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = 32 * kb + 8 * (l >> 1) + 2 * u + (l & 1);
        x[i][u] = *reinterpret_cast<const float4*>(
            src + swz<C::RB>(key * C::RB + cc * 4));
      }
    }
  }
  named_bar_sync(1, 128);  // every read of the raw tile is done
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = tid + 128 * i;
    if (NJ % 128 == 0 || j < NJ) {
      const int l = j & 7, rest = j >> 3, kb = rest % NKB, m = rest / NKB;
      const int c = m < FULL ? (m ^ (l & 6)) : m;
      unsigned char* dst = v + kb * C::DN * 128;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = 4 * c + w;
        *reinterpret_cast<float4*>(dst + swz<128>(n * 128 + l * 16)) =
            make_float4(rna(comp(x[i][0], w)), rna(comp(x[i][1], w)),
                        rna(comp(x[i][2], w)), rna(comp(x[i][3], w)));
      }
    }
  }
}

// S = Q K^T over one key tile, issued and committed: k8 step ks reads 8
// columns of Q and K (K-major: SBO = 8 rows) inside column block ks * 8 /
// BW; the first step overwrites S
template <class C>
__device__ __forceinline__ void s_product(float* sc, uint32_t q_addr,
                                          uint32_t k_tile) {
  uint64_t dq[C::KS], dk[C::KS];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const int blk = ks * 8 / C::BW, off = (ks * 8 % C::BW) * 4;
    dq[ks] = gmma_desc(q_addr + blk * C::kBQ * C::RB + off, 16, 8 * C::RB,
                       C::kMode);
    dk[ks] = gmma_desc(k_tile + blk * C::kBK * C::RB + off, 16, 8 * C::RB,
                       C::kMode);
  }
  pin<C::KS>(dq);
  pin<C::KS>(dk);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  wgmma_fence();
  WgmmaTf32<C::kBK>::ss0(sc, dq[0], dk[0], zero);
#pragma unroll
  for (int ks = 1; ks < C::KS; ++ks)
    WgmmaTf32<C::kBK>::ss(sc, dq[ks], dk[ks], one);
  wgmma_commit();
}

// O += P V over one key tile, issued and committed: k8 step kk reads 8
// (permuted) keys of V^T's rows, 32-key block kk / 4
template <class C>
__device__ __forceinline__ void pv_product(float* o, uint32_t (*pa)[4],
                                           uint32_t vt) {
  uint64_t dv[C::PK];
#pragma unroll
  for (int kk = 0; kk < C::PK; ++kk)
    dv[kk] = gmma_desc(vt + (kk / 4) * C::DN * 128 + (kk % 4) * 32, 16, 1024,
                       C::kVtMode);
  pin<C::PK>(dv);
  int one = 1;
  asm volatile("" : "+r"(one));
  fence_regs<C::DN / 2>(o);
  fence_regs<4 * C::PK>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::PK; ++kk)
    WgmmaTf32<C::DN>::rs(o, pa[kk], dv[kk], one);
  wgmma_commit();
}

template <int DN, int kCons>
__global__ void __launch_bounds__(Tf32Cfg<DN, kCons>::kThreads,
                                  Tf32Cfg<DN, kCons>::kMinBlocks)
flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const Tf32Params p) {
  using C = Tf32Cfg<DN, kCons>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages, RB = C::RB,
                BW = C::BW, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                 // [NB][BQ][BW]
  unsigned char* ring = smem + C::kQBytes;  // a stage: K [NB][BK][BW], V
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full = full_q + 1;  // a stage's K and V landed
  uint64_t* ready = full + S;   // K rounded, V^T written
  uint64_t* empty = ready + S;  // the consumers are done with the stage

  const int nq = (p.Tq + BQ - 1) / BQ;
  const int qb = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int ntiles = (p.Tk + BK - 1) / BK;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 128);
      mbar_init(empty + s, kCons);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: the copies, then each tile's rounding
    const int hk = p.Hkv == 1 ? 0 : h;
    const void* mk = &map_k;
    const void* mv = &map_v;
    auto load = [&](int t) {  // K and V of key tile t into stage t % S
      const int s = t % S;
      unsigned char* kt = ring + s * C::kStageBytes;
      mbar_arrive_expect_tx(full + s, C::kStageBytes);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(kt + j * BK * RB, mk, full + s, j * BW, t * BK, hk, b);
        tma_load_4d(kt + C::kTileBytes + j * BK * RB, mv, full + s, j * BW,
                    t * BK, hk, b);
      }
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(full_q, C::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sQ + j * BQ * RB, &map_q, full_q, j * BW, qb * BQ, h, b);
      for (int t = 0; t < S && t < ntiles; ++t) load(t);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      unsigned char* kt = ring + s * C::kStageBytes;
      mbar_wait(full + s, (t / S) & 1);
      round_in_place<C::kTileBytes>(kt, tid);
      transpose_v<C>(kt + C::kTileBytes, tid);
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

  // a consumer: 64 query rows, warp w rows 16w.., lane rows g and g + 8;
  // the key columns of its S registers: 8 i + 2 (lane % 4) + (e & 1)
  const int cw = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int row0 = qb * BQ + cw * 64 + warp * 16 + (lane >> 2);
  mbar_wait(full_q, 0);
#pragma unroll
  for (int j = 0; j < NB; ++j)  // this warpgroup's Q rows, rounded once
    round_in_place<64 * RB>(sQ + j * BQ * RB + cw * 64 * RB, tid);
  fence_proxy_async_smem();
  named_bar_sync(2 + cw, 128);

  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * RB;
  const uint32_t ring_addr = smem_u32(ring);
  const bool lse = p.lse != nullptr, biased = p.bias != nullptr;
  // the inference launch folds the scale into exp2 (raw logits); a biased
  // or lse launch scales (and biases) its logits first, as the plain
  // version rounds them
  const bool scaled = lse || biased;
  const float c2 = scaled ? kLog2e : p.scale_log2;
  const float* brow[2] = {nullptr, nullptr};
  if (biased) {
    const int slice = p.bias_mode == 1 ? 0 : p.bias_mode == 2 ? bh % p.H : bh;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < p.Tq)
        brow[r] = p.bias + slice * p.bias_sn + (long long)(row0 + 8 * r) * p.bias_sq;
  }

  float o[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[C::PK][4];  // P of the tile, A fragments of P V

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    const uint32_t kt = ring_addr + s * C::kStageBytes;
    float sc[BK / 2];
    mbar_wait(ready + s, (t / S) & 1);
    s_product<C>(sc, q_addr, kt);
    float bv[BK / 2];  // the bias at S's registers, read while S runs
    if (biased) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float* br = brow[(i >> 1) & 1];
        const int key = t * BK + 8 * (i >> 2) + 2 * t4 + (i & 1);
        bv[i] = (br != nullptr && key < p.Tk) ? br[key] : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);

    // the logits (keys past Tk at -inf) and the online softmax, rows row0
    // and row0 + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = t * BK + 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = sc[i];
      if (scaled) {
        x *= p.scale;
        if (biased) x += bv[i];
      }
      x = key < p.Tk ? x : -INFINITY;
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], ms[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no finite logit
      mc[r] = ms[r] * c2;
      alpha[r] = lse ? expf(m[r] - ms[r]) : ex2_approx(fmaf(m[r], c2, -mc[r]));
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float e = lse ? expf(sc[i] - ms[r])
                          : ex2_approx(fmaf(sc[i], c2, -mc[r]));
      sc[i] = e;
      rs[r] += e;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P, rounded: k8 step kk's A fragment from S's chunk kk (a = c0, c2,
    // c1, c3: A's column t is key 2t, t + 4 is key 2t + 1, as V^T holds
    // them)
#pragma unroll
    for (int kk = 0; kk < C::PK; ++kk) {
      pa[kk][0] = to_tf32(sc[4 * kk + 0]);
      pa[kk][1] = to_tf32(sc[4 * kk + 2]);
      pa[kk][2] = to_tf32(sc[4 * kk + 1]);
      pa[kk][3] = to_tf32(sc[4 * kk + 3]);
    }
    pv_product<C>(o, pa, kt + C::kTileBytes);
    wgmma_wait<0>();
    fence_regs<DN / 2>(o);
    if (tid == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* og = p.o + (long long)bh * p.Tq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Tq) continue;
    float* orow = og + (long long)row * p.D;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      if (col < p.D)  // D % 4 == 0: col + 1 < D too
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
    if (lse && t4 == 0)
      p.lse[(long long)bh * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// host side

// the consumers of the large-grid instance at DN: 3, or 2 past DN 64
constexpr int many_consumers(int dn) { return dn <= 64 ? 3 : 2; }

// f(Tf32Cfg<DN, cons>{}) for the instance serving head dim D (DN = D
// rounded up to 8) with `cons` consumer warpgroups; -1 where none does (D
// below 8, past 128 or off a multiple of 4; cons not 1 or
// many_consumers(DN))
#define TF32_CASE(dn)                                \
  case (dn) * 4 + 1: return f(Tf32Cfg<(dn), 1>{}); \
  case (dn) * 4 + many_consumers(dn):              \
    return f(Tf32Cfg<(dn), many_consumers(dn)>{});
template <class F>
int with_config(int D, int cons, F&& f) {
  if (D < 8 || D > 128 || D % 4) return -1;
  const int dn = (D + 7) / 8 * 8;
  if (cons != 1 && cons != many_consumers(dn)) return -1;
  switch (dn * 4 + cons) {
    TF32_CASE(8) TF32_CASE(16) TF32_CASE(24) TF32_CASE(32)
    TF32_CASE(40) TF32_CASE(48) TF32_CASE(56) TF32_CASE(64)
    TF32_CASE(72) TF32_CASE(80) TF32_CASE(88) TF32_CASE(96)
    TF32_CASE(104) TF32_CASE(112) TF32_CASE(120) TF32_CASE(128)
    default: return -1;
  }
}
#undef TF32_CASE

template <class C>
cudaError_t launch_as(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const Tf32Params& p, int B,
                      cudaStream_t stream) {
  auto kernel = flash_fwd_tf32_wgmma_kernel<C::DN, C::kCons>;
  // the shared-memory opt-in once a device (a bit a device), not a call:
  // these launches are host-bound
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((opted >> dev) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted |= 1ull << dev;
  }
  const long long blocks = (long long)((p.Tq + C::kBQ - 1) / C::kBQ) * B * p.H;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k/v [B, Hkv, Tk, D] f32 (Hkv 1 or H) with element
// strides over batch, head and token (each a multiple of 4 elements where
// its extent passes 1, the pointers 16-byte aligned, unit stride over D,
// 8 <= D <= 128, D % 4 == 0); o a contiguous [B, H, Tq, D] f32; bias
// [N, Tq, Tk] f32 with unit key stride, strides bias_sn, bias_sq and
// bias_mode 1 (one slice), 2 (one a head) or 3 (one a (b, h)), or null
// with mode 0; lse [B*H, Tq] f32 or null; cons 1, or 3 at d <= 64 and 2
// past it, consumer warpgroups a block (`tf32_wgmma_consumers`). scale >
// 0. Returns a
// cudaError_t (0 on success), or 10000 + the CUresult of a failed
// tensor-map encode.
int flash_attn_fwd_tf32_sm90(const void* q, const void* k, const void* v,
                             void* o, const void* bias, float* lse,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long bias_sn, long long bias_sq,
                             int bias_mode, int B, int H, int Hkv, int Tq,
                             int Tk, int D, int cons, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      (Hkv != 1 && Hkv != H) || bias_mode < 0 || bias_mode > 3 ||
      ((bias_mode != 0) != (bias != nullptr)))
    return (int)cudaErrorInvalidValue;
  Tf32Params p;
  p.o = static_cast<float*>(o);
  p.bias = static_cast<const float*>(bias);
  p.lse = lse;
  p.bias_sn = bias_sn;
  p.bias_sq = bias_sq;
  p.bias_mode = bias_mode;
  p.H = H; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, cons, [&](auto cfg) {
    using C = decltype(cfg);
    CUtensorMap mq, mk, mv;
    int e = encode_tokens_f32(&mq, q, D, Tq, H, B, q_st, q_sh, q_sb, C::BW,
                              C::kBQ);
    if (!e)
      e = encode_tokens_f32(&mk, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, C::BW,
                            C::kBK);
    if (!e)
      e = encode_tokens_f32(&mv, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, C::BW,
                            C::kBK);
    if (e) return e;
    return (int)launch_as<C>(mq, mk, mv, p, B, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The tiles of the instance serving head dim D with `cons` consumer
// warpgroups: query rows and keys a block, the column block's width in
// floats (the swizzle: 4 BW bytes a row), the blocks, the ring's stages,
// the shared memory and the blocks an SM the launch bounds ask for; 0
// where none serves.
int flash_attn_fwd_tf32_sm90_plan(int D, int cons, int* bq, int* bk, int* bw,
                                  int* nb, int* stages, int* smem,
                                  int* min_blocks) {
  return with_config(D, cons, [&](auto cfg) {
    using C = decltype(cfg);
    *bq = C::kBQ;
    *bk = C::kBK;
    *bw = C::BW;
    *nb = C::NB;
    *stages = C::kStages;
    *smem = C::kSmem;
    *min_blocks = C::kMinBlocks;
    return 1;
  }) == 1;
}

const char* flash_attn_fwd_tf32_sm90_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
