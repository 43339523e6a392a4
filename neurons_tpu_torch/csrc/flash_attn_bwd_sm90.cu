// Flash-attention backward on Hopper's own instructions (sm_90a): TMA tile
// loads from a producer warp into an mbarrier ring, and warpgroup products
// (wgmma) in two consumer warpgroups. Bound through a plain C interface and
// loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for bf16 without a bias at head dims 32, 64 and 128 on rows,
// strides and pointers that are 16-byte multiples, the JAX package's
//   neurons_tpu/ops/attention.py:276  _flash_bwd_kernel
// (called through _flash_bwd_pallas, :349, and _flash_bwd, :705): the
// FlashAttention-2 backward from the forward's saved log-sum-exp, with
// s = q k^T * scale in f32,
//   p  = exp(s - lse)
//   dv = p^T g          (p rounded to bf16 first)
//   dp = g v^T,  ds = p (dp - delta)   (delta = sum_d g * out, from the caller)
//   dk = (ds*scale)^T q,  dq = (ds*scale) k   (ds*scale rounded to bf16)
// with f32 accumulation throughout, as the register kernels of
// flash_attn_bwd.cu compute it. Outputs: dq [B*H, Tq, D] bf16; dk and dv
// [B*H, Tk, D] rounded to bf16 once, or for multi-query k/v in f32, one
// per (b, h), which the caller sums over heads in f32 and casts. Every
// unbiased bf16 backward of the
// paths comes here: the stage-2 step's DecoderVideo attention, [60, 1, T,
// T, D] at (T, D) = (256, 128), (1024, 64), (4096, 32). The prior's
// biased launches (d 52: a 104-byte row TMA cannot address) take
// flash_attn_bwd_bias_sm90.cu; the register kernels keep the other biased
// launches, rows off 16 bytes and the head dims no instance serves.
//
// What bounds it on an H100: 10 Tq Tk D operations a (b, h) (5 products;
// the two passes below make 7) at 989 TFLOP/s, and 2 Tq Tk exponentials
// (one a pass) on the MUFU unit's ex2 (16 a clock an SM: about 3.7 T/s at
// 1.755 GHz). At the decoder's 64 x 64 site, [60, 1, 4096, 4096, 32], the
// products take 0.33 ms and the exponentials 0.54 ms; at d 64 and 128 the
// products bind.
//
// Design. Two passes and no atomics, so every sum has one fixed order and
// a rerun gives equal bits. Each block is a producer warpgroup and 2 or 3
// consumer warpgroups (BwdCfg). The producer gives up its registers
// (setmaxnreg) and one warp feeds a ring of kStages stages, each tile one
// TMA box a column block (`cp.async.bulk.tensor.4d` on a CUtensorMap of
// the real (D, T, H, B) strides: the models' views are read in place, a
// multi-query k/v as a head extent of 1), each stage with a full and an
// empty mbarrier. Each consumer warpgroup owns 64 rows.
//  * Pass 1, dK/dV (flash_bwd_dkdv_wgmma_kernel): a block owns one (b, h)
//    and 64 keys a consumer warpgroup (at d 128 both warpgroups share 64:
//    BwdCfg); K and V are staged once. Q and g tiles of kBQ queries
//    stream through the ring, and the producer warp writes each tile's
//    lse * log2(e) and delta beside them (+inf and 0 past Tq, so p = 0
//    there). Per tile a consumer computes
//      S^T = K Q^T, dP^T = V g^T   wgmma m64nBQk16, ss: A (K, V) and B
//                                  (Q, g) from shared memory, K-major;
//      P^T = ex2(S^T * scale * log2(e) - lse * log2(e)) and dS^T * scale =
//      P^T (dP^T - delta) * scale in registers, packed to bf16 in place
//      (for 16-bit types the C layout is the A layout);
//      dV += P^T g, dK += (dS^T * scale) Q   wgmma m64nDk16, rs: A from
//                                  registers, B (g, Q) MN-major through the
//                                  descriptor's transpose bit.
//    dK and dV are f32 register accumulators, written once.
//  * Pass 2, dQ (flash_bwd_dq_wgmma_kernel), launched first: a block owns
//    one (b, h) and 64 queries a consumer warpgroup; Q and g are staged
//    once, each thread reads its two rows' lse and takes their delta from
//    g and out (its quad's share of the columns, summed over the quad),
//    writing it for pass 1; K and V tiles of kBK keys stream through the
//    ring.
//    S = Q K^T and dP = g V^T (ss), dS * scale in registers with the last
//    tile's keys past Tk masked (p = 0: TMA fills them with zeros, and a
//    zero logit is not -inf), and dQ += (dS * scale) K (rs, K MN-major).
//    dQ is written once, in bf16.
// Every ring tile is 64 rows: S and dP take 64 registers a thread beside
// the accumulators, within the launch bound's share (BwdCfg).
// A consumer waits for its own products, so the overlap of exponentials
// and products is between the warpgroups. The descriptors of each group
// of products are pinned ahead of its fence (`pin`, sm90.cuh). One column
// block of BW = min(D, 64) bf16, the widest swizzle the row allows: d 32
// one of 64 bytes, d 64 one of 128, d 128 two of 128; no other head dim has
// an instance. The probabilities take one FFMA and ex2.approx (the register
// kernels the accurate expf).
// What was measured (tools/torch_flash_bwd_variants.py; PERF.md has the
// times): a third consumer warpgroup where 128 registers still hold the
// tile (dK/dV at d 32, dQ up to d 64) pays, spilling dK/dV at d 64 does
// not; 3 or 4 ring stages change nothing; the accurate expf costs 0.5 ms
// at the 64 x 64 site; issuing tile t + 1's S behind tile t's gradient
// products inside a warpgroup makes ptxas serialize every product (C751x)
// and is slower. Removing parts in turn there, the products take about
// 0.55 of 1.25 ms (the gradient products, N = D = 32, most of it), the
// exponentials 0.11: the rest is each warpgroup waiting on its own
// products, with two or three warpgroups to overlap them.

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// A block of the producer warpgroup and kCons consumer warpgroups: its
// threads, and the registers a producer and a consumer thread hold after
// setmaxnreg (all the warpgroups' within the SM's 64 K). The block's warps
// share each SM sub-partition's 16 K registers, so ptxas compiles every
// thread for the launch bound's share (168 at 12 warps, 128 at 16):
// setmaxnreg moves registers at run time only.
template <int kCons>
struct Block {
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kProdRegs = kCons == 3 ? 24 : 40;
  static constexpr int kConsRegs = kCons == 3 ? 160 : 232;
};

// The tiles of the instance at head dim D: kCons1 and kCons2 consumer
// warpgroups in pass 1 and pass 2, kRows1 keys a pass-1 block, kRows2
// queries a pass-2 block, kBQ queries a pass-1 ring tile, kBK keys a pass-2
// ring tile, kStages ring stages. Pass 1 holds dK and dV (D registers a
// thread) beside S^T and dP^T (kBQ): up to d 64 each warpgroup owns 64 keys
// and both gradients (3 warpgroups at d 32, within 128 registers; 2 at d
// 64); at d 128 (kSplit) the two warpgroups share 64 keys, one
// accumulating dV (recomputing S^T and P^T itself), the other dK. Pass 2
// holds dQ (D / 2) beside S and dP (kBK): 3 warpgroups up to d 64.
template <int D_>
struct BwdCfg {
  static constexpr int D = D_;
  static constexpr int BW = D <= 64 ? D : 64, NB = D / BW;
  static constexpr int kRowBytes = 2 * BW;
  static constexpr int kMode = swizzle_mode(kRowBytes);
  static constexpr int kCons1 = D <= 32 ? 3 : 2;
  static constexpr int kCons2 = D <= 64 ? 3 : 2;
  static constexpr bool kSplit = D > 64;
  static_assert(!kSplit || kCons1 == 2, "the split pairs two warpgroups");
  static constexpr int kRows1 = kSplit ? 64 : 64 * kCons1;
  static constexpr int kRows2 = 64 * kCons2;
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kRes1 = kRows1 * D * 2;  // one resident K or V tile
  static constexpr int kRes2 = kRows2 * D * 2;  // one resident Q or g tile
  static constexpr int kTile1 = kBQ * D * 2;    // one Q or g ring tile
  static constexpr int kTile2 = kBK * D * 2;    // one K or V ring tile
  // pass 1: K, V, the ring of Q and g tiles, each stage's lse * log2(e)
  // and delta, the barriers (full K/V; full and empty a stage), and the
  // slack that aligns the tiles to 1024 bytes
  static constexpr int kStats1 = 2 * kRes1 + 2 * kStages * kTile1;
  static constexpr int kBar1 = kStats1 + kStages * 2 * kBQ * 4;
  static constexpr int kSmem1 = kBar1 + 8 * (1 + 2 * kStages) + 1024;
  // pass 2: Q, g, the ring of K and V tiles, the barriers
  static constexpr int kBar2 = 2 * kRes2 + 2 * kStages * kTile2;
  static constexpr int kSmem2 = kBar2 + 8 * (1 + 2 * kStages) + 1024;
};

struct BwdParams {
  const __nv_bfloat16* g;    // [B*H, Tq, D], contiguous
  const __nv_bfloat16* out;  // [B*H, Tq, D], contiguous
  const float* lse;          // [B*H, Tq]
  float* delta;              // [B*H, Tq]: written by pass 2, read by pass 1
  __nv_bfloat16* dq;         // [B*H, Tq, D]
  void* dk;                  // [B*H, Tk, D]: bf16, f32 for multi-query k/v
  void* dv;
  int H, Hkv, Tq, Tk;
  float scale, scale_log2;
};

// acc = A B^T over the head dim, issued under one fence, not committed: A
// the 64 rows at a (a tile of kARows rows a column block), B the N rows at
// b (kBRows rows a column block), both K-major (SBO = 8 rows); k16 step ks
// reads 16 columns inside column block ks * 16 / BW. The first step
// overwrites acc (ss0: its registers are no input).
template <class C, int N, int kARows, int kBRows>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a, uint32_t b) {
  constexpr int KS = C::D / 16, RB = C::kRowBytes;
  uint64_t da[KS], db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int blk = ks * 16 / C::BW, off = (ks * 16 % C::BW) * 2;
    da[ks] = gmma_desc(a + blk * kARows * RB + off, 16, 8 * RB, C::kMode);
    db[ks] = gmma_desc(b + blk * kBRows * RB + off, 16, 8 * RB, C::kMode);
  }
  pin<KS>(da);
  pin<KS>(db);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  wgmma_fence();
  Wgmma<N>::ss0(acc, da[0], db[0], zero);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) Wgmma<N>::ss(acc, da[ks], db[ks], one);
}

// acc += A B over K rows of B, issued under one fence, not committed: A
// the bf16 fragments a[K / 16] in registers, B the [K][D] tile at b (kRows
// rows a column block) read MN-major (LBO = one column block, SBO = 8
// rows; k16 step kk starts 16 rows on).
template <class C, int K, int kRows>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t (*a)[4],
                                         uint32_t b) {
  constexpr int RB = C::kRowBytes;
  uint64_t db[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    db[kk] = gmma_desc(b + kk * 16 * RB, kRows * RB, 8 * RB, C::kMode);
  pin<K / 16>(db);
  int one = 1;
  asm volatile("" : "+r"(one));
  fence_regs<C::D / 2>(acc);
  fence_regs<K / 4>(&a[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) Wgmma<C::D>::rs(acc, a[kk], db[kk], one);
}

// p = exp(s * scale - lse) = 2^(s * scale * log2(e) - lse * log2(e)): one
// FFMA and ex2.approx (c = scale * log2(e), l2 = lse * log2(e))
__device__ __forceinline__ float prob(float s, float c, float l2) {
  return ex2_approx(fmaf(s, c, -l2));
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// an accumulator's registers packed to bf16 pairs: the A fragments of the
// k16 steps over its N columns (chunks 2 kk and 2 kk + 1 of C are A's k
// step kk)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16x2(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// A warpgroup's gradients of its keys (rows key0, key0 + 8 of this lane)
// into [B*H, Tk, D] at `to` + out: bf16, or f32 for multi-query k/v (the
// caller sums them over heads)
template <int D>
__device__ __forceinline__ void write_keys(void* to, const float* acc,
                                           const BwdParams& p, long long out,
                                           int key0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Tk) continue;
    const long long at = out + (long long)key * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      const float x = acc[4 * i + 2 * r], y = acc[4 * i + 2 * r + 1];
      if (p.Hkv != p.H)
        *reinterpret_cast<float2*>(static_cast<float*>(to) + at + col) =
            make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(to) + at +
                                     col) = pack_bf16x2(x, y);
    }
  }
}

// A pass-1 consumer warpgroup over every query tile: S^T = K Q^T (and,
// for dK, dP^T = V g^T), P^T (and dS^T * scale), then dV += P^T g (kDV)
// and dK += (dS^T * scale) Q (kDK); the gradients of its 64 keys, written
// once. k_addr, v_addr: its keys in the resident tiles; key0: this lane's
// first key.
template <class C, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_consumer(
    const BwdParams& p, uint32_t k_addr, uint32_t v_addr, uint32_t q_addr,
    uint32_t g_addr, const float* sStat, uint64_t* full, uint64_t* empty,
    int nq, long long out, int key0) {
  constexpr int D = C::D, BQ = C::kBQ, R = C::kRows1, S = C::kStages;
  const int tid = threadIdx.x & 127, t4 = tid & 3;
  const float c = p.scale_log2;
  float dk[kDK ? D / 2 : 1], dv[kDV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (kDK) dk[i] = 0.f;
    if constexpr (kDV) dv[i] = 0.f;
  }
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];

  for (int t = 0; t < nq; ++t) {
    const int s = t % S;
    const uint32_t qs = q_addr + s * C::kTile1, gs = g_addr + s * C::kTile1;
    float sc[BQ / 2], dp[BQ / 2];
    mbar_wait(full + s, (t / S) & 1);
    // S^T = K Q^T, dP^T = V g^T
    issue_ss<C, BQ, R, BQ>(sc, k_addr, qs);
    if constexpr (kDK) issue_ss<C, BQ, R, BQ>(dp, v_addr, gs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(sc);
    if constexpr (kDK) fence_regs<BQ / 2>(dp);
    // P^T and dS^T * scale
    const float* st = sStat + s * 2 * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * i + 2 * t4);
      const float2 dl =
          *reinterpret_cast<const float2*>(st + BQ + 8 * i + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = prob(sc[4 * i + e], c, (e & 1) ? l2.y : l2.x);
        sc[4 * i + e] = pv;
        if constexpr (kDK)
          dp[4 * i + e] = pv * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x)) *
                          p.scale;
      }
    }
    // dV += P^T g, dK += (dS^T * scale) Q
    if constexpr (kDV) {
      pack_a<BQ>(pa, sc);
      issue_rs<C, BQ, BQ>(dv, pa, gs);
    }
    if constexpr (kDK) {
      pack_a<BQ>(da, dp);
      issue_rs<C, BQ, BQ>(dk, da, qs);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDV) fence_regs<D / 2>(dv);
    if constexpr (kDK) fence_regs<D / 2>(dk);
    if (tid == 0) mbar_arrive(empty + s);
  }

  if constexpr (kDK) write_keys<D>(p.dk, dk, p, out, key0, t4);
  if constexpr (kDV) write_keys<D>(p.dv, dv, p, out, key0, t4);
}

// Pass 1: dK and dV of kRows1 keys of one (b, h).
template <int D>
__global__ void __launch_bounds__(Block<BwdCfg<D>::kCons1>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_g,
                            const BwdParams p) {
  using C = BwdCfg<D>;
  using W = Block<C::kCons1>;
  constexpr int RB = C::kRowBytes, NB = C::NB, BW = C::BW, BQ = C::kBQ,
                R = C::kRows1, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;                    // [NB][R][BW]
  unsigned char* sV = sK + C::kRes1;
  unsigned char* sQ = sV + C::kRes1;           // [S][NB][BQ][BW]
  unsigned char* sG = sQ + S * C::kTile1;
  float* sStat = reinterpret_cast<float*>(smem + C::kStats1);  // [S][2][BQ]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBar1);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + S;

  const int nk = (p.Tk + R - 1) / R;
  const int kb = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + BQ - 1) / BQ;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across each warp (its register budgets apply by branch)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);  // the producer warp's lanes
      mbar_init(empty + s, C::kCons1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: its first warp
    setmaxnreg_dec<W::kProdRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x, hk = p.Hkv == 1 ? 0 : h;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 2 * C::kRes1);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sK + j * R * RB, &map_k, full_kv, j * BW, kb * R, hk, b);
          tma_load_4d(sV + j * R * RB, &map_v, full_kv, j * BW, kb * R, hk, b);
        }
      }
      const float* lse = p.lse + (long long)bh * p.Tq;
      const float* delta = p.delta + (long long)bh * p.Tq;
      for (int t = 0; t < nq; ++t) {
        const int s = t % S;
        // this lane's share of the tile's lse and delta, loaded ahead of
        // the wait for its stage
        float l2[BQ / 32], dl[BQ / 32];
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          const int q = t * BQ + 32 * j + lane;
          l2[j] = q < p.Tq ? lse[q] * kLog2e : INFINITY;
          dl[j] = q < p.Tq ? delta[q] : 0.f;
        }
        mbar_wait(empty + s, ((t / S) & 1) ^ 1);
        float* st = sStat + s * 2 * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          st[32 * j + lane] = l2[j];
          st[BQ + 32 * j + lane] = dl[j];
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, 2 * C::kTile1);
          for (int j = 0; j < NB; ++j) {
            tma_load_4d(sQ + s * C::kTile1 + j * BQ * RB, &map_q, full + s,
                        j * BW, t * BQ, h, b);
            tma_load_4d(sG + s * C::kTile1 + j * BQ * RB, &map_g, full + s,
                        j * BW, t * BQ, h, b);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  // a consumer: 64 keys, warp w keys 16w.., lane keys g and g + 8; the
  // query columns of its S^T registers: 8 i + 2 (lane % 4) + (e & 1)
  setmaxnreg_inc<W::kConsRegs>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int rows = C::kSplit ? 0 : cw * 64;  // its keys in the block
  const uint32_t k_addr = smem_u32(sK) + rows * RB;
  const uint32_t v_addr = smem_u32(sV) + rows * RB;
  const uint32_t q_addr = smem_u32(sQ), g_addr = smem_u32(sG);
  const int key0 = kb * R + rows + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const long long out = (long long)bh * p.Tk * D;
  mbar_wait(full_kv, 0);
  if (!C::kSplit)
    dkdv_consumer<C, true, true>(p, k_addr, v_addr, q_addr, g_addr, sStat,
                                 full, empty, nq, out, key0);
  else if (cw == 0)
    dkdv_consumer<C, true, false>(p, k_addr, v_addr, q_addr, g_addr, sStat,
                                  full, empty, nq, out, key0);
  else
    dkdv_consumer<C, false, true>(p, k_addr, v_addr, q_addr, g_addr, sStat,
                                  full, empty, nq, out, key0);
}

// Pass 2: dQ of kRows2 queries of one (b, h), and their delta.
template <int D>
__global__ void __launch_bounds__(Block<BwdCfg<D>::kCons2>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_g,
                          const BwdParams p) {
  using C = BwdCfg<D>;
  using W = Block<C::kCons2>;
  constexpr int RB = C::kRowBytes, NB = C::NB, BW = C::BW, BK = C::kBK,
                R = C::kRows2, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                    // [NB][R][BW]
  unsigned char* sG = sQ + C::kRes2;
  unsigned char* sK = sG + C::kRes2;           // [S][NB][BK][BW]
  unsigned char* sV = sK + S * C::kTile2;
  uint64_t* full_qg = reinterpret_cast<uint64_t*>(smem + C::kBar2);
  uint64_t* full = full_qg + 1;
  uint64_t* empty = full + S;

  const int nq = (p.Tq + R - 1) / R;
  const int qb = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int ntiles = (p.Tk + BK - 1) / BK;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_qg, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::kCons2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread
    setmaxnreg_dec<W::kProdRegs>();
    if (threadIdx.x == 0) {
      const int hk = p.Hkv == 1 ? 0 : h;
      mbar_arrive_expect_tx(full_qg, 2 * C::kRes2);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sQ + j * R * RB, &map_q, full_qg, j * BW, qb * R, h, b);
        tma_load_4d(sG + j * R * RB, &map_g, full_qg, j * BW, qb * R, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + s, ((t / S) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * C::kTile2);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sK + s * C::kTile2 + j * BK * RB, &map_k, full + s,
                      j * BW, t * BK, hk, b);
          tma_load_4d(sV + s * C::kTile2 + j * BK * RB, &map_v, full + s,
                      j * BW, t * BK, hk, b);
        }
      }
    }
    return;
  }

  // a consumer: 64 queries, warp w rows 16w.., lane rows g and g + 8; the
  // key columns of its S registers: 8 i + 2 (lane % 4) + (e & 1)
  setmaxnreg_inc<W::kConsRegs>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int row0 = qb * R + cw * 64 + warp * 16 + (lane >> 2);
  const uint32_t qa = smem_u32(sQ) + cw * 64 * RB;
  const uint32_t ga = smem_u32(sG) + cw * 64 * RB;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
  const float c = p.scale_log2;
  // lse * log2(e) and delta = sum_d g * out of rows row0, row0 + 8 (+inf
  // and 0 past Tq), delta in f32: each lane of a quad sums its D / 4
  // columns in order, the quad adds the four sums (lanes xor 1, then xor
  // 2); written for the dK/dV pass, which runs next
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < p.Tq;
    const long long at = ((long long)bh * p.Tq + row) * D + t4 * (D / 4);
    float acc = 0.f;
    if (ok) {
#pragma unroll
      for (int j = 0; j < D / 4; j += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(p.g + at + j);
        const uint4 ov = *reinterpret_cast<const uint4*>(p.out + at + j);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 gf = unpack_bf16x2(gw[w]), of = unpack_bf16x2(ow[w]);
          acc = fmaf(gf.x, of.x, acc);
          acc = fmaf(gf.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    l2[r] = ok ? p.lse[(long long)bh * p.Tq + row] * kLog2e : INFINITY;
    if (ok && t4 == 0) p.delta[(long long)bh * p.Tq + row] = acc;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t da[BK / 16][4];

  mbar_wait(full_qg, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    const uint32_t ks = k_addr + s * C::kTile2, vs = v_addr + s * C::kTile2;
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(full + s, (t / S) & 1);
    // S = Q K^T, dP = g V^T
    issue_ss<C, BK, R, BK>(sc, qa, ks);
    issue_ss<C, BK, R, BK>(dp, ga, vs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    fence_regs<BK / 2>(dp);
    // dS * scale; keys past Tk (the last tile's zero-filled rows) give p = 0
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
    pack_a<BK>(da, dp);
    // dQ += (dS * scale) K
    issue_rs<C, BK, BK>(dq, da, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    if (tid == 0) mbar_arrive(empty + s);
  }

  __nv_bfloat16* og = p.dq + (long long)bh * p.Tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Tq) continue;
    __nv_bfloat16* orow = og + (long long)row * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t4) =
          pack_bf16x2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// host side

// f(BwdCfg<D>{}) for the instance serving D; -1 where none does
template <class F>
int with_config(int D, F&& f) {
  switch (D) {
    case 32: return f(BwdCfg<32>{});
    case 64: return f(BwdCfg<64>{});
    case 128: return f(BwdCfg<128>{});
    default: return -1;
  }
}

struct Operands {
  const void *q, *k, *v, *g;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, g_sb, g_sh,
      g_st;
  int B;
};

// the maps of q, k, v and g for one pass: boxes of q_rows rows of q and g,
// of kv_rows rows of k and v (the block's resident rows, or a ring tile's)
template <class C>
int encode_maps(CUtensorMap* m, const Operands& o, const BwdParams& p,
                int q_rows, int kv_rows) {
  const int D = C::D, H = p.H, B = o.B;
  int e = encode_tokens(m + 0, o.q, D, p.Tq, H, B, o.q_st, o.q_sh, o.q_sb,
                        C::BW, q_rows);
  if (!e)
    e = encode_tokens(m + 1, o.k, D, p.Tk, p.Hkv, B, o.k_st, o.k_sh, o.k_sb,
                      C::BW, kv_rows);
  if (!e)
    e = encode_tokens(m + 2, o.v, D, p.Tk, p.Hkv, B, o.v_st, o.v_sh, o.v_sb,
                      C::BW, kv_rows);
  if (!e)
    e = encode_tokens(m + 3, o.g, D, p.Tq, H, B, o.g_st, o.g_sh, o.g_sb,
                      C::BW, q_rows);
  return e;
}

template <class C>
int launch_as(const Operands& o, const BwdParams& p, cudaStream_t stream) {
  CUtensorMap m1[4], m2[4];
  int e = encode_maps<C>(m1, o, p, C::kBQ, C::kRows1);
  if (!e) e = encode_maps<C>(m2, o, p, C::kRows2, C::kBK);
  if (e) return e;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<C::D>;
  auto dq = flash_bwd_dq_wgmma_kernel<C::D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem2);
  if (err != cudaSuccess) return (int)err;
  const long long bh = (long long)o.B * p.H;
  const long long nk = (p.Tk + C::kRows1 - 1) / C::kRows1;
  const long long nq = (p.Tq + C::kRows2 - 1) / C::kRows2;
  constexpr int kThreads1 = Block<C::kCons1>::kThreads;
  constexpr int kThreads2 = Block<C::kCons2>::kThreads;
  // the dQ pass first: it writes delta, which the dK/dV pass reads
  dq<<<(unsigned)(bh * nq), kThreads2, C::kSmem2, stream>>>(
      m2[0], m2[1], m2[2], m2[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)(bh * nk), kThreads1, C::kSmem1, stream>>>(
      m1[0], m1[1], m1[2], m1[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, g [B, H, Tq, D] and k, v [B, Hkv, Tk, D] bf16 (Hkv 1 or H) with
// element strides over batch, head and token (each a multiple of 8
// elements where its extent passes 1, the pointers 16-byte aligned, unit
// stride over D; g also contiguous); out, the forward's output, a
// contiguous [B, H, Tq, D] bf16 on 16 bytes; lse [B*H, Tq] f32; delta a
// [B*H, Tq] f32 scratch the kernels write and read; dq a contiguous [B*H,
// Tq, D] bf16, dk and dv contiguous [B*H, Tk, D], bf16 where Hkv == H and
// f32 (one per (b, h), for the caller to sum over heads) where Hkv == 1 <
// H. D is 32, 64 or 128, scale > 0; no input aliases an output. Launches
// the dQ pass, then the dK/dV pass, on `stream`. Returns a cudaError_t (0
// on success), or 10000 + the CUresult of a failed tensor-map encode.
int flash_attn_bwd_sm90(const void* q, const void* k, const void* v,
                        const void* g, const void* out, const float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        long long q_sb,
                        long long q_sh, long long q_st, long long k_sb,
                        long long k_sh, long long k_st, long long v_sb,
                        long long v_sh, long long v_st, long long g_sb,
                        long long g_sh, long long g_st, int B, int H,
                        int Hkv, int Tq, int Tk, int D, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      (Hkv != 1 && Hkv != H))
    return (int)cudaErrorInvalidValue;
  const Operands o{q, k, v, g, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                   v_sb, v_sh, v_st, g_sb, g_sh, g_st, B};
  BwdParams p;
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = dk;
  p.dv = dv;
  p.H = H; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, [&](auto cfg) {
    return launch_as<decltype(cfg)>(o, p, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The tiles of the instance serving head dim D: keys a dK/dV block,
// queries a dQ block, queries a dK/dV ring tile, keys a dQ ring tile, the
// column block's width (the swizzle: 2 BW bytes a row), the blocks, the
// ring's stages and each pass's shared memory; 0 where none serves D.
int flash_attn_bwd_sm90_plan(int D, int* rows1, int* rows2, int* bq, int* bk,
                             int* bw, int* nb, int* stages, int* smem1,
                             int* smem2) {
  return with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *rows1 = C::kRows1;
    *rows2 = C::kRows2;
    *bq = C::kBQ;
    *bk = C::kBK;
    *bw = C::BW;
    *nb = C::NB;
    *stages = C::kStages;
    *smem1 = C::kSmem1;
    *smem2 = C::kSmem2;
    return 1;
  }) == 1;
}

const char* flash_attn_bwd_sm90_error_string(int err) {
  if (err >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
