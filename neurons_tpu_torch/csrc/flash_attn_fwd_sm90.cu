// Flash-attention forward on Hopper's own instructions (sm_90a): TMA tile
// loads from a producer warp into an mbarrier ring, and warpgroup products
// (wgmma) in two or three consumer warpgroups. Bound through a plain C
// interface and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for bf16 without a bias at head dims 32-128, the JAX package's
//   neurons_tpu/ops/attention.py:137  _flash_kernel_smallkv  (whole K/V resident)
//   neurons_tpu/ops/attention.py:226  _flash_kernel          (K/V streamed by block)
// out = softmax(q k^T * scale) v with f32 logits, f32 running max and sum
// and f32 accumulation, P rounded to bf16 for the P V product (as the
// register kernel, flash_fwd_reg_kernel in flash_attn_fwd.cu, rounds it),
// the output in bf16; the lse instance also writes the JAX log-sum-exp
// m + log(max(l, 1e-30)) [B*H, Tq] f32 and takes the accurate expf, as the
// register kernel's lse instance does. Every launch of the paths at d 32,
// 40, 64, 80, 88 and 128 comes here; the prior's biased launches take
// flash_attn_fwd_bias_sm90.cu; the register kernel keeps the other biased
// launches, rows or strides that are not 16-byte multiples (TMA cannot
// address them) and d 56, 104 and 112 (no instance; no path launches them).
//
// What bounds it on an H100: 4 Tq Tk D operations (989 TFLOP/s bf16) and
// Tq Tk exponentials (the MUFU unit's ex2, 16 a clock an SM: about 3.7 T/s
// at 1.755 GHz). At d = 64 both take about 3.1 ms at SVD's [28, 5, 9216,
// 9216]; at d = 40 and 32 the exponentials bind (1.6x and 2x the products).
// The register kernel reaches neither: each warp of 16 rows reads every K
// and V byte from shared memory through ldmatrix (16 FLOP a shared byte
// against the ~32 the tensor cores need), its 64-row blocks stream K/V from
// L2 twice as often, and each warp runs its softmax between its products.
//
// Design. A block owns one (b, h) and BQ query rows: 1 + kCons warpgroups.
// Warpgroup 0 is the producer: it gives up its registers (setmaxnreg 24)
// and one thread issues every copy: Q once, then K and V tiles of kBK keys
// into a ring of kStages stages, each tile one TMA box a column block
// (`cp.async.bulk.tensor.4d` on a CUtensorMap of the real (D, T, H, B)
// strides: the models' split(q) views are read in place, a multi-query k/v
// as a head extent of 1), each stage with a full and an empty mbarrier (K
// and V apart, so S = Q K^T starts before V lands). The kCons consumer
// warpgroups (setmaxnreg up) own 64 query rows each and, per key tile:
//   S = Q K^T   wgmma m64nBKk16, A (Q) and B (K) from shared memory, K-major;
//   the online softmax of S in registers (row max and sum over quads);
//   O += P V    wgmma m64nDk16, A = P from registers (S's accumulator packed
//               to bf16 pairs: for 16-bit types C's layout is A's), B = V
//               MN-major through the descriptor's transpose bit (no copy).
// d <= 64: 3 consumer warpgroups (BQ 192: a block streams K and V from L2
// at one byte a 192 FLOP) and 128 keys a tile; d 80: 2 and 128; d 88 and
// 128: 2 and 64. Each warpgroup waits for its own products, so the overlap
// of softmax and products is between warpgroups: while one runs its
// exponentials the others' products run. Two other overlaps were measured
// and left out (tools/torch_flash_fwd_variants.py; PERF.md): the
// two-stage pipeline inside a warpgroup (tile t's S beside tile t - 1's
// P V, its softmax while P V runs) needs S, P and O live at once, past the
// 128 registers a thread that 3 warpgroups leave (ptxas allocates by the
// launch bound, not by setmaxnreg), and ptxas serialized its products
// (C7513); named-barrier turns (the warpgroups issuing in a fixed rotation,
// FA3's ping-pong) moved nothing.
// The head dim is padded in shared memory only: TMA zero-fills the box past
// D (d 40 reads 48 columns, d 88 96) and past Tk; a zero logit is not -inf,
// so the last key tile masks its columns past Tk. Each d has the widest
// swizzle its column blocks allow (a block of BW columns is one swizzled
// row of 2 BW bytes): d 32 one 64-byte block, d 40 three of 32 bytes, d 64
// one of 128, d 80 five of 32, d 88 three of 64, d 128 two of 128. The
// inference instance folds scale * log2(e) into one FFMA ahead of
// ex2.approx. Sums run in a fixed order with no atomics: a rerun gives
// equal bits.

#include "sm90.cuh"

namespace {

// A column block of BW bf16 (one swizzled row of 2 BW bytes), NB blocks:
// the head dim padded to DK = BW * NB in shared memory. kCons consumer
// warpgroups of 64 query rows (3 at d <= 64; past it O's registers leave
// no room for S beside them at 3), kBK keys a tile, a ring of kStages K/V
// stages.
template <int BW_, int NB_>
struct WgCfg {
  static constexpr int BW = BW_, NB = NB_, DK = BW * NB;
  static constexpr int kCons = DK <= 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kCons, kStages = 2;
  // keys a tile (S: kBK / 2 registers a thread beside O's DK / 2, within
  // 128 registers at 3 warpgroups and 168 at 2)
  static constexpr int kBK = DK <= 80 ? 128 : 64;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kConsRegs = kCons == 3 ? 160 : 240;
  static constexpr int kRowBytes = 2 * BW;
  static constexpr int kMode = swizzle_mode(kRowBytes);
  static constexpr int kQBytes = kBQ * DK * 2;
  static constexpr int kTileBytes = kBK * DK * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // tiles, barriers (full q; full and empty k and v a stage), and the
  // slack that aligns the tiles to 1024 bytes
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
};

struct WgParams {
  void* o;     // [B, H, Tq, D] bf16, contiguous
  float* lse;  // [B*H, Tq] or null
  int H, Hkv, Tq, Tk, D;
  float scale, scale_log2;
};

// S = Q K^T over one key tile: k16 step ks reads 16 columns of Q and K
// (K-major: SBO = 8 rows), inside column block ks * 16 / BW
template <class C>
__device__ __forceinline__ void s_descs(uint64_t* dq, uint64_t* dk,
                                        uint32_t q_addr, uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < C::DK / 16; ++ks) {
    const int blk = ks * 16 / C::BW, off = (ks * 16 % C::BW) * 2;
    dq[ks] = gmma_desc(q_addr + blk * C::kBQ * C::kRowBytes + off, 16,
                       8 * C::kRowBytes, C::kMode);
    dk[ks] = gmma_desc(k_tile + blk * C::kBK * C::kRowBytes + off, 16,
                       8 * C::kRowBytes, C::kMode);
  }
  pin<C::DK / 16>(dq);
  pin<C::DK / 16>(dk);
}

// O += P V over one key tile: k16 step kk reads 16 rows of V (MN-major:
// LBO = one column block of the tile, SBO = 8 rows)
template <class C>
__device__ __forceinline__ void pv_descs(uint64_t* dv, uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < C::kBK / 16; ++kk)
    dv[kk] = gmma_desc(v_tile + kk * 16 * C::kRowBytes,
                       C::kBK * C::kRowBytes, 8 * C::kRowBytes, C::kMode);
  pin<C::kBK / 16>(dv);
}

// One product at the tensor cores, under one fence and one commit, and
// waited for: P V of a tile (kPV) or S of a tile. S's first step
// overwrites its registers (ss0: they are no input).
template <class C, bool kPV>
__device__ __forceinline__ void product(float* o, uint32_t (*pa)[4],
                                        const uint64_t* dv, float* sc,
                                        const uint64_t* dq,
                                        const uint64_t* dk) {
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  if (kPV) {
    fence_regs<C::DK / 2>(o);
    fence_regs<C::kBK / 4>(&pa[0][0]);
  }
  wgmma_fence();
  if (kPV) {
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk)
      Wgmma<C::DK>::rs(o, pa[kk], dv[kk], one);
  } else {
    Wgmma<C::kBK>::ss0(sc, dq[0], dk[0], zero);
#pragma unroll
    for (int ks = 1; ks < C::DK / 16; ++ks)
      Wgmma<C::kBK>::ss(sc, dq[ks], dk[ks], one);
  }
  wgmma_commit();
  wgmma_wait<0>();
  if (kPV)
    fence_regs<C::DK / 2>(o);
  else
    fence_regs<C::kBK / 2>(sc);
}

template <int BW, int NB, bool kLse>
__global__ void __launch_bounds__(WgCfg<BW, NB>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const WgParams p) {
  using C = WgCfg<BW, NB>;
  constexpr int DK = C::DK, RB = C::kRowBytes, kBQ = C::kBQ, kBK = C::kBK,
                kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                     // [NB][kBQ][BW]
  unsigned char* sK = sQ + C::kQBytes;          // [kStages][NB][kBK][BW]
  unsigned char* sV = sK + kStages * C::kTileBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int nq = (p.Tq + kBQ - 1) / kBQ;
  const int qb = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int ntiles = (p.Tk + kBK - 1) / kBK;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across each warp (its register budgets apply by branch)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

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

  if (wg == 0) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = p.Hkv == 1 ? 0 : h;
      mbar_arrive_expect_tx(full_q, C::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sQ + j * kBQ * RB, &map_q, full_q, j * BW, qb * kBQ, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const uint32_t free_parity = ((t / kStages) & 1) ^ 1;
        mbar_wait(empty_k + s, free_parity);
        mbar_arrive_expect_tx(full_k + s, C::kTileBytes);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(sK + s * C::kTileBytes + j * kBK * RB, &map_k,
                      full_k + s, j * BW, t * kBK, hk, b);
        mbar_wait(empty_v + s, free_parity);
        mbar_arrive_expect_tx(full_v + s, C::kTileBytes);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(sV + s * C::kTileBytes + j * kBK * RB, &map_v,
                      full_v + s, j * BW, t * kBK, hk, b);
      }
    }
    return;
  }

  // a consumer: 64 query rows, warp w rows 16w.., lane rows g and g + 8
  setmaxnreg_inc<C::kConsRegs>();
  const int cw = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int row0 = qb * kBQ + cw * 64 + warp * 16 + (lane >> 2);
  const float c = kLse ? p.scale : p.scale_log2;
  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * RB;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[kBK / 16][4];  // P of the tile, A fragments of P V

  // the online softmax of tile t (its S in sc), rows row0 and row0 + 8;
  // then O (P V of the tiles before t) to this tile's max, and P of tile t
  auto softmax = [&](int t, float* sc) {
    if ((t + 1) * kBK > p.Tk) {  // the last tile: keys past Tk are -inf
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * kBK + 8 * i + 2 * t4 + (e & 1) >= p.Tk)
            sc[4 * i + e] = -INFINITY;
    }
    if (kLse) {  // scaled logits first, as the plain version rounds them
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] *= c;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (kLse) {
        mc[r] = mx[r];
        alpha[r] = expf(m[r] - mx[r]);
      } else {
        mc[r] = mx[r] * c;
        alpha[r] = ex2_approx(fmaf(m[r], c, -mc[r]));
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float x = kLse ? expf(sc[i] - mc[r])
                           : ex2_approx(fmaf(sc[i], c, -mc[r]));
      sc[i] = x;
      rs[r] += x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // per key tile: S, its softmax, then P V; the other warpgroups' products
  // run at the tensor cores while this one's softmax runs
  mbar_wait(full_q, 0);
  uint64_t dq[DK / 16], dk[DK / 16], dv[kBK / 16];
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    float sc[kBK / 2];
    s_descs<C>(dq, dk, q_addr, k_addr + s * C::kTileBytes);
    mbar_wait(full_k + s, parity);
    product<C, false>(o, pa, dv, sc, dq, dk);
    if (tid == 0) mbar_arrive(empty_k + s);
    softmax(t, sc);
    pv_descs<C>(dv, v_addr + s * C::kTileBytes);
    mbar_wait(full_v + s, parity);
    product<C, true>(o, pa, dv, sc, dq, dk);
    if (tid == 0) mbar_arrive(empty_v + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (long long)bh * p.Tq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Tq) continue;
    __nv_bfloat16* orow = og + (long long)row * p.D;
#pragma unroll
    for (int i = 0; i < DK / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      if (col < p.D)  // D is a multiple of 8: col + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
    }
    if (kLse && t4 == 0)
      p.lse[(long long)bh * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// host side

// the column blocks of an instance by head dim: (BW, NB), or (0, 0) where
// no instance serves D (D past 128, below 32, not a multiple of 8, or 56,
// 104, 112: no path launches them)
inline void column_blocks(int D, int* bw, int* nb) {
  *bw = 0;
  *nb = 0;
  if (D < 32 || D > 128 || D % 8) return;
  if (D <= 32) { *bw = 32; *nb = 1; }
  else if (D <= 48) { *bw = 16; *nb = 3; }
  else if (D == 64) { *bw = 64; *nb = 1; }
  else if (D > 64 && D <= 80) { *bw = 16; *nb = 5; }
  else if (D > 80 && D <= 96) { *bw = 32; *nb = 3; }
  else if (D >= 120) { *bw = 64; *nb = 2; }
}

// f(WgCfg<BW, NB>{}) for the instance serving D; -1 where none does
template <class F>
int with_config(int D, F&& f) {
  int bw, nb;
  column_blocks(D, &bw, &nb);
  switch (bw * 8 + nb) {
    case 32 * 8 + 1: return f(WgCfg<32, 1>{});
    case 16 * 8 + 3: return f(WgCfg<16, 3>{});
    case 64 * 8 + 1: return f(WgCfg<64, 1>{});
    case 16 * 8 + 5: return f(WgCfg<16, 5>{});
    case 32 * 8 + 3: return f(WgCfg<32, 3>{});
    case 64 * 8 + 2: return f(WgCfg<64, 2>{});
    default: return -1;
  }
}

template <class C, bool kLse>
cudaError_t launch_as(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const WgParams& p, int B,
                      cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<C::BW, C::NB, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + C::kBQ - 1) / C::kBQ) * B * p.H;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k/v [B, Hkv, Tk, D] bf16 (Hkv 1 or H) with element
// strides over batch, head and token (each a multiple of 8 elements, the
// pointers 16-byte aligned, unit stride over D); o a contiguous [B, H, Tq,
// D] bf16; lse [B*H, Tq] f32 or null. scale > 0. Returns a cudaError_t (0
// on success), or 10000 + the CUresult of a failed tensor-map encode.
int flash_attn_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                        float* lse, long long q_sb, long long q_sh,
                        long long q_st, long long k_sb, long long k_sh,
                        long long k_st, long long v_sb, long long v_sh,
                        long long v_st, int B, int H, int Hkv, int Tq, int Tk,
                        int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !(scale > 0.f) ||
      (Hkv != 1 && Hkv != H))
    return (int)cudaErrorInvalidValue;
  WgParams p;
  p.o = o;
  p.lse = lse;
  p.H = H; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    CUtensorMap mq, mk, mv;
    int e = encode_tokens(&mq, q, D, Tq, H, B, q_st, q_sh, q_sb, C::BW,
                          C::kBQ);
    if (!e)
      e = encode_tokens(&mk, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, C::BW,
                        C::kBK);
    if (!e)
      e = encode_tokens(&mv, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, C::BW,
                        C::kBK);
    if (e) return e;
    return (int)(lse ? launch_as<C, true>(mq, mk, mv, p, B, s)
                     : launch_as<C, false>(mq, mk, mv, p, B, s));
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The tiles of the instance serving head dim D: query rows and keys a
// block, the column block's width (the swizzle: 2 BW bytes a row), the
// blocks, the ring's stages and the shared memory; 0 where none serves D.
int flash_attn_fwd_sm90_plan(int D, int* bq, int* bk, int* bw, int* nb,
                             int* stages, int* smem) {
  return with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *bq = C::kBQ;
    *bk = C::kBK;
    *bw = C::BW;
    *nb = C::NB;
    *stages = C::kStages;
    *smem = C::kSmem;
    return 1;
  }) == 1;
}

const char* flash_attn_fwd_sm90_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
