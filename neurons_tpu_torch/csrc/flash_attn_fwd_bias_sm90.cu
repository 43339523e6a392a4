// The prior's biased multi-query attention forward on Hopper's warpgroup
// products (sm_90a, wgmma). Bound through a plain C interface and loaded
// with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces, for bf16 with one bias slice a head shared over the batch
// ([H, Tq, Tk]) over multi-query k/v ([B, 1, Tk, D]) at D <= 64 on rows,
// strides and pointers that are 8-byte multiples and Tk <= 576, the JAX
// package's
//   neurons_tpu/ops/attention.py:185  _flash_kernel_smallkv_bias
// (the whole K/V resident, the bias added to the logits): out =
// softmax(q k^T * scale + bias) v with f32 logits, running max and sum, the
// accurate expf and f32 accumulation, P rounded to bf16 for the P V product
// (as the register kernel, flash_fwd_reg_kernel in flash_attn_fwd.cu,
// rounds it), the output in bf16, and the log-sum-exp in the JAX
// convention m + log(max(l, 1e-30)) [B*H, Tq] f32 when asked for. Every
// launch of the prior (the stage-2 step's 6 a step, [10, 32, 513, 514, 52])
// comes here; other bias modes, other dims and 4-byte rows stay on the
// register kernel.
//
// What bounds it on an H100: 4 B H Tq Tk D operations (17.6 GFLOP at the
// prior's shape, 17.7 us at 989 TFLOP/s) against 52.7 MB (15.7 us), and B H
// Tq Tk exponentials (84.4 M, 22.8 us on the MUFU unit's ex2 at 16 a clock
// an SM, about 3.7 T/s at 1.755 GHz; the accurate expf the lse needs adds
// its range reduction around each): at d 52 the exponentials bind. The head
// dim pads the S product's depth to 64 (x 1.23 at d 52) and the ragged
// tiles (Tq 513, Tk 514: 9 where 8.02 would do on each side) add x 1.12
// each.
//
// Design. A block owns one (b, h) and 192 query rows: three warpgroups of 64
// rows, no producer. K and V of the batch row (the 32 heads share them, 107
// KB at the prior's shape) are resident in shared memory, whole: every
// thread of the block issues its share of the copies, one cp.async group a
// key tile (Q with the first), two tiles ahead of the products, and
// announces each tile on the tile's mbarrier once its own copies of it
// have landed (cp.async.wait_group, a proxy fence); a warpgroup waits only
// for the tile it reads, so the warpgroups are not held in step (a thread
// issues tile t + 2 and announces tile t + 1 as it starts tile t). The L2
// serves the K/V of the ten batch rows (1 MB) to the 32 heads' blocks. The
// rows move in 8-byte copies into 128-byte swizzled rows
// (flash_bias_sm90.cuh): TMA cannot address their 104 bytes. Per key tile
// of 64 a warpgroup runs
//   S = Q K^T   wgmma m64n64k16 over the padded depth, A (Q) and B (K) from
//               shared memory, K-major;
//   S * scale + bias (the bias's bf16 pairs read from L2 into registers
//   ahead of the product), keys past Tk at -inf, the online softmax with
//   expf;
//   O += P V    wgmma m64nDNk16, A = P in registers (S's accumulator packed
//               to bf16 pairs), B = V MN-major: DN = the head dim rounded up
//               to a multiple of 8 (56 at d 52), the real columns only.
// Each warpgroup waits for its own products; the overlap of softmax and
// products is between the three warpgroups. Sums run in one fixed order
// with no atomics: a rerun gives equal bits.

#include "flash_bias_sm90.cuh"

namespace {

// DN: the N of the O product (the head dim rounded up to 8; 32, 56 or 64);
// KS: the k16 steps of S over the zero-padded depth
template <int DN_>
struct FwdCfg {
  static constexpr int DN = DN_;
  static constexpr int KS = (DN + 15) / 16;
  static constexpr int kCons = 3, kThreads = 128 * kCons;
  static constexpr int kBQ = 64 * kCons, kBK = kTileRows;
  static constexpr int kQBytes = kBQ * kRowBytes;
  static constexpr int kKVBytes = kMaxKeyTiles * kTileBytes;  // K or V
  static constexpr int kBarOffset = kQBytes + 2 * kKVBytes;
  // Q, K, V, a full barrier a key tile, the 1024-byte alignment slack
  static constexpr int kSmem = kBarOffset + 8 * kMaxKeyTiles + 1024;
};

struct FwdParams {
  const __nv_bfloat16 *q, *k, *v, *bias;
  __nv_bfloat16* o;  // [B, H, Tq, D], contiguous
  float* lse;        // [B*H, Tq] or null
  long long q_sb, q_sh, q_st, k_sb, k_st, v_sb, v_st, bias_sh, bias_st;
  int H, Tq, Tk, D;
  float scale;
};

template <int DN>
__global__ void __launch_bounds__(FwdCfg<DN>::kThreads, 1)
flash_fwd_bias_wgmma_kernel(const FwdParams p) {
  using C = FwdCfg<DN>;
  constexpr int KS = C::KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                 // [kBQ][128 B]
  unsigned char* sK = sQ + C::kQBytes;      // [tiles][64][128 B]
  unsigned char* sV = sK + C::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);

  const int nqb = (p.Tq + C::kBQ - 1) / C::kBQ;
  const int qb = blockIdx.x % nqb, bh = blockIdx.x / nqb;
  const int b = bh / p.H, h = bh % p.H;
  const int ntiles = (p.Tk + C::kBK - 1) / C::kBK;
  const int tid = threadIdx.x, np = p.D >> 2;

  zero_pads(sQ, C::kBQ, np, tid, C::kThreads);
  zero_pads(sK, ntiles * kTileRows, np, tid, C::kThreads);
  zero_pads(sV, ntiles * kTileRows, np, tid, C::kThreads);
  if (tid == 0) {
    for (int t = 0; t < ntiles; ++t) mbar_init(full + t, C::kThreads);
    fence_barrier_init();
  }
  __syncthreads();

  // the copies, one group a key tile (Q with the first): tiles 0 and 1
  // now, tile t + 2 as tile t starts (each warpgroup's threads issue their
  // share); a tile is announced on its barrier once each thread's own
  // copies of it have landed and are fenced for the products
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb;
  const __nv_bfloat16* vg = p.v + b * p.v_sb;
  auto stage_kv = [&](int t) {
    stage_tile(smem_u32(sK) + t * kTileBytes, kg, p.k_st, t * C::kBK, p.Tk,
               np, tid, C::kThreads);
    stage_tile(smem_u32(sV) + t * kTileBytes, vg, p.v_st, t * C::kBK, p.Tk,
               np, tid, C::kThreads);
  };
  for (int w = 0; w < C::kCons; ++w)
    stage_tile(smem_u32(sQ) + w * kTileBytes, qg, p.q_st,
               qb * C::kBQ + w * 64, p.Tq, np, tid, C::kThreads);
  stage_kv(0);
  cp_async_commit();
  if (ntiles > 1) stage_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async_smem();
  mbar_arrive(full);

  // a warpgroup: 64 query rows, warp w rows 16w.., lane rows g and g + 8;
  // the key columns of its S registers: 8 i + 2 (lane % 4) + (e & 1)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int row0 = qb * C::kBQ + wg * 64 + warp * 16 + (lane >> 2);
  const uint32_t q_addr = smem_u32(sQ) + wg * kTileBytes;
  const __nv_bfloat16* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    brow[r] = row0 + 8 * r < p.Tq
                  ? p.bias + h * p.bias_sh + (long long)(row0 + 8 * r) * p.bias_st
                  : nullptr;

  float o[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {  // tile t + 1 landed (issued a tile ago)
      cp_async_wait<0>();
      fence_proxy_async_smem();
      mbar_arrive(full + t + 1);
    }
    if (t + 2 < ntiles) {
      stage_kv(t + 2);
      cp_async_commit();
    }
    // this tile's bias pairs, read while the product runs
    uint32_t bv[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        bv[r][i] = brow[r] ? load_pair(brow[r], t * C::kBK + 8 * i + 2 * t4,
                                       p.Tk)
                           : 0u;
    float sc[32];
    mbar_wait(full + t, 0);
    issue_ss64<KS>(sc, q_addr, smem_u32(sK) + t * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);

    // logits (scaled, biased; keys past Tk -inf), then the online softmax
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = t * C::kBK + 8 * i + 2 * t4 + (e & 1);
        const float2 bp = bf16x2_to_float2(bv[r][i]);
        const float bb = (e & 1) ? bp.y : bp.x;
        const float x = key < p.Tk ? fmaf(sc[4 * i + e], p.scale, bb)
                                   : -INFINITY;
        sc[4 * i + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float x = expf(sc[i] - m[r]);
      sc[i] = x;
      rs[r] += x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_frags<64>(pa, sc);

    // O += P V
    issue_rs<DN>(o, pa, smem_u32(sV) + t * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DN / 2>(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* og = p.o + (long long)bh * p.Tq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Tq) continue;
    __nv_bfloat16* orow = og + (long long)row * p.D;
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      if (col < p.D)  // D % 4 == 0: col + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
    }
    if (p.lse && t4 == 0)
      p.lse[(long long)bh * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// host side

// the instance's DN by head dim: 32 up to d 32, 56 up to 56, 64 up to 64;
// 0 past 64 or off a multiple of 4 (no instance)
inline int fwd_dn(int D) {
  if (D <= 0 || D > 64 || D % 4) return 0;
  return D <= 32 ? 32 : D <= 56 ? 56 : 64;
}

template <class F>
int with_config(int D, F&& f) {
  switch (fwd_dn(D)) {
    case 32: return f(FwdCfg<32>{});
    case 56: return f(FwdCfg<56>{});
    case 64: return f(FwdCfg<64>{});
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q [B, H, Tq, D] and k, v [B, 1, Tk, D] bf16 with element strides over
// batch, head and token (multiples of 4 elements, pointers on 8 bytes, unit
// stride over D); bias [H, Tq, Tk] bf16 with strides bias_sh, bias_st (even)
// and unit stride over keys, its pointer on 4 bytes; o a contiguous [B, H,
// Tq, D] bf16; lse [B*H, Tq] f32 or null. 0 < D <= 64 with D % 4 == 0, Tk
// <= 576. Returns a cudaError_t (0 on success).
int flash_attn_fwd_bias_sm90(const void* q, const void* k, const void* v,
                             const void* bias, void* o, float* lse,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_st, long long v_sb,
                             long long v_st, long long bias_sh,
                             long long bias_st, int B, int H, int Tq, int Tk,
                             int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      Tk > kMaxKeyTiles * kTileRows || (bias_st & 1) || (bias_sh & 1))
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_st = k_st; p.v_sb = v_sb; p.v_st = v_st;
  p.bias_sh = bias_sh; p.bias_st = bias_st;
  p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    auto kernel = flash_fwd_bias_wgmma_kernel<C::DN>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks =
        (long long)((Tq + C::kBQ - 1) / C::kBQ) * B * H;
    kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, s>>>(p);
    return (int)cudaGetLastError();
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The plan of the instance serving head dim D: its DN, query rows a block,
// keys a tile, the most key tiles, threads a block and shared memory; 0
// where none serves D.
int flash_attn_fwd_bias_sm90_plan(int D, int* dn, int* bq, int* bk,
                                  int* tiles, int* threads, int* smem) {
  return with_config(D, [&](auto cfg) {
    using C = decltype(cfg);
    *dn = C::DN;
    *bq = C::kBQ;
    *bk = C::kBK;
    *tiles = kMaxKeyTiles;
    *threads = C::kThreads;
    *smem = C::kSmem;
    return 1;
  }) == 1;
}

const char* flash_attn_fwd_bias_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
