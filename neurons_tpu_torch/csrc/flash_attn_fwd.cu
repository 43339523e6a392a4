// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces the JAX package's three Pallas TPU forward kernels
//   neurons_tpu/ops/attention.py:137  _flash_kernel_smallkv       (whole K/V resident)
//   neurons_tpu/ops/attention.py:226  _flash_kernel               (K/V streamed by block)
//   neurons_tpu/ops/attention.py:185  _flash_kernel_smallkv_bias  (#137 plus a bias)
// which compute the same function: out = softmax(q k^T * scale + bias) v, with
// f32 logits, f32 running max and sum, f32 accumulation, and the output in the
// input type. The TPU split between them exists because VMEM holds a whole
// K/V window only up to ~4.6 KB a row; here one source serves all three.
//
// Training outputs. An optional additive bias [N, Tq, Tk] (N in {1, H, B*H},
// unit stride over keys, the input type) is added in f32 after the scale, as
// the Pallas kernel does (:208). An optional log-sum-exp output [B*H, Tq] f32
// takes m + log(max(l, 1e-30)) over the scaled and biased logits, the JAX
// convention (:182), which the backward (flash_attn_bwd.cu) recomputes its
// probabilities from. Inference launches pass neither and run as before.
//
// Layout: q [B, H, Tq, D], k/v [B, Hkv, Tk, D] with Hkv in {1, H} (multi-query
// k/v are read through a head stride of 0, never broadcast in memory), any
// strides over batch, head and token, unit stride over D. The output is a
// contiguous [B, H, Tq, D]. Ragged Tq and Tk are masked in the kernel and D is
// zero-padded in shared memory (to the instance's head dim), so no padded
// copy of any operand is made in device memory.
//
// Design of the bf16 instances at D <= 128 (flash_fwd_reg_kernel), every
// inference and training site of the paths: one block of 4 warps owns one
// (b, h) and 64 query rows, 16 per warp. Q is staged once and held as
// ldmatrix A fragments in registers. K and V tiles of 64 keys sit in a
// 2-stage shared-memory ring filled by cp.async one tile ahead (16-, 8- or
// 4-byte copies as the rows allow, element copies otherwise, zero-filled
// past Tk and past D): one barrier a tile. S = Q K^T runs as mma.sync
// m16n8k16 bf16 into f32 registers; the online softmax (row max and sum in
// f32) runs in registers with quad shuffles; P goes from S's C-fragment
// layout straight into the A fragments of O += P V as bf16, never through
// shared memory; O is an f32 register accumulator rescaled in place. The
// head dim is padded to 16 only in shared memory and in the Q K^T
// fragments (instances for 32, 48, 64, 80, 96, 128), and P V runs the real
// D's n8 tiles (40 = 5, 52 = 7).
//
// The bf16 instances at 128 < D <= 512 (flash_fwd_wide_kernel): launches
// with a bias or the lse, rows or strides that are not 16-byte multiples
// and head dims between multiples of 64, and biased launches at 96 < D <=
// 128, whose register instance spilled; no path launches any of them (the
// VAE's unbiased d = 512 sites take flash_fwd_wide_wgmma_kernel,
// flash_attn_fwd_wide_sm90.cu). O (64 rows x 512 f32 = 128 KB) cannot sit in one warp's
// registers, so it is split by columns across 8 warps, 64 columns each, in
// registers. S and P are computed once a 32-key tile and shared through
// shared memory (each warp one 16 x 16 piece of S; 4 lanes a row for the
// softmax), with the row rescale; K/V tiles come in by cp.async one tile
// ahead. Three barriers a tile.
//
// The f32 instances at D <= 128 (flash_fwd_tf32_kernel) multiply in TF32,
// every operand rounded to nearest (cvt.rna: Q, K, the probabilities P and
// V) with f32 accumulation, as `attention_reference_tf32` does. They carry
// stage 6 (ViT-B, VideoMAE and CLIP ViT-L at d = 64: [1,12,197,197],
// [1,12,588,588] and [6,16,257,257], 360 launches a scored clip), stage e
// and the stage-2 seg panels (the DecoderVideo at d = 128, 64 and 32 over
// 256, 1024 and 4096 tokens) and the f32 training checks (the prior's
// biased multi-query lse forward at d = 52). The design is the bf16
// register kernel's on m16n8k8: 4 warps of 16 query rows, Q rounded once
// and held as A fragments, K and V in a 2-stage cp.async ring (one barrier
// a tile) and rounded there once a tile, S, P and O in registers. P's C fragment is not the TF32 A
// layout, so the P V product sums over keys in a permuted order (A's k
// index t is key 2t, t + 4 is key 2t + 1; mma_sm80.cuh): P goes from S's
// registers into A without a shuffle, and V's B fragments are scalar reads
// of rows 2t and 2t + 1. Key tiles are 64 keys, 32 at d = 128, where Q
// (64 registers) and O (64) leave room for no more of S; D is padded to
// 32, 64 or 128 (the f32 head dims launched) in shared memory only.
//
// The f32 instances at 128 < D <= 512 (flash_fwd_wide_tf32_kernel) carry
// the VAE's d = 512 mid attention in f32: the autoencoder trainer's
// [4, 1, 1024, 1024, 512] (with lse under autograd, plain in the
// discriminator step) and precompute's VAE encoder, [16, 1, 784, 784,
// 512]. The same TF32 contract (every operand rounded by cvt.rna, f32
// sums, the JAX lse with the accurate expf). At 512 columns in f32 a row
// of Q, K or V is 2 KB, so neither 64 rows of Q nor O (64 x 512 f32 = 128
// KB) fits one warp's registers, and 64-row blocks would leave half the
// card idle (64 blocks at the trainer's shape). The design: 32 query rows
// a block (128 blocks there, 400 at precompute's), 8 warps, each owning 64
// columns of D for all 32 rows: its slice of Q held as A fragments and of
// O as an f32 register accumulator. S = Q K^T is split by depth the same
// way: each warp multiplies its 64 columns and writes a [32 x 16] partial,
// and the partials are summed through shared memory in warp order (a
// fixed order, so a rerun gives equal bits) by the threads that then run
// the online softmax, 8 lanes a row; P goes back to every warp through
// shared memory. K and V tiles of 16 keys come through a 3-stage cp.async
// ring two tiles ahead (Q is staged once in its last stage: 198 KB of
// ring, 24 KB of partials); each warp reads only its own columns of a
// tile, so its B fragments are rounded in registers. Two barriers a tile.
// What bounds it: 4 Tq Tk D operations (8.6 GFLOP at the trainer's shape,
// 17.4 us at 495 TF32 TFLOP/s) against 33.6 MB of device memory (10.0 us
// at 3.35 TB/s), so operations. What the design runs into first is the
// traffic from L2: each 32-row block streams its head's whole K and V (4
// MB at the trainer's shape, 0.54 GB over the launch, 1.28 GB at
// precompute's), and the two launches moved it at 2.8 and 2.3 TB/s (0.195
// and 0.562 ms, H100 SXM at 700 W, against 0.283 and 0.729 for PyTorch's
// fused attention). The 32 rows a block are what the registers
// holding Q and O allow; a cluster sharing each tile by multicast would
// cut the traffic.
//
// The first design (flash_fwd_kernel: one block of 4 warps per (b, h) and
// query tile, WMMA products, S, P and the f32 O accumulator in shared
// memory, BQ x BK the largest pair whose tiles fit the 227 KB a block may
// use) is now the route only for D past 512, bf16 or f32; no path
// launches it.
//
// What bounds it on an H100: at the clip's shapes attention does 4 Tq Tk D
// operations against (2 Tq + 2 Tk) D esize bytes, so all but the short
// cross-attention sites are bound by operations (989 TFLOP/s bf16 dense,
// 495 TF32, against 3.35 TB/s). At stage 6's f32 shapes the bound is a
// microsecond or two a launch, under a launch's own cost; grids of 48-480
// blocks fill at most a few waves of 132 SMs, so each block's serial walk
// over its key tiles sets the time, and the ring, the registers and one
// barrier a tile shorten that walk. Every warp reads all of a K and V tile
// from shared memory (the bytes of one m16n8k8 B fragment feed 16 rows),
// which bounds the f32 products as it does the bf16 ones. mma.sync reaches
// a part of the wgmma peak; the measured times stand in PERF.md.

#include "flash_common.cuh"
#include "mma_sm80.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* bias;            // [N, Tq, Tk] or null
  float* lse;                  // [B*H, Tq] or null
  long long q_sb, q_sh, q_st;  // element strides over batch, head, token
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long bias_sn, bias_sq;  // bias strides over slice and query row
  int bias_mode;               // see bias_slice()
  int H, Tq, Tk, D, DP;        // DP: D rounded up to 16
  int bq, bk;
  float scale;
  int vec;                     // bytes a row moves in (16, 8, 4; 0: elements)
};

// Shared-memory bytes of one block; the kernel carves its buffers in the
// same order.
__host__ __device__ inline size_t smem_bytes(int bq, int bk, int dp,
                                             int esize) {
  const int skew = esize == 2 ? 8 : 4;
  const size_t ldt = dp + skew, lds = bk + 4, ldp = bk + skew, ldo = dp + 4;
  return align128((size_t)esize * bq * ldt)        // Q
         + 2 * align128((size_t)esize * bk * ldt)  // K, V
         + align128(4 * (size_t)bq * lds)          // S (f32 logits)
         + align128((size_t)esize * bq * ldp)      // P
         + align128(4 * (size_t)bq * ldo)          // O (f32 accumulator)
         + 2 * align128(4 * (size_t)bq);           // row max, row sum
}

// kBias, kLse: the launch adds a bias, writes the log-sum-exp. Both are
// template switches, so the inference instance (neither) carries no code of
// the training one. The lse instance takes the accurate expf, so that the
// lse stays within the plain version's f32 error (the fast __expf left it
// up to 1.4x worse); inference keeps __expf.
template <typename T, bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using M = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int BQ = p.bq, BK = p.bk, DP = p.DP, D = p.D;
  const int ldt = DP + M::kSkew, lds = BK + 4, ldp = BK + M::kSkew,
            ldo = DP + 4;

  unsigned char* cur = smem;
  T* sQ = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldt);
  T* sK = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  T* sV = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  float* sS = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * lds);
  T* sP = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldp);
  float* sO = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * ldo);
  float* sM = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ);
  float* sL = reinterpret_cast<float*>(cur);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (p.Tq + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + (long long)bh * p.Tq * D;
  const T* bg = kBias ? static_cast<const T*>(p.bias)
                            + bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                      : nullptr;

  load_tile(sQ, qg, p.q_st, q0, p.Tq, BQ, D, DP, ldt, p.vec);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += BK) {
    load_tile(sK, kg, p.k_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
    load_tile(sV, vg, p.v_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
    __syncthreads();

    // S = Q K^T, one 16x16 tile per warp step
    const int s_cols = BK / 16;
    for (int t = warp; t < (BQ / 16) * s_cols; t += kWarps) {
      const int r0 = (t / s_cols) * 16, c0 = (t % s_cols) * 16;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP; kk += M::K) {
        typename M::A a;
        typename M::BCol bk;
        wmma::load_matrix_sync(a, sQ + r0 * ldt + kk, ldt);
        wmma::load_matrix_sync(bk, sK + c0 * ldt + kk, ldt);
        M::to_tf32(a);
        M::to_tf32(bk);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(sS + r0 * lds + c0, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: one warp per row, lanes across the tile's keys
    for (int r = warp; r < BQ; r += kWarps) {
      const float m_old = sM[r];
      // bias row of this query (padded rows carry none; they are not written)
      const T* brow = (kBias && q0 + r < p.Tq) ? bg + (q0 + r) * p.bias_sq
                                               : nullptr;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        float s = (k0 + c < p.Tk) ? sS[r * lds + c] * p.scale : -INFINITY;
        if (kBias && brow && k0 + c < p.Tk) s += M::to_float(brow[k0 + c]);
        sS[r * lds + c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float x = sS[r * lds + c] - m_new;
        const float e = kLse ? expf(x) : __expf(x);
        sP[r * ldp + c] = M::from_float(e);
        sum += e;
      }
      sum = warp_sum(sum);
      const float alpha = kLse ? expf(m_old - m_new) : __expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
      for (int d = lane; d < DP; d += 32) sO[r * ldo + d] *= alpha;
    }
    __syncthreads();

    // O += P V
    const int o_cols = DP / 16;
    for (int t = warp; t < (BQ / 16) * o_cols; t += kWarps) {
      const int r0 = (t / o_cols) * 16, c0 = (t % o_cols) * 16;
      typename M::Acc acc;
      wmma::load_matrix_sync(acc, sO + r0 * ldo + c0, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += M::K) {
        typename M::A a;
        typename M::BRow bv;
        wmma::load_matrix_sync(a, sP + r0 * ldp + kk, ldp);
        wmma::load_matrix_sync(bv, sV + kk * ldt + c0, ldt);
        M::to_tf32(a);
        M::to_tf32(bv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + r0 * ldo + c0, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < p.Tq)
      og[(long long)(q0 + r) * D + d] = M::from_float(sO[r * ldo + d] / sL[r]);
  }
  if (kLse) {
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      if (q0 + r < p.Tq)
        p.lse[(long long)bh * p.Tq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 at D <= 128: S, P and O in registers, K/V pipelined

constexpr int kRBQ = 64, kRBK = 64;  // query rows a block, keys a tile
constexpr int kRThreads = 128;       // 4 warps, 16 query rows each

template <int DK>  // the head dim padded to 16 (QK depth), in shared memory
struct RegCfg {
  static constexpr int LD = DK + 8;  // row stride in elements: a 16-byte skew,
                                     // so 8 rows at one column hit 8 banks
  static constexpr int kTile = kRBK * LD * 2;  // one K or V tile, bytes
  static constexpr int kSmem = 5 * kTile;      // Q, then K and V x 2 stages
  static constexpr int KS = DK / 16;           // k16 steps of Q K^T
  static constexpr int NO = DK / 8;            // n8 tiles of O at most
};

// The block: 64 query rows of one (b, h), 4 warps of 16 rows. Q's A
// fragments are loaded once into registers; per 64-key tile a warp computes
// S = Q K^T into registers (mma.sync m16n8k16, f32), updates the row max
// and sum with quad shuffles, turns P into bf16 A fragments in place (the C
// layout of S is the A layout of P) and adds P V into its f32 O
// accumulator. The next tile's K and V come in by cp.async while these
// products run: one barrier a tile. kBias, kLse as flash_fwd_kernel.
template <int DK, bool kBias, bool kLse>
__global__ void __launch_bounds__(kRThreads)
flash_fwd_reg_kernel(Params p) {
  using C = RegCfg<DK>;
  constexpr int LD = C::LD;
  constexpr bool kRolled = !(kBias || kLse);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kRBK * LD;      // [2][64][LD]
  __nv_bfloat16* sV = sK + 2 * kRBK * LD;  // [2][64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kRBQ - 1) / kRBQ;
  const int q0 = (blockIdx.x % nq) * kRBQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (long long)bh * p.Tq * D;
  const __nv_bfloat16* bg =
      kBias ? static_cast<const __nv_bfloat16*>(p.bias) +
                  bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
            : nullptr;
  const int ntiles = (p.Tk + kRBK - 1) / kRBK;

  stage_rows_any<kRBK, DK, kRThreads, kRolled>(p.vec, sQ, qg, p.q_st, q0, p.Tq, D);
  stage_rows_any<kRBK, DK, kRThreads, kRolled>(p.vec, sK, kg, p.k_st, 0, p.Tk, D);
  stage_rows_any<kRBK, DK, kRThreads, kRolled>(p.vec, sV, vg, p.v_st, 0, p.Tk, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t q_addr =
      smem_addr(sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  uint32_t qf[C::KS][4];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) ldmatrix_x4(qf[ks], q_addr + ks * 32);

  float o[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int nv8 = (D + 7) / 8;  // O's n8 tiles: the real D, not DK
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8

  for (int t = 0; t < ntiles; ++t) {
    const int stg = t & 1;
    if (t + 1 < ntiles) {
      stage_rows_any<kRBK, DK, kRThreads, kRolled>(p.vec, sK + (stg ^ 1) * kRBK * LD, kg, p.k_st,
                         (t + 1) * kRBK, p.Tk, D);
      stage_rows_any<kRBK, DK, kRThreads, kRolled>(p.vec, sV + (stg ^ 1) * kRBK * LD, vg, p.v_st,
                         (t + 1) * kRBK, p.Tk, D);
    }
    cp_async_commit();
    const int k0 = t * kRBK;

    // this thread's bias pairs, loaded ahead of the products where the
    // registers allow (d <= 64: the prior); wider instances read them in
    // the softmax
    constexpr bool kPrefetch = kBias && DK <= 64;
    uint32_t bpk[8][2];
    if (kPrefetch) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r, key = k0 + j * 8 + (lane & 3) * 2;
          unsigned short lo = 0, hi = 0;
          if (row < p.Tq) {
            const unsigned short* br = reinterpret_cast<const unsigned short*>(
                bg + (long long)row * p.bias_sq);
            if (key < p.Tk) lo = br[key];
            if (key + 1 < p.Tk) hi = br[key + 1];
          }
          bpk[j][r] = (uint32_t)lo | ((uint32_t)hi << 16);
        }
    }

    // S = Q K^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const __nv_bfloat16* kt = sK + stg * kRBK * LD;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                 ks * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jp], qf[ks], r);
        mma_bf16(s[2 * jp + 1], qf[ks], r + 2);
      }

    // online softmax over the tile's keys, rows row_a and row_a + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (kPrefetch) {
          x += __uint_as_float((e & 1) ? (bpk[j][e >> 1] & 0xffff0000u)
                                       : (bpk[j][e >> 1] << 16));
        } else if (kBias && row_a + 8 * (e >> 1) < p.Tq && key < p.Tk) {
          x += __bfloat162float(bg[(long long)(row_a + 8 * (e >> 1)) * p.bias_sq + key]);
        }
        if (key >= p.Tk) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      msafe[r] = mn == -INFINITY ? 0.f : mn;  // a row with no finite logit
      alpha[r] = kLse ? expf(m[r] - msafe[r]) : __expf(m[r] - msafe[r]);
      m[r] = mn;
    }
    uint32_t pf[4][4];  // P as the A fragments of 4 k16 steps
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] - msafe[e >> 1];
        e4[e] = kLse ? expf(x) : __expf(x);
      }
      rs[0] += e4[0] + e4[1];
      rs[1] += e4[2] + e4[3];
      pf[j >> 1][(j & 1) * 2] = pack_bf16(e4[0], e4[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e4[2], e4[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this
                                                                 // thread's keys
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over the real head dim's n8 tiles
    const __nv_bfloat16* vt = sV + stg * kRBK * LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < C::NO / 2; ++np) {
        if (2 * np >= nv8) continue;
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(vt + (kk * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * LD +
                                       (np * 2 + (lane >> 4)) * 8));
        mma_bf16(o[2 * np], pf[kk], r);
        if (2 * np + 1 < nv8) mma_bf16(o[2 * np + 1], pf[kk], r + 2);
      }

    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.Tq) continue;
    __nv_bfloat16* orow = og + (long long)row * D;
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      if (n >= nv8 || col >= D) continue;
      const float v0 = o[n][2 * r] / l[r], v1 = o[n][2 * r + 1] / l[r];
      if (col + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        orow[col] = __float2bfloat16(v0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
      }
    }
    if (kLse && (lane & 3) == 0)
      p.lse[(long long)bh * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// The padded head dim of the register kernel's instance for D, 0 when D is
// past 128 or, with a bias, past 96: the biased d = 128 instances spilled
// registers, so such launches (none on the paths) take the wide kernel.
inline int reg_dk(int D, bool bias = false) {
  if (bias && D > 96) return 0;
  return D <= 32 ? 32 : D <= 48 ? 48 : D <= 64 ? 64 : D <= 80 ? 80
       : D <= 96 ? 96 : D <= 128 ? 128 : 0;
}

inline int reg_smem(int dk) { return 5 * kRBK * (dk + 8) * 2; }

template <int DK, bool kBias, bool kLse>
cudaError_t launch_reg_as(Params p, int B, cudaStream_t stream) {
  const int smem = RegCfg<DK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_reg_kernel<DK, kBias, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + kRBQ - 1) / kRBQ) * B * p.H;
  flash_fwd_reg_kernel<DK, kBias, kLse><<<(unsigned)blocks, kRThreads, smem,
                                          stream>>>(p);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_reg_dk(Params p, int B, cudaStream_t stream) {
  if constexpr (DK < 128) {
    if (p.bias)
      return p.lse ? launch_reg_as<DK, true, true>(p, B, stream)
                   : launch_reg_as<DK, true, false>(p, B, stream);
  }
  return p.lse ? launch_reg_as<DK, false, true>(p, B, stream)
               : launch_reg_as<DK, false, false>(p, B, stream);
}

cudaError_t launch_reg(Params p, int B, cudaStream_t stream) {
  switch (reg_dk(p.D, p.bias != nullptr)) {
    case 32: return launch_reg_dk<32>(p, B, stream);
    case 48: return launch_reg_dk<48>(p, B, stream);
    case 64: return launch_reg_dk<64>(p, B, stream);
    case 80: return launch_reg_dk<80>(p, B, stream);
    case 96: return launch_reg_dk<96>(p, B, stream);
    case 128: return launch_reg_dk<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32 (TF32) at D <= 128: S, P and O in registers, K/V pipelined

constexpr int kTBQ = 64;         // query rows a block
constexpr int kTThreads = 128;   // 4 warps, 16 query rows each

template <int DK>  // the head dim padded to 8 (QK depth): 32, 64 or 128
struct Tf32Cfg {
  // keys a tile: 64, or 32 at DK = 128, where Q's fragments (64 registers)
  // and O (64) leave S room for 32 keys only
  static constexpr int BK = DK <= 64 ? 64 : 32;
  // row stride in floats, 4 x an odd number: the K fragments' ldmatrix
  // phases (8 rows of 16 bytes) and the V fragments' scalar reads (rows 2t,
  // column g) each hit 32 distinct banks
  static constexpr int LD = DK + 4;
  // K/V tiles in flight: two ahead of the one in use, so a tile's copy has
  // two tiles' products to arrive in (the grids are a wave or less, so a
  // block's walk over its tiles sets the time); 2 blocks an SM at DK >= 64
  static constexpr int kStages = 3;
  static constexpr int kTile = BK * LD;           // floats of a K or V tile
  static constexpr int kSmem = kStages * 2 * kTile * 4;  // bytes
  static constexpr int KS = DK / 8;               // k8 steps of Q K^T
  static constexpr int NS = BK / 8;               // n8 tiles of S
  static constexpr int NO = DK / 8;               // n8 tiles of O
  // copies a thread rounds at once: all of them at DK <= 64 (their loads
  // in flight together: ViT-B's launch took 15.3 us against 18.8 rounding
  // 4 at a time, H100), 4 at DK = 128, where all at once spilled
  static constexpr int kRoundBatch = DK <= 64 ? 32 : 4;
  static_assert(kTBQ * LD <= 2 * kTile, "Q is staged in the last stage");
  static_assert(KS % 2 == 0, "ldmatrix x4 reads two k8 steps of K");
};

// The block: 64 query rows of one (b, h), 4 warps of 16 rows. Q is staged
// once (in the ring's last stage, before its first fill), rounded to TF32
// and held as A fragments in registers. K and V tiles come in by cp.async
// through a 3-stage ring, two tiles ahead, and are rounded to TF32 in
// shared memory once a tile, each thread its own copies after its wait
// (not once by every warp that reads them); one barrier a tile. Per key
// tile a warp computes S = Q K^T into registers (mma.sync m16n8k8 TF32,
// f32; K's B fragments by ldmatrix), updates the row max and sum with quad
// shuffles, and adds P V into its f32 O accumulator: P's A fragments come
// from S's C registers by the key permutation of mma_sm80.cuh (a = c0, c2,
// c1, c3), so V's B fragments are scalar reads of rows 2t and 2t + 1, and
// P is rounded to TF32 in registers. kBias, kLse as flash_fwd_kernel.
template <int DK, bool kBias, bool kLse>
__global__ void __launch_bounds__(kTThreads)
flash_fwd_tf32_kernel(Params p) {
  using C = Tf32Cfg<DK>;
  constexpr int LD = C::LD, BK = C::BK, S = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // stage s: K, then V
  float* sQ = ring + (S - 1) * 2 * C::kTile;     // until tile S - 1 comes

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tl = lane & 3;
  const int nq = (p.Tq + kTBQ - 1) / kTBQ;
  const int q0 = (blockIdx.x % nq) * kTBQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + (long long)bh * p.Tq * D;
  const float* bg = kBias ? static_cast<const float*>(p.bias) +
                                bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                          : nullptr;
  const int ntiles = (p.Tk + BK - 1) / BK;
  auto stage_kv = [&](int tile) {  // K and V of `tile` into its stage
    float* dst = ring + (tile % S) * 2 * C::kTile;
    stage_rows_f32<BK, DK, LD, kTThreads>(p.vec, dst, kg, p.k_st, tile * BK,
                                          p.Tk, D);
    stage_rows_f32<BK, DK, LD, kTThreads>(p.vec, dst + C::kTile, vg, p.v_st,
                                          tile * BK, p.Tk, D);
  };

  // copy groups: Q with tile 0, then one a tile (empty past the last), so
  // at tile t the wait for all but the newest S - 2 groups is tile t's
  stage_rows_f32<kTBQ, DK, LD, kTThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq, D);
  stage_kv(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < S - 1; ++i) {
    if (i < ntiles) stage_kv(i);
    cp_async_commit();
  }
  cp_async_wait_mem<S - 2>();
  __syncthreads();

  uint32_t qf[C::KS][4];
  {
    const float* qr = sQ + (warp * 16 + g) * LD + tl;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      qf[ks][0] = to_tf32(qr[ks * 8]);
      qf[ks][1] = to_tf32(qr[8 * LD + ks * 8]);
      qf[ks][2] = to_tf32(qr[ks * 8 + 4]);
      qf[ks][3] = to_tf32(qr[8 * LD + ks * 8 + 4]);
    }
  }

  float o[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;  // and row_a + 8
  // this lane's ldmatrix row: matrix lane / 8 is (k8 step lane / 16, half
  // (lane / 8) % 2) of 8 keys
  const int k_lane = (lane & 7) * LD + (lane >> 4) * 8 + ((lane >> 3) & 1) * 4;

  for (int t = 0; t < ntiles; ++t) {
    float* kt = ring + (t % S) * 2 * C::kTile;
    float* vt = kt + C::kTile;
    cp_async_wait_mem<S - 2>();  // this thread's copies of tile t are in
    round_rows_tf32_any<BK, DK, LD, kTThreads, C::kRoundBatch>(p.vec, kt);
    round_rows_tf32_any<BK, DK, LD, kTThreads, C::kRoundBatch>(p.vec, vt);
    // tile t is whole; every warp is done with tile t - 1 (and Q), whose
    // stage takes tile t + S - 1
    __syncthreads();
    if (t + S - 1 < ntiles) stage_kv(t + S - 1);
    cp_async_commit();
    const int k0 = t * BK;

    // S = Q K^T
    float s[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t k_addr = smem_addr(kt + k_lane);
#pragma unroll
    for (int ks = 0; ks < C::KS; ks += 2) {
      uint32_t r[C::NS][4];  // K as rounded in shared memory: two k8 steps
#pragma unroll
      for (int j = 0; j < C::NS; ++j)
        ldmatrix_x4(r[j], k_addr + (j * 8 * LD + ks * 8) * 4);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        mma_tf32(s[j], qf[ks], r[j]);
        mma_tf32(s[j], qf[ks + 1], r[j] + 2);
      }
    }

    // online softmax over the tile's keys, rows row_a and row_a + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tl * 2 + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        float x = s[j][e] * p.scale;
        if (kBias && row < p.Tq && key < p.Tk)
          x += bg[(long long)row * p.bias_sq + key];
        if (key >= p.Tk) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      msafe[r] = mn == -INFINITY ? 0.f : mn;  // a row with no finite logit
      alpha[r] = kLse ? expf(m[r] - msafe[r]) : __expf(m[r] - msafe[r]);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] - msafe[e >> 1];
        s[j][e] = kLse ? expf(x) : __expf(x);  // P, unnormalised
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this
                                                                 // thread's keys
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over DK's n8 tiles (V is zero past D: no branch in the
    // loop, which would serialise each load behind the last product); k8
    // step j is S's n8 tile j, its index t standing for key 2t and t + 4
    // for key 2t + 1
    // (V's fragments in groups of up to 8 n8 tiles: 16 registers at most)
    constexpr int NG = C::NO < 8 ? C::NO : 8;
    const uint32_t v_addr = smem_addr(vt + tl * 2 * LD + g);
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      const uint32_t a[4] = {to_tf32(s[j][0]), to_tf32(s[j][2]),
                             to_tf32(s[j][1]), to_tf32(s[j][3])};
#pragma unroll
      for (int n0 = 0; n0 < C::NO; n0 += NG) {
        uint32_t bv[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          bv[n][0] = lds_b32(v_addr + (j * 8 * LD + (n0 + n) * 8) * 4);
          bv[n][1] = lds_b32(v_addr + ((j * 8 + 1) * LD + (n0 + n) * 8) * 4);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_tf32(o[n0 + n], a, bv[n]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.Tq) continue;
    float* orow = og + (long long)row * D;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      const int col = n * 8 + tl * 2;
      if (col >= D) continue;
      const float v0 = o[n][2 * r] * inv, v1 = o[n][2 * r + 1] * inv;
      if (col + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        orow[col] = v0;
        if (col + 1 < D) orow[col + 1] = v1;
      }
    }
    if (kLse && tl == 0)
      p.lse[(long long)bh * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// The padded head dim of the TF32 register kernel's instance for D (the
// f32 head dims the paths launch: 32; 52 and 64; 128), 0 past 128.
inline int tf32_dk(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

template <int DK, bool kBias, bool kLse>
cudaError_t launch_tf32_as(Params p, int B, cudaStream_t stream) {
  const int smem = Tf32Cfg<DK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<DK, kBias, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + kTBQ - 1) / kTBQ) * B * p.H;
  flash_fwd_tf32_kernel<DK, kBias, kLse><<<(unsigned)blocks, kTThreads, smem,
                                           stream>>>(p);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_tf32_dk(Params p, int B, cudaStream_t stream) {
  if (p.bias)
    return p.lse ? launch_tf32_as<DK, true, true>(p, B, stream)
                 : launch_tf32_as<DK, true, false>(p, B, stream);
  return p.lse ? launch_tf32_as<DK, false, true>(p, B, stream)
               : launch_tf32_as<DK, false, false>(p, B, stream);
}

cudaError_t launch_tf32(Params p, int B, cudaStream_t stream) {
  switch (tf32_dk(p.D)) {
    case 32: return launch_tf32_dk<32>(p, B, stream);
    case 64: return launch_tf32_dk<64>(p, B, stream);
    case 128: return launch_tf32_dk<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 at 128 < D <= 512 (and biased at 96 < D <= 128): O split by columns
// across 8 warps

constexpr int kWBQ = 64, kWBK = 32;  // query rows a block, keys a tile
constexpr int kWThreads = 256;       // 8 warps
constexpr int kWDK = 512;            // the head dim padded in shared memory
constexpr int kWLD = kWDK + 8;
constexpr int kWLDS = kWBK + 1;      // f32 logits row
constexpr int kWLDP = kWBK + 8;      // bf16 probabilities row (80 bytes)
constexpr int kWQBytes = kWBQ * kWLD * 2;
constexpr int kWKVBytes = kWBK * kWLD * 2;
constexpr int kWSmem = kWQBytes + 4 * kWKVBytes + kWBQ * kWLDS * 4 +
                       kWBQ * kWLDP * 2 + 3 * kWBQ * 4;

// The block: 64 query rows of one (b, h), 8 warps, K/V tiles of 32 keys in
// a 2-stage cp.async ring. Per tile: S = Q K^T with each warp one 16 x 16
// piece over the whole depth (Q and K from shared memory), written to
// shared memory as scaled (and biased) f32 logits; the online softmax with
// 4 lanes a row, which writes P in bf16, the rescale factor, and the row
// max and sum; then O += P V with each warp owning 64 columns of O for all
// 64 rows in f32 registers (O cannot sit in one warp's registers at d =
// 512). S and P are computed once a tile and shared; three barriers a tile.
template <bool kBias, bool kLse>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fwd_wide_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + kWQBytes);
  __nv_bfloat16* sV = sK + 2 * kWBK * kWLD;
  float* sS = reinterpret_cast<float*>(smem + kWQBytes + 4 * kWKVBytes);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + kWBQ * kWLDS);
  float* sAlpha = reinterpret_cast<float*>(sP + kWBQ * kWLDP);
  float* sM = sAlpha + kWBQ;
  float* sL = sM + kWBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kWBQ - 1) / kWBQ;
  const int q0 = (blockIdx.x % nq) * kWBQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const int ksteps = (D + 15) / 16;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (long long)bh * p.Tq * D;
  const __nv_bfloat16* bg =
      kBias ? static_cast<const __nv_bfloat16*>(p.bias) +
                  bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
            : nullptr;
  const int ntiles = (p.Tk + kWBK - 1) / kWBK;

  stage_rows_any<kWBQ, kWDK, kWThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq, D);
  stage_rows_any<kWBK, kWDK, kWThreads>(p.vec, sK, kg, p.k_st, 0, p.Tk, D);
  stage_rows_any<kWBK, kWDK, kWThreads>(p.vec, sV, vg, p.v_st, 0, p.Tk, D);
  cp_async_commit();
  for (int r = threadIdx.x; r < kWBQ; r += kWThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's O: columns 64 * warp .. + 63 (8 n8 tiles), 64 rows
  float o[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.f;
  const int col0 = warp * 64;
  const int nv8 = min(8, max(0, (D - col0 + 7) / 8));  // this warp's n8 tiles
  const int srow = (warp >> 1) * 16, skey = (warp & 1) * 16;  // S piece

  for (int t = 0; t < ntiles; ++t) {
    const int stg = t & 1;
    if (t + 1 < ntiles) {
      stage_rows_any<kWBK, kWDK, kWThreads>(p.vec, sK + (stg ^ 1) * kWBK * kWLD,
                                            kg, p.k_st, (t + 1) * kWBK, p.Tk, D);
      stage_rows_any<kWBK, kWDK, kWThreads>(p.vec, sV + (stg ^ 1) * kWBK * kWLD,
                                            vg, p.v_st, (t + 1) * kWBK, p.Tk, D);
    }
    cp_async_commit();
    const int k0 = t * kWBK;

    // S piece: rows srow.., keys skey.. (2 n8 tiles)
    {
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const __nv_bfloat16* kt = sK + stg * kWBK * kWLD;
      const uint32_t qa = smem_addr(sQ + (srow + (lane & 15)) * kWLD + (lane >> 4) * 8);
      const uint32_t ka = smem_addr(kt + (skey + (lane & 7) + (lane >> 4) * 8) * kWLD +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[4], r[4];
        ldmatrix_x4(a, qa + ks * 32);
        ldmatrix_x4(r, ka + ks * 32);
        mma_bf16(sacc[0], a, r);
        mma_bf16(sacc[1], a, r + 2);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = srow + (lane >> 2) + (e >> 1) * 8;
          const int kl = skey + j * 8 + (lane & 3) * 2 + (e & 1);
          float x = sacc[j][e] * p.scale;
          if (kBias && q0 + row < p.Tq && k0 + kl < p.Tk)
            x += __bfloat162float(bg[(long long)(q0 + row) * p.bias_sq + k0 + kl]);
          if (k0 + kl >= p.Tk) x = -INFINITY;
          sS[row * kWLDS + kl] = x;
        }
    }
    __syncthreads();

    // online softmax: rows 8 * warp .., 4 lanes a row, 8 keys a lane
    {
      const int row = warp * 8 + (lane >> 2), c0 = (lane & 3) * 8;
      float x[8], mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        x[c] = sS[row * kWLDS + c0 + c];
        mx = fmaxf(mx, x[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[row], mn = fmaxf(m_old, mx);
      const float msafe = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
      uint32_t pk[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const float e0 = kLse ? expf(x[c] - msafe) : __expf(x[c] - msafe);
        const float e1 = kLse ? expf(x[c + 1] - msafe) : __expf(x[c + 1] - msafe);
        sum += e0 + e1;
        pk[c / 2] = pack_bf16(e0, e1);
      }
      *reinterpret_cast<uint4*>(sP + row * kWLDP + c0) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((lane & 3) == 0) {
        const float alpha = kLse ? expf(m_old - msafe) : __expf(m_old - msafe);
        sAlpha[row] = alpha;
        sM[row] = mn;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncthreads();

    // O += P V on this warp's columns
    if (nv8 > 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float a0 = sAlpha[mi * 16 + (lane >> 2)];
        const float a1 = sAlpha[mi * 16 + (lane >> 2) + 8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[mi][n][0] *= a0;
          o[mi][n][1] *= a0;
          o[mi][n][2] *= a1;
          o[mi][n][3] *= a1;
        }
      }
      const __nv_bfloat16* vt = sV + stg * kWBK * kWLD;
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(a[mi], smem_addr(sP + (mi * 16 + (lane & 15)) * kWLDP +
                                       kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np >= nv8) continue;
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_addr(vt + (kk * 16 + (lane & 7) +
                                               ((lane >> 3) & 1) * 8) * kWLD +
                                         col0 + (np * 2 + (lane >> 4)) * 8));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(o[mi][2 * np], a[mi], r);
            if (2 * np + 1 < nv8) mma_bf16(o[mi][2 * np + 1], a[mi], r + 2);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = mi * 16 + (lane >> 2) + 8 * r, row = q0 + rl;
      if (row >= p.Tq) continue;
      const float l = sL[rl];
      __nv_bfloat16* orow = og + (long long)row * D;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = col0 + n * 8 + (lane & 3) * 2;
        if (n >= nv8 || col >= D) continue;
        const float v0 = o[mi][n][2 * r] / l, v1 = o[mi][n][2 * r + 1] / l;
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16(v0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  if (kLse)
    for (int r = threadIdx.x; r < kWBQ; r += kWThreads)
      if (q0 + r < p.Tq)
        p.lse[(long long)bh * p.Tq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

template <bool kBias, bool kLse>
cudaError_t launch_wide_as(Params p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<kBias, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + kWBQ - 1) / kWBQ) * B * p.H;
  flash_fwd_wide_kernel<kBias, kLse><<<(unsigned)blocks, kWThreads, kWSmem,
                                       stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wide(Params p, int B, cudaStream_t stream) {
  if (p.bias)
    return p.lse ? launch_wide_as<true, true>(p, B, stream)
                 : launch_wide_as<true, false>(p, B, stream);
  return p.lse ? launch_wide_as<false, true>(p, B, stream)
               : launch_wide_as<false, false>(p, B, stream);
}

inline bool wide_fits() { return max_block_smem() >= kWSmem; }

// ---------------------------------------------------------------------------
// f32 (TF32) at 128 < D <= 512: O and the depth of S = Q K^T split by
// columns across 8 warps

constexpr int kXBQ = 32, kXBK = 16;  // query rows a block, keys a tile
constexpr int kXThreads = 256;       // 8 warps, 64 columns of D each
constexpr int kXDK = 512;            // the head dim padded in shared memory
// row stride in floats, 4 x an odd number: K's ldmatrix phases (8 rows of
// 16 bytes) and V's scalar reads (rows 2t, column g) each hit 32 banks
constexpr int kXLD = kXDK + 4;
constexpr int kXStages = 3;          // K/V tiles in flight: two ahead
constexpr int kXTile = kXBK * kXLD;  // floats of a K or V tile
// row stride of the S partials and of P: rows r and r + 2 fall 16 banks
// apart, so the reduction's float2 reads and the C fragments' float2
// writes each take one pass a half-warp
constexpr int kXLDS = kXBK + 8;
constexpr int kXWarps = kXThreads / 32;
constexpr int kXSmem = 4 * (kXStages * 2 * kXTile         // the K/V ring
                            + kXWarps * kXBQ * kXLDS      // S partials
                            + kXBQ * kXLDS + 2 * kXBQ);   // P, alpha, l
static_assert(kXBQ * kXLD <= 2 * kXTile, "Q is staged in the last stage");
static_assert(kXWarps * 64 == kXDK, "64 columns a warp");

// The block: 32 query rows of one (b, h), 8 warps, warp w owning columns
// 64w .. 64w + 63 of D. Q is staged once (in the ring's last stage) and
// held as TF32 A fragments of the warp's 64 columns (2 m16 tiles x 8 k8
// steps, 64 registers); O is the warp's [32 x 64] f32 register
// accumulator (64 registers). K and V tiles of 16 keys come through a
// 3-stage cp.async ring, two tiles ahead; each warp reads only its own 64
// columns of them, so their B fragments are rounded to TF32 in registers
// as they are loaded (each element once). Per key tile: each warp adds its
// 64 columns' share of S = Q K^T (mma.sync m16n8k8, K by ldmatrix) and
// writes the [32 x 16] partial to shared memory; after a barrier, every
// thread sums one row's two keys over the warps in warp order (a fixed
// order: a rerun gives equal bits), scales and biases them, and runs the
// online softmax with the row's 8 lanes (3 shuffles), writing P rounded to
// TF32 and the row's rescale factor; after a second barrier (which also
// publishes the next K/V tile) each warp rescales O and adds P V on its 64
// columns, P's A fragments read as (keys 2t, 2t + 1) pairs, V's B
// fragments as rows 2t and 2t + 1 (the key permutation of mma_sm80.cuh).
// Two barriers a tile. Warps whose columns lie past D (D < 449) sit out
// the products. kBias, kLse as flash_fwd_kernel.
template <bool kBias, bool kLse>
__global__ void __launch_bounds__(kXThreads, 1)
flash_fwd_wide_tf32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // stage s: K, then V
  float* sQ = ring + (kXStages - 1) * 2 * kXTile;  // until tile 2 comes
  float* sPart = ring + kXStages * 2 * kXTile;     // [warp][32][kXLDS]
  float* sP = sPart + kXWarps * kXBQ * kXLDS;      // [32][kXLDS]
  float* sAlpha = sP + kXBQ * kXLDS;
  float* sL = sAlpha + kXBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tl = lane & 3;
  const int nq = (p.Tq + kXBQ - 1) / kXBQ;
  const int q0 = (blockIdx.x % nq) * kXBQ;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + (long long)bh * p.Tq * D;
  const int ntiles = (p.Tk + kXBK - 1) / kXBK;
  const int nw = (D + 63) / 64;  // warps whose columns hold D
  const bool active = warp < nw;
  const int col0 = warp * 64;
  auto stage_kv = [&](int tile) {  // K and V of `tile` into its stage
    float* dst = ring + (tile % kXStages) * 2 * kXTile;
    stage_rows_f32<kXBK, kXDK, kXLD, kXThreads>(p.vec, dst, kg, p.k_st,
                                                tile * kXBK, p.Tk, D);
    stage_rows_f32<kXBK, kXDK, kXLD, kXThreads>(p.vec, dst + kXTile, vg,
                                                p.v_st, tile * kXBK, p.Tk, D);
  };

  // copy groups: Q with tile 0, tile 1, then one a tile (empty past the
  // last), so at tile t the wait for all but the newest group is tile t + 1
  stage_rows_f32<kXBQ, kXDK, kXLD, kXThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq,
                                              D);
  stage_kv(0);
  cp_async_commit();
  if (ntiles > 1) stage_kv(1);
  cp_async_commit();
  cp_async_wait_mem<1>();
  __syncthreads();

  uint32_t qf[2][8][4];  // this warp's columns of Q: 2 m16 tiles x 8 k8 steps
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float* x = sQ + (mi * 16 + g) * kXLD + col0 + ks * 8 + tl;
      qf[mi][ks][0] = to_tf32(x[0]);
      qf[mi][ks][1] = to_tf32(x[8 * kXLD]);
      qf[mi][ks][2] = to_tf32(x[4]);
      qf[mi][ks][3] = to_tf32(x[8 * kXLD + 4]);
    }
  float o[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.f;

  // the softmax's share of this thread: row rr, keys rc and rc + 1 of a
  // tile. Warp w takes rows 4w .. 4w + 3, a half-warp rows r and r + 2;
  // a row's 8 lanes share bits 3 and 4 of the lane
  const int rr = 4 * warp + ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1);
  const int rc = 2 * (lane & 7);
  const float* brow = nullptr;
  if (kBias && q0 + rr < p.Tq)
    brow = static_cast<const float*>(p.bias) +
           bias_slice(p.bias_mode, bh, p.H) * p.bias_sn +
           (long long)(q0 + rr) * p.bias_sq;
  float m_run = -INFINITY, l_run = 0.f;
  // this lane's ldmatrix row of K: matrix lane / 8 is (k8 step lane / 16,
  // half (lane / 8) % 2) of 8 keys
  const int k_lane = (lane & 7) * kXLD + col0 + (lane >> 4) * 8 +
                     ((lane >> 3) & 1) * 4;

  for (int t = 0; t < ntiles; ++t) {
    const float* kt = ring + (t % kXStages) * 2 * kXTile;
    const float* vt = kt + kXTile;
    const int k0 = t * kXBK;

    // this warp's share of S: its 64 columns of the depth
    if (active) {
      float s[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
      const uint32_t k_addr = smem_addr(kt + k_lane);
#pragma unroll
      for (int ks = 0; ks < 8; ks += 2) {
        uint32_t r[2][4];  // K, rounded here: two k8 steps of 8 keys
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ldmatrix_x4(r[j], k_addr + (j * 8 * kXLD + ks * 8) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) r[j][e] = to_tf32(__uint_as_float(r[j][e]));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_tf32(s[mi][j], qf[mi][ks], r[j]);
            mma_tf32(s[mi][j], qf[mi][ks + 1], r[j] + 2);
          }
      }
      float* part = sPart + warp * kXBQ * kXLDS + g * kXLDS + 2 * tl;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<float2*>(part + mi * 16 * kXLDS + j * 8) =
              make_float2(s[mi][j][0], s[mi][j][1]);
          *reinterpret_cast<float2*>(part + (mi * 16 + 8) * kXLDS + j * 8) =
              make_float2(s[mi][j][2], s[mi][j][3]);
        }
    }
    // the partials are whole; every warp is done with tile t - 1 (and Q),
    // whose stage takes tile t + 2
    __syncthreads();
    if (t + kXStages - 1 < ntiles) stage_kv(t + kXStages - 1);
    cp_async_commit();

    // online softmax: the partials summed in warp order, row rr
    {
      const float* pr = sPart + rr * kXLDS + rc;
      float2 x = *reinterpret_cast<const float2*>(pr);
      for (int w = 1; w < nw; ++w) {
        const float2 y = *reinterpret_cast<const float2*>(pr + w * kXBQ * kXLDS);
        x.x += y.x;
        x.y += y.y;
      }
      const int key = k0 + rc;
      float s0 = x.x * p.scale, s1 = x.y * p.scale;
      if (kBias && brow) {
        if (key < p.Tk) s0 += brow[key];
        if (key + 1 < p.Tk) s1 += brow[key + 1];
      }
      if (key >= p.Tk) s0 = -INFINITY;
      if (key + 1 >= p.Tk) s1 = -INFINITY;
      float mx = fmaxf(s0, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m_run, mx);
      const float msafe = mn == -INFINITY ? 0.f : mn;  // no finite logit yet
      const float alpha = kLse ? expf(m_run - msafe) : __expf(m_run - msafe);
      const float e0 = kLse ? expf(s0 - msafe) : __expf(s0 - msafe);
      const float e1 = kLse ? expf(s1 - msafe) : __expf(s1 - msafe);
      float rs = e0 + e1;
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_run = l_run * alpha + rs;
      m_run = mn;
      *reinterpret_cast<float2*>(sP + rr * kXLDS + rc) = make_float2(
          __uint_as_float(to_tf32(e0)), __uint_as_float(to_tf32(e1)));
      if ((lane & 7) == 0) sAlpha[rr] = alpha;
    }
    cp_async_wait_mem<1>();  // this thread's copies of tile t + 1 are in
    // P and the row factors are whole, and so is tile t + 1
    __syncthreads();

    // O = O * alpha + P V on this warp's 64 columns
    if (active) {
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = sAlpha[8 * i + g];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[mi][n][0] *= al[2 * mi];
          o[mi][n][1] *= al[2 * mi];
          o[mi][n][2] *= al[2 * mi + 1];
          o[mi][n][3] *= al[2 * mi + 1];
        }
      const uint32_t v_addr = smem_addr(vt + 2 * tl * kXLD + col0 + g);
#pragma unroll
      for (int j = 0; j < kXBK / 8; ++j) {
        uint32_t a[2][4];  // P: A's k index t is key 2t, t + 4 is key 2t + 1
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float2 x0 = *reinterpret_cast<const float2*>(
              sP + (mi * 16 + g) * kXLDS + j * 8 + 2 * tl);
          const float2 x1 = *reinterpret_cast<const float2*>(
              sP + (mi * 16 + g + 8) * kXLDS + j * 8 + 2 * tl);
          a[mi][0] = __float_as_uint(x0.x);
          a[mi][1] = __float_as_uint(x1.x);
          a[mi][2] = __float_as_uint(x0.y);
          a[mi][3] = __float_as_uint(x1.y);
        }
        uint32_t bv[8][2];  // V rows 2t and 2t + 1, rounded here
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          bv[n][0] = to_tf32(__uint_as_float(
              lds_b32(v_addr + (j * 8 * kXLD + n * 8) * 4)));
          bv[n][1] = to_tf32(__uint_as_float(
              lds_b32(v_addr + ((j * 8 + 1) * kXLD + n * 8) * 4)));
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_tf32(o[mi][n], a[mi], bv[n]);
      }
    }
  }

  if ((lane & 7) == 0) {
    sL[rr] = l_run;
    if (kLse && q0 + rr < p.Tq)
      p.lse[(long long)bh * p.Tq + q0 + rr] = m_run + logf(fmaxf(l_run, 1e-30f));
  }
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = mi * 16 + 8 * r + g, row = q0 + rl;
      if (row >= p.Tq) continue;
      float* orow = og + (long long)row * D;
      const float inv = 1.f / sL[rl];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = col0 + n * 8 + tl * 2;
        if (col >= D) continue;
        const float v0 = o[mi][n][2 * r] * inv, v1 = o[mi][n][2 * r + 1] * inv;
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          orow[col] = v0;
          if (col + 1 < D) orow[col + 1] = v1;
        }
      }
    }
}

template <bool kBias, bool kLse>
cudaError_t launch_wide_tf32_as(Params p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_tf32_kernel<kBias, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + kXBQ - 1) / kXBQ) * B * p.H;
  flash_fwd_wide_tf32_kernel<kBias, kLse><<<(unsigned)blocks, kXThreads,
                                            kXSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wide_tf32(Params p, int B, cudaStream_t stream) {
  if (p.bias)
    return p.lse ? launch_wide_tf32_as<true, true>(p, B, stream)
                 : launch_wide_tf32_as<true, false>(p, B, stream);
  return p.lse ? launch_wide_tf32_as<false, true>(p, B, stream)
               : launch_wide_tf32_as<false, false>(p, B, stream);
}

// Largest (BQ, BK) whose tiles fit the block's shared memory.
bool pick_tiles(int dp, int esize, int max_smem, int* bq, int* bk) {
  static const int kTiles[][2] = {{64, 64}, {64, 32}, {32, 32}, {16, 32}, {16, 16}};
  for (const auto& t : kTiles) {
    if (smem_bytes(t[0], t[1], dp, esize) <= (size_t)max_smem) {
      *bq = t[0];
      *bk = t[1];
      return true;
    }
  }
  return false;
}

template <typename T, bool kBias, bool kLse>
cudaError_t launch_as(Params p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.bq, p.bk, p.DP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kBias, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Tq + p.bq - 1) / p.bq) * B * p.H;
  flash_fwd_kernel<T, kBias, kLse><<<(unsigned)blocks, kThreads, smem,
                                     stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  if (p.bias)
    return p.lse ? launch_as<T, true, true>(p, B, stream)
                 : launch_as<T, true, false>(p, B, stream);
  return p.lse ? launch_as<T, false, true>(p, B, stream)
               : launch_as<T, false, false>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias and the output).
// bias_mode: 0 = no bias (bias may be null), 1 = one [Tq, Tk] slice,
// 2 = one per head, 3 = one per (b, h). lse may be null. vec: the bytes
// every row of q, k and v can move in (16, 8 or 4: D, the token strides
// and the pointers are multiples of it), or 0 for element loads. Returns a
// cudaError_t (0 on success).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   const void* bias, float* lse,
                   long long q_sb, long long q_sh, long long q_st,
                   long long k_sb, long long k_sh, long long k_st,
                   long long v_sb, long long v_sh, long long v_st,
                   long long bias_sn, long long bias_sq, int bias_mode,
                   int B, int H, int Tq, int Tk, int D, float scale,
                   int dtype, int vec, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || (dtype != 0 && dtype != 1)
      || bias_mode < 0 || bias_mode > 3 || ((bias_mode != 0) != (bias != nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.bias = bias; p.lse = lse;
  p.bias_sn = bias_sn; p.bias_sq = bias_sq; p.bias_mode = bias_mode;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.DP = (D + 15) / 16 * 16;
  p.scale = scale;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tf32_dk(D)) {
    if (vec != 4 && vec != 8 && vec != 16)  // f32 rows move in 4-byte units
      return (int)cudaErrorInvalidValue;
    return (int)launch_tf32(p, B, s);
  }
  if (dtype == 0 && D <= kXDK) {
    if (vec != 4 && vec != 8 && vec != 16)
      return (int)cudaErrorInvalidValue;
    return (int)launch_wide_tf32(p, B, s);
  }
  if (dtype == 1 && reg_dk(D, bias != nullptr)) {
    if (vec != 0 && vec != 4 && vec != 8 && vec != 16)
      return (int)cudaErrorInvalidValue;
    return (int)launch_reg(p, B, s);
  }
  if (dtype == 1 && D <= kWDK && wide_fits()) {
    if (vec != 0 && vec != 4 && vec != 8 && vec != 16)
      return (int)cudaErrorInvalidValue;
    return (int)launch_wide(p, B, s);
  }
  p.vec = vec == 16;  // the shared-memory kernel moves 16 bytes or one element
  const int esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(p.DP, esize, max_block_smem(), &p.bq, &p.bk))
    return (int)cudaErrorInvalidConfiguration;
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s));
}

// The tiles and shared memory an unbiased launch at head dim D would use,
// and its kernel: 1 flash_fwd_kernel (the first design), 2
// flash_fwd_reg_kernel (bf16), 3 flash_fwd_wide_kernel (bf16), 4
// flash_fwd_tf32_kernel (f32), 5 flash_fwd_wide_tf32_kernel (f32); 0 when
// no tile fits.
int flash_attn_fwd_tiles(int D, int dtype, int* bq, int* bk, int* smem) {
  if (dtype == 0 && tf32_dk(D)) {
    *bq = kTBQ;
    *bk = tf32_dk(D) <= 64 ? Tf32Cfg<64>::BK : Tf32Cfg<128>::BK;
    *smem = tf32_dk(D) == 32 ? Tf32Cfg<32>::kSmem
            : tf32_dk(D) == 64 ? Tf32Cfg<64>::kSmem : Tf32Cfg<128>::kSmem;
    return 4;
  }
  if (dtype == 0 && D <= kXDK) {
    *bq = kXBQ;
    *bk = kXBK;
    *smem = kXSmem;
    return 5;
  }
  if (dtype == 1 && reg_dk(D)) {
    *bq = kRBQ;
    *bk = kRBK;
    *smem = reg_smem(reg_dk(D));
    return 2;
  }
  if (dtype == 1 && D <= kWDK && wide_fits()) {
    *bq = kWBQ;
    *bk = kWBK;
    *smem = kWSmem;
    return 3;
  }
  const int dp = (D + 15) / 16 * 16, esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(dp, esize, max_block_smem(), bq, bk)) return 0;
  *smem = (int)smem_bytes(*bq, *bk, dp, esize);
  return 1;
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
