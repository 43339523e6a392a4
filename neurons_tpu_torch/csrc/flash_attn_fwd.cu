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
// K/V window only up to ~4.6 KB a row; here one kernel serves all three.
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
// zero-padded to a multiple of 16 in shared memory, so no padded copy of any
// operand is made in device memory.
//
// Design. One block of 4 warps owns one (b, h) and a tile of BQ query rows,
// and loops over K/V in tiles of BK keys held in shared memory (blocks run in
// parallel on the SMs; the TPU's sequential grid axis becomes this loop).
// Per K tile: S = Q K^T on the tensor cores (WMMA bf16 16x16x16, or TF32
// 16x16x8 for f32 inputs), an online-softmax update of the row max and sum in
// f32, then O += P V on the tensor cores. The O accumulator lives in shared
// memory in f32, not in registers: at d=512 a 64-row f32 accumulator alone
// is 128 KB, more than the register file of a block can hold. BQ and BK are
// chosen at launch as the largest pair whose tiles fit the 227 KB a block may
// use (64x64 at d <= 128; 32x32 at d=512 in bf16), so no head dim is
// hard-coded.
//
// What bounds it on an H100: at the stage-3 shapes (d=32..512, Tk >= 256)
// attention does 4*Tq*Tk*D operations against (Tq+2Tk+Tq)*D*esize bytes, so
// it is operation-bound (989 TFLOP/s bf16 dense against 3.35 TB/s). This
// first kernel uses WMMA (mma.sync underneath), not wgmma/TMA, keeps O in
// shared memory and does not overlap the K/V loads with the products, so it
// reaches a fraction of that peak; its measured times stand in PERF.md.

#include "flash_common.cuh"

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
  int vec;                     // 1 when rows move 16 bytes at a time
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
// 2 = one per head, 3 = one per (b, h). lse may be null. Returns a
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
  const int esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(p.DP, esize, max_block_smem(), &p.bq, &p.bk))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s));
}

// The tiles and shared memory a launch at head dim D would use; 0 when no
// tile fits.
int flash_attn_fwd_tiles(int D, int dtype, int* bq, int* bk, int* smem) {
  const int dp = (D + 15) / 16 * 16, esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(dp, esize, max_block_smem(), bq, bk)) return 0;
  *smem = (int)smem_bytes(*bq, *bk, dp, esize);
  return 1;
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
