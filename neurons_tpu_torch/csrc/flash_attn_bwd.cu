// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces the JAX package's two Pallas TPU backward kernels
//   neurons_tpu/ops/attention.py:276  _flash_bwd_kernel       (no bias)
//   neurons_tpu/ops/attention.py:458  _flash_bwd_bias_kernel  (additive bias)
// which compute the FlashAttention-2 backward from the forward's saved
// log-sum-exp: with s = q k^T * scale (+ bias) in f32,
//   p  = exp(s - lse)                 (zero on padded query rows)
//   dv = p^T g          (p rounded to the input type first)
//   dp = g v^T,  ds = p (dp - delta)  (delta = sum_d g * out, from the caller)
//   dk = (ds*scale)^T q,  dq = (ds*scale) k   (ds*scale rounded to the input type)
//   dbias = ds, summed over the rows that share a bias slice
// with f32 accumulation throughout. One source serves both: the bias is a
// runtime switch.
//
// Layout: q, g [B, H, Tq, D]; k, v [B, Hkv, Tk, D] with Hkv in {1, H} (a
// multi-query k/v row is read through a head stride of 0); lse and delta
// [B*H, Tq] f32; bias [N, Tq, Tk] in the input type with N in {1, H, B*H}.
// Any strides over batch, head and token, unit stride over D. Outputs: dq
// [B*H, Tq, D] in the input type; dk and dv [B*H, Tk, D] in f32, one per
// (b, h) (the caller sums them over heads for multi-query k/v, in f32, as the
// JAX package does at :652-656, and casts); dbias [N, Tq, Tk] in f32.
//
// Design: two kernels, no atomics, so every sum has one fixed order.
//  * flash_bwd_dkdv_kernel: one block per (b, h) and tile of BK keys, holding
//    K, V and the dk, dv accumulators (f32, shared memory) while it loops
//    over the query tiles: S and dP, then P and dS, then dv += P^T G and
//    dk += dS^T Q. 4 products a tile pair.
//  * flash_bwd_dq_kernel: one block per (bias slice, tile of BQ queries). It
//    loops over the (b, h) rows that share the slice (one row without a
//    bias or with a per-(b, h) bias; the B rows of a head for a per-head
//    bias) and, for each, over the key tiles: S and dP, then dS, then
//    dq += dS K. The block owns its dbias rows, so it adds each row's dS
//    into them in device memory in f32 without atomics: no [B, H, Tq, Tk]
//    intermediate (337 MB a layer at the prior's shape) is ever made.
//    3 products a tile pair: the recompute of S and dP is what a second pass
//    costs instead of f32 atomics on dq.
// Ragged Tq and Tk are masked (padded query rows and key columns give p = 0,
// so they add nothing to any gradient), D is zero-padded to a multiple of 16
// in shared memory, and only valid rows and columns are written.
//
// What bounds it on an H100: 10*B*H*Tq*Tk*D operations (5 products) against
// (4*Tq + 4*Tk)*D*esize + 8*Tq bytes a (b, h), plus the bias read and the f32
// dbias written. At the decoder's [60,1,4096,4096,32] it is operation-bound;
// at the prior's [10,32,513,514,52] the bias and dbias (Tq*Tk a slice) bring
// it near the line. This first kernel uses WMMA (mma.sync underneath) with
// every tile product staged through shared memory, 7 products where 5
// would do, and no overlap of loads with products; its times stand in
// PERF.md beside its bound.

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  const void* bias;            // [N, Tq, Tk] or null
  void* dq;                    // [B*H, Tq, D], input type
  float* dk;                   // [B*H, Tk, D]
  float* dv;
  float* dbias;                // [N, Tq, Tk] or null
  long long q_sb, q_sh, q_st;  // element strides over batch, head, token
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long g_sb, g_sh, g_st;
  long long bias_sn, bias_sq;
  int bias_mode;               // see bias_slice()
  int B, H, Tq, Tk, D, DP;     // DP: D rounded up to 16
  int bq, bk;
  float scale;
  int vec;                     // 1 when rows move 16 bytes at a time
};

// (b, h) row of q for replica r of bias slice n in the dq kernel: the per-
// head slice n is shared by rows r*H + n, the single shared slice by all.
__device__ inline int row_of(int mode, int n, int r, int H) {
  return mode == 1 ? r : (mode == 2 ? r * H + n : n);
}

__host__ __device__ inline size_t smem_dkdv(int bq, int bk, int dp, int esize) {
  const int skew = esize == 2 ? 8 : 4;
  const size_t ldt = dp + skew, lds = bk + 4, ldp = bk + skew, ldo = dp + 4;
  return 2 * align128((size_t)esize * bk * ldt)    // K, V
         + 2 * align128((size_t)esize * bq * ldt)  // Q, G
         + 2 * align128(4 * (size_t)bq * lds)      // S, dP (f32)
         + 2 * align128((size_t)esize * bq * ldp)  // P, dS (input type)
         + 2 * align128(4 * (size_t)bk * ldo)      // dK, dV accumulators
         + 2 * align128(4 * (size_t)bq);           // lse, delta
}

__host__ __device__ inline size_t smem_dq(int bq, int bk, int dp, int esize) {
  const int skew = esize == 2 ? 8 : 4;
  const size_t ldt = dp + skew, lds = bk + 4, ldp = bk + skew, ldo = dp + 4;
  return 2 * align128((size_t)esize * bq * ldt)    // Q, G
         + 2 * align128((size_t)esize * bk * ldt)  // K, V
         + 2 * align128(4 * (size_t)bq * lds)      // S, dP (f32)
         + align128((size_t)esize * bq * ldp)      // dS (input type)
         + align128(4 * (size_t)bq * ldo)          // dQ accumulator
         + 2 * align128(4 * (size_t)bq);           // lse, delta
}

// S = Q K^T and dP = G V^T for a [BQ, BK] tile pair, one 16x16 output tile
// per warp step; both f32 into [BQ, lds] shared tiles.
template <typename T>
__device__ void scores(const T* sQ, const T* sG, const T* sK, const T* sV,
                       float* sS, float* sdP, int BQ, int BK, int DP, int ldt,
                       int lds) {
  using M = Mma<T>;
  const int warp = threadIdx.x / 32;
  const int cols = BK / 16, tiles = (BQ / 16) * cols;
  for (int t = warp; t < 2 * tiles; t += kWarps) {
    const int u = t % tiles;
    const int r0 = (u / cols) * 16, c0 = (u % cols) * 16;
    const T* a_src = t < tiles ? sQ : sG;
    const T* b_src = t < tiles ? sK : sV;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < DP; kk += M::K) {
      typename M::A a;
      typename M::BCol bm;
      wmma::load_matrix_sync(a, a_src + r0 * ldt + kk, ldt);
      wmma::load_matrix_sync(bm, b_src + c0 * ldt + kk, ldt);
      M::to_tf32(a);
      M::to_tf32(bm);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync((t < tiles ? sS : sdP) + r0 * lds + c0, acc, lds,
                            wmma::mem_row_major);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  using M = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int BQ = p.bq, BK = p.bk, DP = p.DP, D = p.D;
  const int ldt = DP + M::kSkew, lds = BK + 4, ldp = BK + M::kSkew,
            ldo = DP + 4;

  unsigned char* cur = smem;
  T* sK = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  T* sV = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  T* sQ = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldt);
  T* sG = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldt);
  float* sS = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * lds);
  float* sdP = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * lds);
  T* sP = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldp);
  T* sdS = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldp);
  float* sdK = reinterpret_cast<float*>(cur);  cur += align128(4 * BK * ldo);
  float* sdV = reinterpret_cast<float*>(cur);  cur += align128(4 * BK * ldo);
  float* sLse = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ);
  float* sDelta = reinterpret_cast<float*>(cur);

  const int warp = threadIdx.x / 32;
  const int nk = (p.Tk + BK - 1) / BK;
  const int k0 = (blockIdx.x % nk) * BK;
  const int bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const T* bg = p.bias ? static_cast<const T*>(p.bias)
                             + bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                       : nullptr;

  load_tile(sK, kg, p.k_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
  load_tile(sV, vg, p.v_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
  for (int i = threadIdx.x; i < BK * ldo; i += kThreads) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
    load_tile(sQ, qg, p.q_st, q0, p.Tq, BQ, D, DP, ldt, p.vec);
    load_tile(sG, gg, p.g_st, q0, p.Tq, BQ, D, DP, ldt, p.vec);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      sLse[i] = q0 + i < p.Tq ? lse[q0 + i] : 0.f;
      sDelta[i] = q0 + i < p.Tq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    scores(sQ, sG, sK, sV, sS, sdP, BQ, BK, DP, ldt, lds);
    __syncthreads();

    // P and dS; padded rows and columns give zeros
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float pv = 0.f, ds = 0.f;
      if (q0 + r < p.Tq && k0 + c < p.Tk) {
        float s = sS[r * lds + c] * p.scale;
        if (bg) s += M::to_float(bg[(q0 + r) * p.bias_sq + k0 + c]);
        pv = expf(s - sLse[r]);
        ds = pv * (sdP[r * lds + c] - sDelta[r]) * p.scale;
      }
      sP[r * ldp + c] = M::from_float(pv);
      sdS[r * ldp + c] = M::from_float(ds);
    }
    __syncthreads();

    // dV += P^T G and dK += dS^T Q: [BK, DP] accumulators, the transposed
    // operand read column-major straight from the [BQ, BK] tile
    const int cols = DP / 16, tiles = (BK / 16) * cols;
    for (int t = warp; t < 2 * tiles; t += kWarps) {
      const int u = t % tiles;
      const int r0 = (u / cols) * 16, c0 = (u % cols) * 16;
      const T* a_src = t < tiles ? sP : sdS;
      const T* b_src = t < tiles ? sG : sQ;
      float* acc_dst = (t < tiles ? sdV : sdK) + r0 * ldo + c0;
      typename M::Acc acc;
      wmma::load_matrix_sync(acc, acc_dst, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BQ; kk += M::K) {
        typename M::ACol a;
        typename M::BRow bm;
        wmma::load_matrix_sync(a, a_src + kk * ldp + r0, ldp);
        wmma::load_matrix_sync(bm, b_src + kk * ldt + c0, ldt);
        M::to_tf32(a);
        M::to_tf32(bm);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(acc_dst, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  float* dkg = p.dk + (long long)bh * p.Tk * D;
  float* dvg = p.dv + (long long)bh * p.Tk * D;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (k0 + r < p.Tk) {
      dkg[(long long)(k0 + r) * D + d] = sdK[r * ldo + d];
      dvg[(long long)(k0 + r) * D + d] = sdV[r * ldo + d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p,
                                                                int n_rep) {
  using M = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int BQ = p.bq, BK = p.bk, DP = p.DP, D = p.D;
  const int ldt = DP + M::kSkew, lds = BK + 4, ldp = BK + M::kSkew,
            ldo = DP + 4;

  unsigned char* cur = smem;
  T* sQ = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldt);
  T* sG = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldt);
  T* sK = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  T* sV = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BK * ldt);
  float* sS = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * lds);
  float* sdP = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * lds);
  T* sdS = reinterpret_cast<T*>(cur);  cur += align128(sizeof(T) * BQ * ldp);
  float* sdQ = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ * ldo);
  float* sLse = reinterpret_cast<float*>(cur);  cur += align128(4 * BQ);
  float* sDelta = reinterpret_cast<float*>(cur);

  const int warp = threadIdx.x / 32;
  const int nq = (p.Tq + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int n = blockIdx.x / nq;  // bias slice (the (b, h) row without one)
  const T* bg = p.bias ? static_cast<const T*>(p.bias) + n * p.bias_sn : nullptr;
  float* dbg = p.dbias ? p.dbias + (long long)n * p.Tq * p.Tk : nullptr;

  for (int rep = 0; rep < n_rep; ++rep) {
    const int bh = row_of(p.bias_mode, n, rep, p.H);
    const int b = bh / p.H, h = bh % p.H;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
    const float* lse = p.lse + (long long)bh * p.Tq;
    const float* delta = p.delta + (long long)bh * p.Tq;

    load_tile(sQ, qg, p.q_st, q0, p.Tq, BQ, D, DP, ldt, p.vec);
    load_tile(sG, gg, p.g_st, q0, p.Tq, BQ, D, DP, ldt, p.vec);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      sLse[i] = q0 + i < p.Tq ? lse[q0 + i] : 0.f;
      sDelta[i] = q0 + i < p.Tq ? delta[q0 + i] : 0.f;
    }
    for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) sdQ[i] = 0.f;

    for (int k0 = 0; k0 < p.Tk; k0 += BK) {
      load_tile(sK, kg, p.k_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
      load_tile(sV, vg, p.v_st, k0, p.Tk, BK, D, DP, ldt, p.vec);
      __syncthreads();

      scores(sQ, sG, sK, sV, sS, sdP, BQ, BK, DP, ldt, lds);
      __syncthreads();

      // dS, and the unscaled dS into this block's own dbias rows (each
      // element always by the same thread, so no ordering is needed)
      for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
        const int r = i / BK, c = i % BK;
        float ds = 0.f;
        if (q0 + r < p.Tq && k0 + c < p.Tk) {
          const long long at = (long long)(q0 + r) * p.Tk + k0 + c;
          float s = sS[r * lds + c] * p.scale;
          if (bg) s += M::to_float(bg[(q0 + r) * p.bias_sq + k0 + c]);
          const float pv = expf(s - sLse[r]);
          ds = pv * (sdP[r * lds + c] - sDelta[r]);
          if (dbg) dbg[at] = rep == 0 ? ds : dbg[at] + ds;
        }
        sdS[r * ldp + c] = M::from_float(ds * p.scale);
      }
      __syncthreads();

      // dQ += dS K
      const int cols = DP / 16;
      for (int t = warp; t < (BQ / 16) * cols; t += kWarps) {
        const int r0 = (t / cols) * 16, c0 = (t % cols) * 16;
        typename M::Acc acc;
        wmma::load_matrix_sync(acc, sdQ + r0 * ldo + c0, ldo, wmma::mem_row_major);
        for (int kk = 0; kk < BK; kk += M::K) {
          typename M::A a;
          typename M::BRow bm;
          wmma::load_matrix_sync(a, sdS + r0 * ldp + kk, ldp);
          wmma::load_matrix_sync(bm, sK + kk * ldt + c0, ldt);
          M::to_tf32(a);
          M::to_tf32(bm);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(sdQ + r0 * ldo + c0, acc, ldo, wmma::mem_row_major);
      }
      __syncthreads();
    }

    T* dqg = static_cast<T*>(p.dq) + (long long)bh * p.Tq * D;
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      if (q0 + r < p.Tq)
        dqg[(long long)(q0 + r) * D + d] = M::from_float(sdQ[r * ldo + d]);
    }
    __syncthreads();
  }
}

// Largest (BQ, BK) whose tiles fit both kernels' shared memory.
bool pick_tiles(int dp, int esize, int max_smem, int* bq, int* bk) {
  static const int kTiles[][2] = {{64, 64}, {64, 32}, {32, 32}, {16, 32}, {16, 16}};
  for (const auto& t : kTiles) {
    if (smem_dkdv(t[0], t[1], dp, esize) <= (size_t)max_smem
        && smem_dq(t[0], t[1], dp, esize) <= (size_t)max_smem) {
      *bq = t[0];
      *bk = t[1];
      return true;
    }
  }
  return false;
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  const size_t s1 = smem_dkdv(p.bq, p.bk, p.DP, sizeof(T));
  const size_t s2 = smem_dq(p.bq, p.bk, p.DP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)p.B * p.H;
  const long long nk = (p.Tk + p.bk - 1) / p.bk, nq = (p.Tq + p.bq - 1) / p.bq;
  flash_bwd_dkdv_kernel<T><<<(unsigned)(bh * nk), kThreads, s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dq grid: one block per (bias slice, query tile); the slice's rows loop
  const long long slices = p.bias_mode == 1 ? 1 : (p.bias_mode == 2 ? p.H : bh);
  const int n_rep = (int)(bh / slices);
  flash_bwd_dq_kernel<T><<<(unsigned)(slices * nq), kThreads, s2, stream>>>(p, n_rep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, bias and dq). bias_mode: 0 =
// no bias (bias and dbias null), 1 = one [Tq, Tk] slice, 2 = one per head,
// 3 = one per (b, h). g, lse and delta must not alias the outputs. Returns a
// cudaError_t (0 on success).
int flash_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, const void* bias,
                   void* dq, float* dk, float* dv, float* dbias,
                   long long q_sb, long long q_sh, long long q_st,
                   long long k_sb, long long k_sh, long long k_st,
                   long long v_sb, long long v_sh, long long v_st,
                   long long g_sb, long long g_sh, long long g_st,
                   long long bias_sn, long long bias_sq, int bias_mode,
                   int B, int H, int Tq, int Tk, int D, float scale,
                   int dtype, int vec, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || (dtype != 0 && dtype != 1)
      || bias_mode < 0 || bias_mode > 3
      || ((bias_mode != 0) != (bias != nullptr))
      || ((bias_mode != 0) != (dbias != nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.g = g; p.lse = lse; p.delta = delta;
  p.bias = bias; p.dq = dq; p.dk = dk; p.dv = dv; p.dbias = dbias;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_st = g_st;
  p.bias_sn = bias_sn; p.bias_sq = bias_sq; p.bias_mode = bias_mode;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.DP = (D + 15) / 16 * 16;
  p.scale = scale;
  p.vec = vec;
  const int esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(p.DP, esize, max_block_smem(), &p.bq, &p.bk))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// The tiles and the larger shared-memory size of the two kernels at head
// dim D; 0 when no tile fits.
int flash_attn_bwd_tiles(int D, int dtype, int* bq, int* bk, int* smem) {
  const int dp = (D + 15) / 16 * 16, esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(dp, esize, max_block_smem(), bq, bk)) return 0;
  const size_t a = smem_dkdv(*bq, *bk, dp, esize), b = smem_dq(*bq, *bk, dp, esize);
  *smem = (int)(a > b ? a : b);
  return 1;
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
