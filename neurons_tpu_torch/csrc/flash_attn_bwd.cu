// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (neurons_tpu_torch/ops/attention.py).
//
// Replaces the JAX package's two Pallas TPU backward kernels
//   neurons_tpu/ops/attention.py:276  _flash_bwd_kernel       (no bias)
//   neurons_tpu/ops/attention.py:458  _flash_bwd_bias_kernel  (additive bias)
// which compute the FlashAttention-2 backward from the forward's saved
// log-sum-exp: with s = q k^T * scale (+ bias) in f32,
//   p  = exp(s - lse)                 (zero on padded query rows, key columns)
//   dv = p^T g          (p rounded to the input type first)
//   dp = g v^T,  ds = p (dp - delta)  (delta = sum_d g * out, from the caller)
//   dk = (ds*scale)^T q,  dq = (ds*scale) k   (ds*scale rounded to the input type)
//   dbias = ds, summed over the rows that share a bias slice
// with f32 accumulation throughout. One source serves both.
//
// Layout: q, g [B, H, Tq, D]; k, v [B, Hkv, Tk, D] with Hkv in {1, H} (a
// multi-query k/v row is read through a head stride of 0); lse and delta
// [B*H, Tq] f32; bias [N, Tq, Tk] in the input type with N in {1, H, B*H}.
// Any strides over batch, head and token, unit stride over D. Outputs: dq
// [B*H, Tq, D] in the input type; dk and dv [B*H, Tk, D] in f32, one per
// (b, h) (the caller sums them over heads for multi-query k/v, in f32, as the
// JAX package does at :652-656, and casts); dbias [N, Tq, Tk] in f32.
//
// Two passes and no atomics, so every sum has one fixed order and a rerun
// gives equal bits: a dK/dV pass over key tiles and a dQ (+ dbias) pass over
// query tiles. Each recomputes S and dP: 7 products where 5 would do with
// f32 atomics on dq (9 with a bias slice shared by several rows, whose
// dbias takes a third pass). Ragged Tq and Tk are masked (p = 0 there, so padded
// rows and columns add nothing), D is zero-padded in shared memory, and
// only valid rows and columns are written.
//
// What bounds it on an H100: 10*B*H*Tq*Tk*D operations (the 5 products of
// the algorithm) against (3*Tq + 4*Tk)*D*esize + 4*Tq bytes a (b, h), plus
// the bias read and the f32 dbias written. At 989 TFLOP/s and 3.35 TB/s the
// stage-2 step's sites are bound by operations (decoder 64x64 0.33 ms
// against 0.03 ms of bytes, 32x32 0.04, the prior 0.044 against 0.031 ms
// with its bias and dbias), except the decoder's 16x16 site at d = 128
// (0.005 ms of operations, 0.008 ms of bytes).
//
// Design of the bf16 instances at D <= 128 (flash_bwd_dkdv_reg_kernel,
// flash_bwd_dq_reg_kernel, flash_bwd_dbias_reg_kernel). The unbiased
// launches at d 32, 64 and 128 on 16-byte rows (the DecoderVideo's) take
// the wgmma kernels of flash_attn_bwd_sm90.cu, the prior's biased bf16
// launches those of flash_attn_bwd_bias_sm90.cu; these keep the other
// biased launches (a slice shared by several rows adding the dbias
// kernel), rows and strides off 16 (or, biased, 8) bytes, and head dims no
// wgmma instance serves. Every product is
// mma.sync m16n8k16 into f32 registers, and the elementwise steps between
// products run on the C fragments in place, never through shared memory.
//  * Pass 1, dK/dV: one block of 4 warps per (b, h) and 64 keys, 16 keys a
//    warp. K and V are staged once (and, at D <= 64, held in registers as
//    ldmatrix A fragments). Q, g, lse and delta of each 64-query tile, and
//    the bias's [64 queries x 64 keys] slice, come through a 2-stage
//    cp.async ring one tile ahead (16-, 8- or 4-byte copies as the rows
//    allow, element copies otherwise; zero past Tq, Tk and D). Per 32-query
//    chunk a warp computes S^T = K Q^T and dP^T = V g^T (keys x queries),
//    P^T = exp(S^T*scale + bias^T - lse) with the accurate expf and dS^T =
//    P^T (dP^T - delta); P^T and dS^T*scale are rounded to bf16 in place as
//    A fragments (the C layout of two n8 tiles is the A layout of one k16
//    step), and dV += P^T g, dK += (dS^T*scale) Q take g and Q by
//    ldmatrix.trans from the ring. dK and dV are f32 register accumulators
//    over the whole query loop, written once. One barrier a tile.
//  * Pass 2, dQ: one block of 4 warps per (b, h) and 64 queries, 16
//    queries a warp. Q and g are staged (held at D <= 64), lse and delta
//    sit in registers, and K, V (and the bias slice) come through the ring.
//    S and dP, then dS = P (dP - delta) in registers, and dQ += (dS*scale) K
//    with dS as the A fragment and K by ldmatrix.trans; dQ is an f32
//    register accumulator written once in the input type. Three products.
//    Where each (b, h) has its own bias slice, the block writes the
//    unscaled dS as its rows of dbias.
//  * Pass 3, dbias of a slice shared by several rows (one slice for all, or
//    the prior's one per head, shared by the B rows of a head): one block
//    per slice and [64 x 64] tile, which recomputes S and dP for each row
//    that shares the slice (its Q, g, K, V, lse and delta through the ring
//    one row ahead; the bias tile staged once) and sums the unscaled dS in
//    f32 registers in row order, written once. Two products more, but the
//    grid fills the card and no partial sum goes through memory: walking
//    the B rows inside the dQ pass instead (one block per head and query
//    tile, 288 at the prior's shape, each row's dS added into dbias in
//    device memory) took 1.25 ms against 0.52 + 0.61 ms for the dQ and
//    dbias passes here (PERF.md). No [B, H, Tq, Tk] intermediate is made.
// The head dim is padded to 32, 64, 96 or 128 in shared memory and in the
// depth of S and dP only; the products over D run its real n8 tiles (52 =
// 7). At D > 64 the resident tiles are read from shared memory at each use:
// their fragments, held, would leave no registers for the f32 accumulators.
//
// The f32 (TF32) instances at 128 < D <= 512 without a bias
// (flash_bwd_dkdv_wide_tf32_kernel, flash_bwd_dq_wide_tf32_kernel) carry
// the autoencoder trainer's generator step, [4, 1, 1024, 1024, 512] at the
// VAE's mid attention, 2 launches a step. Every operand of the five
// products (Q, K, V, g, P, dS*scale) is rounded to TF32 by cvt.rna, the
// sums are f32, the probabilities take the accurate expf, as
// `flash_attention_bwd_reference(..., tf32=True)` does. At 512 columns in
// f32 the dK and dV accumulators of a key take 4 KB, so they are split by
// columns across 8 warps (64 each), and so is the depth of S and dP:
//  * Pass 1, dK/dV: one block per (b, h) and 16 keys (256 blocks at the
//    trainer's shape). Warp w holds its 64 columns of K and V as TF32 A
//    fragments (64 registers) and of dK and dV as f32 accumulators (64).
//    Q, g, lse and delta of 16-query tiles come through a 3-stage cp.async
//    ring, two tiles ahead (K and V are staged once in its last stage).
//    Per tile each warp writes its columns' partials of S^T = K Q^T and
//    dP^T = V g^T ([16 x 16] each, mma.sync m16n8k8, Q and g by ldmatrix
//    and rounded in registers); after a barrier each of the 256 threads
//    sums one element of each over the warps in warp order and writes P^T
//    and dS^T*scale rounded to TF32 (zero past Tq and Tk); after a second
//    barrier each warp adds P^T g into dV and (dS^T*scale) Q into dK on
//    its columns (the key permutation of mma_sm80.cuh: A's k index t is
//    query 2t, B's rows 2t and 2t + 1).
//  * Pass 2, dQ: one block per (b, h) and 16 queries, Q and g held, K and V
//    through the ring, the same partials of S and dP, dS*scale, and dQ +=
//    (dS*scale) K on each warp's columns.
// The elementwise steps run once an element, on the summed partials, not
// on each warp's C fragments: the depth split that keeps Q or K in
// registers leaves no warp the whole of S. Two barriers a tile; no
// atomics, so a rerun gives equal bits. What bounds it: 10 Tq Tk D
// operations (21.5 GFLOP at the trainer's shape, 43.4 us at 495 TF32
// TFLOP/s) against 58.7 MB (17.5 us), so operations. As in the forward,
// the traffic from L2 comes first: each 16-row block streams its head's
// whole Q and g (pass 1) or K and V (pass 2), 1.07 GB a pass at the
// trainer's shape, and the passes took 0.405 and 0.370 ms (H100 SXM at
// 700 W; 0.79 ms in all against 1.21 for the backward of PyTorch's fused
// attention): 2.7 and 2.9 TB/s of it.
//
// The f32 (TF32) instances at D <= 128, with and without a bias
// (flash_bwd_dkdv_tf32_kernel, flash_bwd_dq_tf32_kernel,
// flash_bwd_dbias_tf32_kernel) take the f32 launches that
// flash_attn_bwd_tf32_sm90.cu (TF32 wgmma, TMA; stage 2's f32 step and the
// tiny f32 CLI chain) leaves: rows, strides or pointers off 16 bytes, d 4,
// and bias layouts other than the prior's. They are the bf16 register design above on
// mma.sync m16n8k8 with .tf32 operands, under the TF32 contract of the
// column-split instances: Q, K, V, g rounded by cvt.rna once a tile in
// shared memory (each thread its own copies after its cp.async wait), P
// and dS*scale rounded in registers, f32 sums, the accurate expf.
//  * Row stride D + 4 floats (D padded to 32, 64 or 128; 4 x an odd
//    number): an ldmatrix phase of 8 rows and a k-major read of rows 2t and
//    2t + 1 at column g each hit 32 distinct banks.
//  * Every A operand is one ldmatrix x4 a k8 step from shared memory (the
//    8-row x 4-float matrices: rows 0-7 and 8-15 of columns 0-3, then
//    4-7); the n-major B operands (Q and g in S^T and dP^T, K and V in S
//    and dP) are ldmatrix x4 of two k8 steps. Nothing resident is held in
//    registers: dK and dV (or dQ) and S, dP take them (holding K and V at
//    d <= 64, as bf16 does, measured no faster on an H100).
//  * C is not A in TF32: P^T, dS^T and dS go from their C registers into A
//    as a = (c0, c2, c1, c3), so the products over queries (dV, dK) and
//    over keys (dQ) sum in a permuted order, and their k-major B operands
//    (g and Q, K) are scalar reads of rows 2t and 2t + 1.
//  * The depth of S and dP runs D's k8 steps (52: 7), the products over D
//    its n8 tiles; past D the staged columns are zero.
//  * Ring stages: the most blocks an SM first, then the deeper ring
//    (tf32_stages): two stages where two blocks an SM fit (d <= 32; d <= 64
//    unbiased), one where only that keeps two (d <= 64 biased: the prior,
//    2.80-2.89 ms against 4.79 with two stages and one block), two at
//    d = 128 unbiased (199 KB, one block), one at d = 128 biased.
// Two passes (three with a shared bias slice), no atomics: equal bits on
// a rerun. What bounds them: 10 Tq Tk D operations at 495 TF32 TFLOP/s
// (the prior 0.089 ms, the decoder's 64 x 64 site 0.65 ms), while every
// B fragment read from shared memory feeds one warp's 16 rows, twice the
// bytes an operation of the bf16 design, and the passes run at 15-53
// TFLOP/s: the prior took 2.95 ms (0.97, 0.94, 0.94 by pass; the first
// design 13.7, the library's backward 2.58), the decoder's sites 0.23,
// 0.95 and 6.04 ms (H100 SXM at 700 W).
//
// The first design (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel: WMMA,
// every tile product staged through shared memory, the dK, dV and dQ
// accumulators in shared memory, one tile in flight) is left for a biased
// f32 launch past D = 128 and for any D past 512; no path launches either.

#include "flash_common.cuh"
#include "mma_sm80.cuh"

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
  int vec;                     // bytes a row moves in (16, 8, 4; 0: elements);
                               // the WMMA kernels: 1 for 16 bytes, else 0
  int bgran;                   // the same for the bias rows
};

// (b, h) row of q for replica r of bias slice n (the WMMA dq kernel, the
// dbias kernel): the per-head slice n is shared by rows r*H + n, the single
// shared slice by all.
__device__ inline int row_of(int mode, int n, int r, int H) {
  return mode == 1 ? r : (mode == 2 ? r * H + n : n);
}

// ---------------------------------------------------------------------------
// The first design, WMMA through shared memory: biased f32 past D = 128,
// and D > 512

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

// ---------------------------------------------------------------------------
// bf16 at D <= 128: the products in registers, tiles through a cp.async ring

constexpr int kRB = 64;         // rows a block owns (keys, then queries) and
                                // rows of a ring tile
constexpr int kRThreads = 128;  // 4 warps of 16 rows
constexpr int kRC = 32;         // columns of S a warp takes at a time
constexpr int kBLD = kRB + 8;   // row stride of a bias tile, elements
static_assert(kRThreads == 2 * kRB, "one lse or delta copy a thread");

template <int DK, bool kBias>  // DK: the head dim padded to 32
struct RegCfg {
  static constexpr int LD = DK + 8;        // a 16-byte skew, as the forward's
  static constexpr int kTile = kRB * LD;   // elements of a [64][LD] tile
  static constexpr int KS = DK / 16;       // k16 steps of S and dP
  static constexpr int NO = DK / 8;        // n8 tiles of the D-wide products
  static constexpr bool kHold = DK <= 64;  // resident fragments in registers
  static constexpr int kBiasBytes = kBias ? kRB * kBLD * 2 : 0;
  // a ring stage: two operand tiles (pass 1: Q, g, then lse and delta;
  // pass 2: K, V), then the bias tile
  static constexpr int kStage1 = 4 * kTile + 2 * kRB * 4 + kBiasBytes;
  static constexpr int kStage2 = 4 * kTile + kBiasBytes;
  // the two resident tiles (pass 1: K, V; pass 2: Q, g) and the ring
  static constexpr int kSmem1 = 4 * kTile + 2 * kStage1;
  static constexpr int kSmem2 = 4 * kTile + 2 * kStage2;
};

// Copy the [64 queries x 64 keys] block at (q0, k0) of one [Tq, Tk] bias
// slice (row stride sq) into a [64][BLD] tile; queries past Tq and keys
// past Tk are zero. kGran as stage_rows (0: bf16 only); the last copy of a
// ragged row reads only the bytes left in it.
template <typename T, int BLD, int kGran>
__device__ __forceinline__ void stage_bias(T* dst, const T* src, long long sq,
                                           int q0, int k0, int Tq, int Tk) {
  constexpr int E = kGran ? kGran / (int)sizeof(T) : 1, per_row = kRB / E;
#pragma unroll 1
  for (int i = threadIdx.x; i < kRB * per_row; i += kRThreads) {
    const int r = i / per_row, c = (i % per_row) * E;
    const int q = q0 + r, key = k0 + c;
    const bool ok = q < Tq && key < Tk;
    if constexpr (kGran == 0) {
      dst[r * BLD + c] = ok ? src[(long long)q * sq + key]
                            : __float2bfloat16(0.f);
    } else {
      cp_async<kGran>(smem_addr(dst + r * BLD + c),
                      ok ? src + (long long)q * sq + key : src,
                      ok ? min(kGran, (int)sizeof(T) * (Tk - key)) : 0);
    }
  }
}

template <typename T, int BLD>
__device__ __forceinline__ void stage_bias_any(int gran, T* dst, const T* src,
                                               long long sq, int q0, int k0,
                                               int Tq, int Tk) {
  switch (gran) {
    case 16: stage_bias<T, BLD, 16>(dst, src, sq, q0, k0, Tq, Tk); break;
    case 8: stage_bias<T, BLD, 8>(dst, src, sq, q0, k0, Tq, Tk); break;
    case 4: stage_bias<T, BLD, 4>(dst, src, sq, q0, k0, Tq, Tk); break;
    default:  // f32 rows always move in 4-byte copies
      if constexpr (sizeof(T) == 2)
        stage_bias<T, BLD, 0>(dst, src, sq, q0, k0, Tq, Tk);
      break;
  }
}

// lse, then delta, of the 64 queries at q0 into dst[0..127] (zero past Tq):
// one 4-byte copy a thread
__device__ __forceinline__ void stage_row_stats(float* dst, const float* lse,
                                                const float* delta, int q0,
                                                int Tq) {
  const int i = threadIdx.x % kRB;
  const float* src = threadIdx.x < kRB ? lse : delta;
  const bool ok = q0 + i < Tq;
  cp_async<4>(smem_addr(dst + threadIdx.x), ok ? src + q0 + i : src,
              ok ? 4 : 0);
}

// Byte offsets of this lane's ldmatrix row address in a [rows][LD] tile:
// an A fragment (16 rows x 16 columns), a B fragment pair of two n8 tiles
// read from [n][k] rows (non-trans), and from [k][n] rows (trans).
template <int LD>
struct LaneOffsets {
  uint32_t a, nt, tr;
  __device__ explicit LaneOffsets(int lane)
      : a((uint32_t)(((lane & 15) * LD + (lane >> 4) * 8) * 2)),
        nt((uint32_t)((((lane & 7) + (lane >> 4) * 8) * LD +
                       ((lane >> 3) & 1) * 8) * 2)),
        tr((uint32_t)((((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8) * 2)) {}
};

// One 16-row x kRC-column block of two scores, c1 = A1 B1^T and c2 =
// A2 B2^T, over the padded head dim: A1, A2 the warp's resident rows
// (held fragments, or ldmatrix from a1, a2 at each step), B1, B2 kRC rows
// of the ring tiles at b1, b2 (non-trans).
template <int DK, bool kHold>
__device__ __forceinline__ void two_scores(float (&c1)[kRC / 8][4],
                                           float (&c2)[kRC / 8][4],
                                           const uint32_t (*f1)[4],
                                           const uint32_t (*f2)[4],
                                           uint32_t a1, uint32_t a2,
                                           uint32_t b1, uint32_t b2) {
  constexpr int LD = DK + 8;
#pragma unroll
  for (int j = 0; j < kRC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) {
    uint32_t x1[4], x2[4];
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x1[i] = f1[ks][i];
        x2[i] = f2[ks][i];
      }
    } else {
      ldmatrix_x4(x1, a1 + ks * 32);
      ldmatrix_x4(x2, a2 + ks * 32);
    }
#pragma unroll
    for (int jp = 0; jp < kRC / 16; ++jp) {
      const uint32_t off = jp * 16 * LD * 2 + ks * 32;
      uint32_t r[4];
      ldmatrix_x4(r, b1 + off);
      mma_bf16(c1[2 * jp], x1, r);
      mma_bf16(c1[2 * jp + 1], x1, r + 2);
      ldmatrix_x4(r, b2 + off);
      mma_bf16(c2[2 * jp], x2, r);
      mma_bf16(c2[2 * jp + 1], x2, r + 2);
    }
  }
}

// acc += A B over the real head dim's n8 tiles (nv8 of them): A the
// 16 x kRC bf16 fragments a[kRC / 16], B kRC rows of a [k][n] tile at b
// (ldmatrix.trans).
template <int DK>
__device__ __forceinline__ void product_d(float (&acc)[DK / 8][4],
                                          const uint32_t (&a)[kRC / 16][4],
                                          uint32_t b, int nv8) {
  constexpr int LD = DK + 8;
#pragma unroll
  for (int kk = 0; kk < kRC / 16; ++kk)
#pragma unroll
    for (int np = 0; np < DK / 16; ++np) {
      if (2 * np >= nv8) continue;
      uint32_t r[4];
      ldmatrix_x4_trans(r, b + (kk * 16 * LD + np * 16) * 2);
      mma_bf16(acc[2 * np], a[kk], r);
      if (2 * np + 1 < nv8) mma_bf16(acc[2 * np + 1], a[kk], r + 2);
    }
}

// Write a warp's 16 x D f32 accumulator (rows row0, row0 + 8 of this lane)
// to [rows, D] at out as f32 (dk, dv) or bf16 (dq); rows past n are not
// written.
template <int DK, typename T>
__device__ __forceinline__ void write_rows(T* out, const float (&acc)[DK / 8][4],
                                           int row0, int n, int D, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    T* orow = out + (long long)row * D;
#pragma unroll
    for (int t = 0; t < DK / 8; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      if (col >= D) continue;
      const float v0 = acc[t][2 * r], v1 = acc[t][2 * r + 1];
      if constexpr (sizeof(T) == 4) {
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          orow[col] = v0;
          if (col + 1 < D) orow[col + 1] = v1;
        }
      } else {
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16(v0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// Pass 1: dK and dV of 64 keys of one (b, h).
template <int DK, bool kBias>
__global__ void __launch_bounds__(kRThreads)
flash_bwd_dkdv_reg_kernel(Params p) {
  using C = RegCfg<DK, kBias>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = C::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + C::kTile;
  unsigned char* ring = smem + 4 * C::kTile;  // [2][Q, g, lse, delta, bias]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (p.Tk + kRB - 1) / kRB;
  const int k0 = (blockIdx.x % nk) * kRB;
  const int bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const bf16* bg = kBias ? static_cast<const bf16*>(p.bias) +
                               bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                         : nullptr;
  const int nq = (p.Tq + kRB - 1) / kRB;

  auto load_tile = [&](int s, int q0) {
    bf16* dst = reinterpret_cast<bf16*>(ring + s * C::kStage1);
    stage_rows_any<kRB, DK, kRThreads>(p.vec, dst, qg, p.q_st, q0, p.Tq, D);
    stage_rows_any<kRB, DK, kRThreads>(p.vec, dst + C::kTile, gg, p.g_st, q0,
                                       p.Tq, D);
    stage_row_stats(reinterpret_cast<float*>(dst + 2 * C::kTile), lse, delta,
                    q0, p.Tq);
    if constexpr (kBias)
      stage_bias_any<bf16, kBLD>(
          p.bgran,
          reinterpret_cast<bf16*>(ring + s * C::kStage1 + 4 * C::kTile +
                                  2 * kRB * 4),
          bg, p.bias_sq, q0, k0, p.Tq, p.Tk);
  };

  stage_rows_any<kRB, DK, kRThreads>(p.vec, sK, kg, p.k_st, k0, p.Tk, D);
  stage_rows_any<kRB, DK, kRThreads>(p.vec, sV, vg, p.v_st, k0, p.Tk, D);
  load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const LaneOffsets<LD> lo(lane);
  // this warp's 16 keys: rows of K and V, the A operands of S^T and dP^T
  const uint32_t ka = smem_addr(sK) + warp * 16 * LD * 2 + lo.a;
  const uint32_t va = smem_addr(sV) + warp * 16 * LD * 2 + lo.a;
  uint32_t kf[C::kHold ? C::KS : 1][4], vf[C::kHold ? C::KS : 1][4];
  if constexpr (C::kHold) {
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      ldmatrix_x4(kf[ks], ka + ks * 32);
      ldmatrix_x4(vf[ks], va + ks * 32);
    }
  }
  float dk[C::NO][4], dv[C::NO][4];
#pragma unroll
  for (int t = 0; t < C::NO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
  const int nv8 = (D + 7) / 8;
  const int key_l = warp * 16 + (lane >> 2);  // this lane's keys: +0, +8
  const bool key_ok[2] = {k0 + key_l < p.Tk, k0 + key_l + 8 < p.Tk};

  for (int t = 0; t < nq; ++t) {
    const int stg = t & 1;
    if (t + 1 < nq) load_tile(stg ^ 1, (t + 1) * kRB);
    cp_async_commit();
    const int q0 = t * kRB;
    const unsigned char* st = ring + stg * C::kStage1;
    const uint32_t qs = smem_addr(st), gs = qs + 2 * C::kTile;
    const float* s_lse = reinterpret_cast<const float*>(st + 4 * C::kTile);
    const float* s_delta = s_lse + kRB;
    const bf16* s_bias =
        reinterpret_cast<const bf16*>(st + 4 * C::kTile + 2 * kRB * 4);

#pragma unroll 1
    for (int qc = 0; qc < kRB; qc += kRC) {
      // S^T = K Q^T and dP^T = V g^T: 16 keys x kRC queries
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores<DK, C::kHold>(s, dp, kf, vf, ka, va, qs + qc * LD * 2 + lo.nt,
                               gs + qc * LD * 2 + lo.nt);
      // P^T and dS^T*scale, rounded to bf16 as the A fragments of kRC / 16
      // k16 steps (column pair j of S^T: queries qc + 8j + 2(lane % 4), + 1)
      uint32_t pa[kRC / 16][4], da[kRC / 16][4];
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j) {
        const int ql = qc + j * 8 + (lane & 3) * 2;
        const float2 ls = *reinterpret_cast<const float2*>(s_lse + ql);
        const float2 dl = *reinterpret_cast<const float2*>(s_delta + ql);
        const bool q_ok[2] = {q0 + ql < p.Tq, q0 + ql + 1 < p.Tq};
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1, r = e >> 1;
          float x = s[j][e] * p.scale;
          if constexpr (kBias)
            x += __bfloat162float(s_bias[(ql + c) * kBLD + key_l + 8 * r]);
          const float pv =
              key_ok[r] && q_ok[c] ? expf(x - (c ? ls.y : ls.x)) : 0.f;
          pe[e] = pv;
          de[e] = pv * (dp[j][e] - (c ? dl.y : dl.x)) * p.scale;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(pe[0], pe[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
        da[j >> 1][(j & 1) * 2] = pack_bf16(de[0], de[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(de[2], de[3]);
      }
      // dV += P^T g, dK += (dS^T*scale) Q
      product_d<DK>(dv, pa, gs + qc * LD * 2 + lo.tr, nv8);
      product_d<DK>(dk, da, qs + qc * LD * 2 + lo.tr, nv8);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  const long long out = (long long)bh * p.Tk * D;
  write_rows<DK>(p.dk + out, dk, k0 + key_l, p.Tk, D, lane);
  write_rows<DK>(p.dv + out, dv, k0 + key_l, p.Tk, D, lane);
}

// Pass 2: dQ of 64 queries of one (b, h), and with a bias of its own (one
// slice per (b, h)) the rows of dbias they own.
template <int DK, bool kBias>
__global__ void __launch_bounds__(kRThreads)
flash_bwd_dq_reg_kernel(Params p) {
  using C = RegCfg<DK, kBias>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = C::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + C::kTile;
  unsigned char* ring = smem + 4 * C::kTile;  // [2][K, V, bias]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kRB - 1) / kRB;
  const int q0 = (blockIdx.x % nq) * kRB;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int nk = (p.Tk + kRB - 1) / kRB;
  const int D = p.D;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh;
  const bf16* bg = kBias ? static_cast<const bf16*>(p.bias) +
                               bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                         : nullptr;
  // dS is this block's dbias only where each (b, h) has its own slice;
  // shared slices take theirs from flash_bwd_dbias_reg_kernel
  float* dbg = kBias && p.bias_mode == 3
                   ? p.dbias + (long long)bh * p.Tq * p.Tk : nullptr;
  const bool pairs = (p.Tk & 1) == 0;  // dbias rows start 8-byte aligned
  const int row_l = warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const int rows[2] = {q0 + row_l, q0 + row_l + 8};
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < p.Tq;
    lse[r] = ok ? p.lse[(long long)bh * p.Tq + rows[r]] : 0.f;
    dlt[r] = ok ? p.delta[(long long)bh * p.Tq + rows[r]] : 0.f;
  }

  auto load_tile = [&](int s, int k0) {
    bf16* dst = reinterpret_cast<bf16*>(ring + s * C::kStage2);
    stage_rows_any<kRB, DK, kRThreads>(p.vec, dst, kg, p.k_st, k0, p.Tk, D);
    stage_rows_any<kRB, DK, kRThreads>(p.vec, dst + C::kTile, vg, p.v_st, k0,
                                       p.Tk, D);
    if constexpr (kBias)
      stage_bias_any<bf16, kBLD>(p.bgran, dst + 2 * C::kTile, bg, p.bias_sq,
                                 q0, k0, p.Tq, p.Tk);
  };
  stage_rows_any<kRB, DK, kRThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq, D);
  stage_rows_any<kRB, DK, kRThreads>(p.vec, sG, gg, p.g_st, q0, p.Tq, D);
  load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const LaneOffsets<LD> lo(lane);
  // this warp's 16 queries: rows of Q and g, the A operands of S and dP
  const uint32_t qa = smem_addr(sQ) + warp * 16 * LD * 2 + lo.a;
  const uint32_t ga = smem_addr(sG) + warp * 16 * LD * 2 + lo.a;
  uint32_t qf[C::kHold ? C::KS : 1][4], gf[C::kHold ? C::KS : 1][4];
  if constexpr (C::kHold) {
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      ldmatrix_x4(qf[ks], qa + ks * 32);
      ldmatrix_x4(gf[ks], ga + ks * 32);
    }
  }
  float dq[C::NO][4];
#pragma unroll
  for (int t = 0; t < C::NO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;
  const int nv8 = (D + 7) / 8;

  for (int t = 0; t < nk; ++t) {
    const int stg = t & 1;
    if (t + 1 < nk) load_tile(stg ^ 1, (t + 1) * kRB);
    cp_async_commit();
    const int k0 = t * kRB;
    const unsigned char* st = ring + stg * C::kStage2;
    const uint32_t ks_ = smem_addr(st), vs_ = ks_ + 2 * C::kTile;
    const bf16* s_bias = reinterpret_cast<const bf16*>(st + 4 * C::kTile);

#pragma unroll 1
    for (int kc = 0; kc < kRB; kc += kRC) {
      // S = Q K^T and dP = g V^T: 16 queries x kRC keys
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores<DK, C::kHold>(s, dp, qf, gf, qa, ga,
                               ks_ + kc * LD * 2 + lo.nt,
                               vs_ + kc * LD * 2 + lo.nt);
      // dS*scale as bf16 A fragments (column pair j of S: keys k0 + kc +
      // 8j + 2(lane % 4), + 1); the unscaled dS into an own dbias slice
      uint32_t da[kRC / 16][4];
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j) {
        const int kl = kc + j * 8 + (lane & 3) * 2, key = k0 + kl;
        const bool key_ok[2] = {key < p.Tk, key + 1 < p.Tk};
        float de[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float bias2[2] = {0.f, 0.f};
          if constexpr (kBias) {
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
                s_bias + (row_l + 8 * r) * kBLD + kl);
            bias2[0] = __low2float(bb);
            bias2[1] = __high2float(bb);
          }
          const bool row_ok = rows[r] < p.Tq;
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[j][2 * r + c] * p.scale + bias2[c];
            const float pv = row_ok && key_ok[c] ? expf(x - lse[r]) : 0.f;
            ds[c] = pv * (dp[j][2 * r + c] - dlt[r]);
            de[2 * r + c] = ds[c] * p.scale;
          }
          if (kBias && dbg && row_ok && key_ok[0]) {
            float* at = dbg + (long long)rows[r] * p.Tk + key;
            if (key_ok[1] && pairs) {
              *reinterpret_cast<float2*>(at) = make_float2(ds[0], ds[1]);
            } else {
              at[0] = ds[0];
              if (key_ok[1]) at[1] = ds[1];
            }
          }
        }
        da[j >> 1][(j & 1) * 2] = pack_bf16(de[0], de[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(de[2], de[3]);
      }
      // dQ += (dS*scale) K
      product_d<DK>(dq, da, ks_ + kc * LD * 2 + lo.tr, nv8);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  write_rows<DK>(static_cast<bf16*>(p.dq) + (long long)bh * p.Tq * D, dq,
                 rows[0], p.Tq, D, lane);
}

// Shared memory of the dbias kernel: the bias tile, then a 2-stage ring of
// one row's Q, g, K, V tiles, lse and delta.
template <int DK>
struct DbiasCfg {
  static constexpr int kStage = 8 * RegCfg<DK, true>::kTile + 2 * kRB * 4;
  static constexpr int kSmem = kRB * kBLD * 2 + 2 * kStage;
};

// Pass 3, a bias slice shared by several (b, h) rows (one for all rows, or
// one per head): dbias of one [64 queries x 64 keys] tile of slice n, the
// unscaled dS of each row that shares it summed in f32 registers in row
// order and written once. Each row's Q, g, K, V tiles, lse and delta come
// through the 2-stage ring one row ahead; the bias tile is staged once.
// S and dP are recomputed (2 products): a block per tile, not per slice,
// fills the card, and no dbias partial goes through memory.
template <int DK>
__global__ void __launch_bounds__(kRThreads)
flash_bwd_dbias_reg_kernel(Params p, int n_rep) {
  using C = RegCfg<DK, true>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = C::LD;
  constexpr int kStage = DbiasCfg<DK>::kStage;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + kRB * kBLD * 2;  // [2][Q, g, K, V, lse, delta]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kRB - 1) / kRB, nk = (p.Tk + kRB - 1) / kRB;
  const int k0 = (blockIdx.x % nk) * kRB;
  const int q0 = (blockIdx.x / nk % nq) * kRB;
  const int n = blockIdx.x / (nk * nq);
  const int D = p.D;

  auto load_row = [&](int s, int rep) {
    const int bh = row_of(p.bias_mode, n, rep, p.H);
    const int b = bh / p.H, h = bh % p.H;
    bf16* dst = reinterpret_cast<bf16*>(ring + s * kStage);
    stage_rows_any<kRB, DK, kRThreads>(
        p.vec, dst, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
        p.q_st, q0, p.Tq, D);
    stage_rows_any<kRB, DK, kRThreads>(
        p.vec, dst + C::kTile,
        static_cast<const bf16*>(p.g) + b * p.g_sb + h * p.g_sh, p.g_st, q0,
        p.Tq, D);
    stage_rows_any<kRB, DK, kRThreads>(
        p.vec, dst + 2 * C::kTile,
        static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh, p.k_st, k0,
        p.Tk, D);
    stage_rows_any<kRB, DK, kRThreads>(
        p.vec, dst + 3 * C::kTile,
        static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh, p.v_st, k0,
        p.Tk, D);
    stage_row_stats(reinterpret_cast<float*>(dst + 4 * C::kTile),
                    p.lse + (long long)bh * p.Tq,
                    p.delta + (long long)bh * p.Tq, q0, p.Tq);
  };
  stage_bias_any<bf16, kBLD>(
      p.bgran, sB, static_cast<const bf16*>(p.bias) + n * p.bias_sn,
      p.bias_sq, q0, k0, p.Tq, p.Tk);
  load_row(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const LaneOffsets<LD> lo(lane);
  const int row_l = warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const bool row_ok[2] = {q0 + row_l < p.Tq, q0 + row_l + 8 < p.Tq};
  float bias[kRB / 8][4];  // this lane's bias values, as f32
  bool key_ok[kRB / 8][2];
#pragma unroll
  for (int j = 0; j < kRB / 8; ++j) {
    const int kl = j * 8 + (lane & 3) * 2;
    key_ok[j][0] = k0 + kl < p.Tk;
    key_ok[j][1] = k0 + kl + 1 < p.Tk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
          sB + (row_l + 8 * r) * kBLD + kl);
      bias[j][2 * r] = __low2float(bb);
      bias[j][2 * r + 1] = __high2float(bb);
    }
  }
  float acc[kRB / 8][4];
#pragma unroll
  for (int j = 0; j < kRB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 1
  for (int rep = 0; rep < n_rep; ++rep) {
    const int stg = rep & 1;
    if (rep + 1 < n_rep) load_row(stg ^ 1, rep + 1);
    cp_async_commit();
    const unsigned char* st = ring + stg * kStage;
    const uint32_t qs = smem_addr(st), gs = qs + 2 * C::kTile,
                   ks_ = qs + 4 * C::kTile, vs_ = qs + 6 * C::kTile;
    const float* s_lse = reinterpret_cast<const float*>(st + 8 * C::kTile);
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse[r] = s_lse[row_l + 8 * r];
      dlt[r] = s_lse[kRB + row_l + 8 * r];
    }
#pragma unroll
    for (int kc = 0; kc < kRB; kc += kRC) {
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores<DK, false>(s, dp, nullptr, nullptr,
                            qs + warp * 16 * LD * 2 + lo.a,
                            gs + warp * 16 * LD * 2 + lo.a,
                            ks_ + kc * LD * 2 + lo.nt,
                            vs_ + kc * LD * 2 + lo.nt);
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jt = kc / 8 + j, r = e >> 1, c = e & 1;
          const float x = s[j][e] * p.scale + bias[jt][e];
          const float pv =
              row_ok[r] && key_ok[jt][c] ? expf(x - lse[r]) : 0.f;
          acc[jt][e] += pv * (dp[j][e] - dlt[r]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  float* dbg = p.dbias + (long long)n * p.Tq * p.Tk;
  const bool pairs = (p.Tk & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* drow = dbg + (long long)(q0 + row_l + 8 * r) * p.Tk + k0;
#pragma unroll
    for (int j = 0; j < kRB / 8; ++j) {
      const int kl = j * 8 + (lane & 3) * 2;
      if (!key_ok[j][0]) continue;
      if (key_ok[j][1] && pairs) {
        *reinterpret_cast<float2*>(drow + kl) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        drow[kl] = acc[j][2 * r];
        if (key_ok[j][1]) drow[kl + 1] = acc[j][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (TF32) at D <= 128: the bf16 register design on m16n8k8

constexpr int kTBLD = kRB + 4;     // row stride of an f32 bias tile, floats
constexpr int kSmemMax = 232448;   // shared memory a block may use
constexpr int kSmemHalf = 115712;  // the same with two blocks an SM (228 KB
                                   // an SM, 1 KB of it a block's own)
constexpr int kTf32Round = 4;      // copies a thread rounds at once

// Ring stages (bytes `stage` each, beside `fixed` bytes of resident tiles):
// the most blocks an SM first, then the deeper ring. Two stages where two
// blocks an SM still fit, one where only one stage lets two fit, else two
// where they fit a block's limit.
constexpr int tf32_stages(int fixed, int stage) {
  return fixed + 2 * stage <= kSmemHalf   ? 2
         : fixed + stage <= kSmemHalf     ? 1
         : fixed + 2 * stage <= kSmemMax ? 2
                                          : 1;
}

// Blocks an SM the passes are compiled for: four at D <= 32 unbiased (the
// decoder's 64 x 64 site; 128 registers a thread, 56 KB of shared memory),
// else one, which leaves ptxas all 255 registers (without a minimum it held
// some instances to 168 and spilled; the dbias kernel takes one too). On
// an H100 the passes at [60, 1, 4096, 4096, 32] took 5.86-5.95 ms against
// 6.44-6.58 without the bound, at [60, 1, 1024, 1024, 64] 0.914 against
// 0.985-0.988 (tools/torch_flash_bwd_variants.py).
template <int DK, bool kBias>
constexpr int kTf32MinBlocks = DK <= 32 && !kBias ? 4 : 1;

template <int DK, bool kBias>  // DK: the head dim padded to 32, 64 or 128
struct Tf32Cfg {
  // row stride in floats, 4 x an odd number: an ldmatrix phase (8 rows of
  // 16 bytes) and the k-major B reads (rows 2t and 2t + 1, column g) each
  // hit 32 distinct banks
  static constexpr int LD = DK + 4;
  static constexpr int kTile = kRB * LD;  // floats of a [64][LD] tile
  static constexpr int kBias4 = kBias ? 4 * kRB * kTBLD : 0;  // bytes
  // pass 1: K and V resident; a stage holds Q, g, lse, delta and the bias
  static constexpr int kStage1 = 4 * (2 * kTile + 2 * kRB) + kBias4;
  static constexpr int kS1 = tf32_stages(8 * kTile, kStage1);
  static constexpr int kSmem1 = 8 * kTile + kS1 * kStage1;
  // pass 2: Q and g resident; a stage holds K, V and the bias
  static constexpr int kStage2 = 8 * kTile + kBias4;
  static constexpr int kS2 = tf32_stages(8 * kTile, kStage2);
  static constexpr int kSmem2 = 8 * kTile + kS2 * kStage2;
  // pass 3 (dbias): the bias tile resident; a stage holds one row's Q, g,
  // K, V, lse and delta
  static constexpr int kStage3 = 4 * (4 * kTile + 2 * kRB);
  static constexpr int kS3 = tf32_stages(4 * kRB * kTBLD, kStage3);
  static constexpr int kSmem3 = 4 * kRB * kTBLD + kS3 * kStage3;
  static_assert(kSmem1 <= kSmemMax && kSmem2 <= kSmemMax &&
                kSmem3 <= kSmemMax, "a block's shared memory");
};

// Float offsets of this lane's ldmatrix row address in a [rows][LD] f32
// tile, and of its k-major B element. ldmatrix of 8 x 8 b16 matrices reads
// 8-row x 4-float ones, lane l receiving element (l / 4, l % 4) of each:
//   a:  an A fragment (16 rows x 8 columns) in one x4: the matrices are
//       rows 0-7 and 8-15 of columns 0-3, then of columns 4-7;
//   nt: the B fragments of two k8 steps of one n8 tile from [n][k] rows:
//       columns 0-3, 4-7, 8-11, 12-15 of 8 rows;
//   kt: a B element from [k][n] rows in the key permutation of
//       mma_sm80.cuh, row 2t and column g (b1 is the row after).
template <int LD>
struct Tf32Lanes {
  int a, nt, kt;
  __device__ explicit Tf32Lanes(int lane)
      : a(((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4),
        nt((lane & 7) * LD + (lane >> 4) * 8 + ((lane >> 3) & 1) * 4),
        kt(2 * (lane & 3) * LD + (lane >> 2)) {}
};

// One 16-row x kRC-column block of two scores, c1 = A1 B1^T and c2 =
// A2 B2^T, over the first kd8 k8 steps of the head dim (D padded to 8):
// A1, A2 the warp's 16 resident rows (an ldmatrix A fragment at a1, a2
// each step), B1, B2 kRC rows of ring tiles at b1, b2 ([n][k], ldmatrix).
// Byte addresses; the tiles are rounded to TF32 already.
template <int DK>
__device__ __forceinline__ void two_scores_tf32(float (&c1)[kRC / 8][4],
                                                float (&c2)[kRC / 8][4],
                                                uint32_t a1, uint32_t a2,
                                                uint32_t b1, uint32_t b2,
                                                int kd8) {
  constexpr int LD = DK + 4;
#pragma unroll
  for (int j = 0; j < kRC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DK / 8; ks += 2) {
    if (ks >= kd8) continue;
    const bool two = ks + 1 < kd8;  // the pair's second step within D
    uint32_t x1[2][4], x2[2][4];
    ldmatrix_x4(x1[0], a1 + ks * 32);
    ldmatrix_x4(x2[0], a2 + ks * 32);
    if (two) {
      ldmatrix_x4(x1[1], a1 + ks * 32 + 32);
      ldmatrix_x4(x2[1], a2 + ks * 32 + 32);
    }
#pragma unroll
    for (int j = 0; j < kRC / 8; ++j) {
      const uint32_t off = (j * 8 * LD + ks * 8) * 4;
      uint32_t r[4];
      ldmatrix_x4(r, b1 + off);
      mma_tf32(c1[j], x1[0], r);
      if (two) mma_tf32(c1[j], x1[1], r + 2);
      ldmatrix_x4(r, b2 + off);
      mma_tf32(c2[j], x2[0], r);
      if (two) mma_tf32(c2[j], x2[1], r + 2);
    }
  }
}

// A C fragment (c0, c1 at columns 2t, 2t + 1; c2, c3 the same 8 rows on)
// rounded to TF32 as the A fragment of one k8 step, a = (c0, c2, c1, c3):
// A's k index t stands for column 2t, t + 4 for column 2t + 1.
__device__ __forceinline__ void c_to_a_tf32(uint32_t (&a)[4],
                                            const float (&c)[4]) {
  a[0] = to_tf32(c[0]);
  a[1] = to_tf32(c[2]);
  a[2] = to_tf32(c[1]);
  a[3] = to_tf32(c[3]);
}

// acc += A B over the first nv8 n8 tiles of D: A the kRC / 8 A fragments of
// c_to_a_tf32 (k8 step j), B kRC rows of a [k][n] tile read in their order:
// step j's b0 from row 8j + 2t, b1 from row 8j + 2t + 1 (b: this lane's
// byte address of row 2t, column g). B's reads go in groups of up to 8 n8
// tiles ahead of their products (16 registers).
template <int DK>
__device__ __forceinline__ void product_d_tf32(float (&acc)[DK / 8][4],
                                               const uint32_t (&a)[kRC / 8][4],
                                               uint32_t b, int nv8) {
  constexpr int LD = DK + 4, NO = DK / 8, NG = NO < 8 ? NO : 8;
#pragma unroll
  for (int j = 0; j < kRC / 8; ++j)
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      if (n0 >= nv8) continue;
      uint32_t bv[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        if (n0 + n >= nv8) continue;
        bv[n][0] = lds_b32(b + (j * 8 * LD + (n0 + n) * 8) * 4);
        bv[n][1] = lds_b32(b + ((j * 8 + 1) * LD + (n0 + n) * 8) * 4);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
        if (n0 + n < nv8) mma_tf32(acc[n0 + n], a[j], bv[n]);
    }
}

// Pass 1: dK and dV of 64 keys of one (b, h), 16 keys a warp. K and V are
// staged once and rounded to TF32 in shared memory; Q, g, lse, delta (and
// the bias's [64 queries x 64 keys] block) of each 64-query tile come
// through a ring of kS1 stages, Q and g rounded there once a tile, each
// thread its own copies. Per 32-query chunk a warp computes S^T = K Q^T and
// dP^T = V g^T into registers (K and V as ldmatrix A fragments, Q and g as
// ldmatrix B fragments), P^T = exp(S^T*scale + bias^T - lse) with the
// accurate expf and dS^T*scale = P^T (dP^T - delta) scale in place, rounds
// both to TF32 as A fragments (c_to_a_tf32), and adds P^T g into dV and
// (dS^T*scale) Q into dK (g and Q by scalar reads of rows 2t and 2t + 1).
// dK and dV are f32 register accumulators over the query loop, written
// once.
template <int DK, bool kBias>
__global__ void __launch_bounds__(kRThreads, (kTf32MinBlocks<DK, kBias>))
flash_bwd_dkdv_tf32_kernel(Params p) {
  using C = Tf32Cfg<DK, kBias>;
  constexpr int LD = C::LD, S = C::kS1, kStage = C::kStage1 / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + C::kTile;
  float* ring = sV + C::kTile;  // [S][Q, g, lse, delta, bias]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (p.Tk + kRB - 1) / kRB;
  const int k0 = (blockIdx.x % nk) * kRB;
  const int bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const float* bg = kBias ? static_cast<const float*>(p.bias) +
                                bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                          : nullptr;
  const int nq = (p.Tq + kRB - 1) / kRB;

  auto load_tile = [&](int s, int q0) {
    float* dst = ring + s * kStage;
    stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, dst, qg, p.q_st, q0, p.Tq,
                                           D);
    stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, dst + C::kTile, gg, p.g_st,
                                           q0, p.Tq, D);
    stage_row_stats(dst + 2 * C::kTile, lse, delta, q0, p.Tq);
    if constexpr (kBias)
      stage_bias_any<float, kTBLD>(p.bgran, dst + 2 * C::kTile + 2 * kRB, bg,
                                   p.bias_sq, q0, k0, p.Tq, p.Tk);
  };
  auto round_tile = [&](float* tile) {
    round_rows_tf32_any<kRB, DK, LD, kRThreads, kTf32Round>(p.vec, tile);
  };

  stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, sK, kg, p.k_st, k0, p.Tk, D);
  stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, sV, vg, p.v_st, k0, p.Tk, D);
  load_tile(0, 0);
  cp_async_commit();
  cp_async_wait_mem<0>();
  round_tile(sK);
  round_tile(sV);
  round_tile(ring);
  round_tile(ring + C::kTile);
  __syncthreads();

  const Tf32Lanes<LD> lo(lane);
  // this warp's 16 keys: rows of K and V, the A operands of S^T and dP^T
  const uint32_t ka = smem_addr(sK + warp * 16 * LD + lo.a);
  const uint32_t va = smem_addr(sV + warp * 16 * LD + lo.a);
  float dk[DK / 8][4], dv[DK / 8][4];
#pragma unroll
  for (int t = 0; t < DK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
  const int kd8 = (D + 7) / 8;  // k8 steps of S and dP, n8 tiles of D
  const int tl = lane & 3;
  const int key_l = warp * 16 + (lane >> 2);  // this lane's keys: +0, +8
  const bool key_ok[2] = {k0 + key_l < p.Tk, k0 + key_l + 8 < p.Tk};

  for (int t = 0; t < nq; ++t) {
    const int stg = S == 2 ? t & 1 : 0;
    if (S == 2 && t + 1 < nq) load_tile(stg ^ 1, (t + 1) * kRB);
    cp_async_commit();
    const int q0 = t * kRB;
    const float* st = ring + stg * kStage;
    const uint32_t qs = smem_addr(st), gs = qs + 4 * C::kTile;
    const float* s_lse = st + 2 * C::kTile;
    const float* s_delta = s_lse + kRB;
    const float* s_bias = s_lse + 2 * kRB;

#pragma unroll 1
    for (int qc = 0; qc < kRB; qc += kRC) {
      // S^T = K Q^T and dP^T = V g^T: 16 keys x kRC queries
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores_tf32<DK>(s, dp, ka, va, qs + (qc * LD + lo.nt) * 4,
                          gs + (qc * LD + lo.nt) * 4, kd8);
      // P^T and dS^T*scale (column pair j: queries qc + 8j + 2t, + 1), as
      // the TF32 A fragments of kRC / 8 k8 steps
      uint32_t pa[kRC / 8][4], da[kRC / 8][4];
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j) {
        const int ql = qc + j * 8 + tl * 2;
        const float2 ls = *reinterpret_cast<const float2*>(s_lse + ql);
        const float2 dl = *reinterpret_cast<const float2*>(s_delta + ql);
        const bool q_ok[2] = {q0 + ql < p.Tq, q0 + ql + 1 < p.Tq};
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1, r = e >> 1;
          float x = s[j][e] * p.scale;
          if constexpr (kBias) x += s_bias[(ql + c) * kTBLD + key_l + 8 * r];
          const float pv =
              key_ok[r] && q_ok[c] ? expf(x - (c ? ls.y : ls.x)) : 0.f;
          pe[e] = pv;
          de[e] = pv * (dp[j][e] - (c ? dl.y : dl.x)) * p.scale;
        }
        c_to_a_tf32(pa[j], pe);
        c_to_a_tf32(da[j], de);
      }
      // dV += P^T g, dK += (dS^T*scale) Q
      product_d_tf32<DK>(dv, pa, gs + (qc * LD + lo.kt) * 4, kd8);
      product_d_tf32<DK>(dk, da, qs + (qc * LD + lo.kt) * 4, kd8);
    }
    if (S == 1) {  // every warp is done with the one stage
      __syncthreads();
      if (t + 1 < nq) load_tile(0, (t + 1) * kRB);
      cp_async_commit();
    }
    cp_async_wait_mem<0>();
    if (t + 1 < nq) {
      float* next = ring + (S == 2 ? stg ^ 1 : 0) * kStage;
      round_tile(next);
      round_tile(next + C::kTile);
    }
    __syncthreads();
  }

  const long long out = (long long)bh * p.Tk * D;
  write_rows<DK>(p.dk + out, dk, k0 + key_l, p.Tk, D, lane);
  write_rows<DK>(p.dv + out, dv, k0 + key_l, p.Tk, D, lane);
}

// Pass 2: dQ of 64 queries of one (b, h), 16 queries a warp, and with a
// bias of its own (one slice per (b, h)) the rows of dbias they own. Q and
// g are staged once and rounded, lse and delta sit in registers, and K, V
// (and the bias block) come through a ring of kS2 stages, K and V rounded
// there once a tile. S and dP, then dS = P (dP - delta) in registers, and
// dQ += (dS*scale) K with dS*scale as the A fragments of c_to_a_tf32 and
// K by scalar reads of rows 2t and 2t + 1; dQ is an f32 register
// accumulator written once.
template <int DK, bool kBias>
__global__ void __launch_bounds__(kRThreads, (kTf32MinBlocks<DK, kBias>))
flash_bwd_dq_tf32_kernel(Params p) {
  using C = Tf32Cfg<DK, kBias>;
  constexpr int LD = C::LD, S = C::kS2, kStage = C::kStage2 / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + C::kTile;
  float* ring = sG + C::kTile;  // [S][K, V, bias]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kRB - 1) / kRB;
  const int q0 = (blockIdx.x % nq) * kRB;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int nk = (p.Tk + kRB - 1) / kRB;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* bg = kBias ? static_cast<const float*>(p.bias) +
                                bias_slice(p.bias_mode, bh, p.H) * p.bias_sn
                          : nullptr;
  // dS is this block's dbias only where each (b, h) has its own slice;
  // shared slices take theirs from flash_bwd_dbias_tf32_kernel
  float* dbg = kBias && p.bias_mode == 3
                   ? p.dbias + (long long)bh * p.Tq * p.Tk : nullptr;
  const bool pairs = (p.Tk & 1) == 0;  // dbias rows start 8-byte aligned
  const int tl = lane & 3;
  const int row_l = warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const int rows[2] = {q0 + row_l, q0 + row_l + 8};
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < p.Tq;
    lse[r] = ok ? p.lse[(long long)bh * p.Tq + rows[r]] : 0.f;
    dlt[r] = ok ? p.delta[(long long)bh * p.Tq + rows[r]] : 0.f;
  }

  auto load_tile = [&](int s, int k0) {
    float* dst = ring + s * kStage;
    stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, dst, kg, p.k_st, k0, p.Tk,
                                           D);
    stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, dst + C::kTile, vg, p.v_st,
                                           k0, p.Tk, D);
    if constexpr (kBias)
      stage_bias_any<float, kTBLD>(p.bgran, dst + 2 * C::kTile, bg,
                                   p.bias_sq, q0, k0, p.Tq, p.Tk);
  };
  auto round_tile = [&](float* tile) {
    round_rows_tf32_any<kRB, DK, LD, kRThreads, kTf32Round>(p.vec, tile);
  };
  stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq, D);
  stage_rows_f32<kRB, DK, LD, kRThreads>(p.vec, sG, gg, p.g_st, q0, p.Tq, D);
  load_tile(0, 0);
  cp_async_commit();
  cp_async_wait_mem<0>();
  round_tile(sQ);
  round_tile(sG);
  round_tile(ring);
  round_tile(ring + C::kTile);
  __syncthreads();

  const Tf32Lanes<LD> lo(lane);
  // this warp's 16 queries: rows of Q and g, the A operands of S and dP
  const uint32_t qa = smem_addr(sQ + warp * 16 * LD + lo.a);
  const uint32_t ga = smem_addr(sG + warp * 16 * LD + lo.a);
  float dq[DK / 8][4];
#pragma unroll
  for (int t = 0; t < DK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;
  const int kd8 = (D + 7) / 8;

  for (int t = 0; t < nk; ++t) {
    const int stg = S == 2 ? t & 1 : 0;
    if (S == 2 && t + 1 < nk) load_tile(stg ^ 1, (t + 1) * kRB);
    cp_async_commit();
    const int k0 = t * kRB;
    const float* st = ring + stg * kStage;
    const uint32_t ks_ = smem_addr(st), vs_ = ks_ + 4 * C::kTile;
    const float* s_bias = st + 2 * C::kTile;

#pragma unroll 1
    for (int kc = 0; kc < kRB; kc += kRC) {
      // S = Q K^T and dP = g V^T: 16 queries x kRC keys
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores_tf32<DK>(s, dp, qa, ga, ks_ + (kc * LD + lo.nt) * 4,
                          vs_ + (kc * LD + lo.nt) * 4, kd8);
      // dS*scale as TF32 A fragments (column pair j of S: keys k0 + kc +
      // 8j + 2t, + 1); the unscaled dS into an own dbias slice
      uint32_t da[kRC / 8][4];
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j) {
        const int kl = kc + j * 8 + tl * 2, key = k0 + kl;
        const bool key_ok[2] = {key < p.Tk, key + 1 < p.Tk};
        float de[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 bias2 = make_float2(0.f, 0.f);
          if constexpr (kBias)
            bias2 = *reinterpret_cast<const float2*>(
                s_bias + (row_l + 8 * r) * kTBLD + kl);
          const bool row_ok = rows[r] < p.Tq;
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[j][2 * r + c] * p.scale + (c ? bias2.y : bias2.x);
            const float pv = row_ok && key_ok[c] ? expf(x - lse[r]) : 0.f;
            ds[c] = pv * (dp[j][2 * r + c] - dlt[r]);
            de[2 * r + c] = ds[c] * p.scale;
          }
          if (kBias && dbg && row_ok && key_ok[0]) {
            float* at = dbg + (long long)rows[r] * p.Tk + key;
            if (key_ok[1] && pairs) {
              *reinterpret_cast<float2*>(at) = make_float2(ds[0], ds[1]);
            } else {
              at[0] = ds[0];
              if (key_ok[1]) at[1] = ds[1];
            }
          }
        }
        c_to_a_tf32(da[j], de);
      }
      // dQ += (dS*scale) K
      product_d_tf32<DK>(dq, da, ks_ + (kc * LD + lo.kt) * 4, kd8);
    }
    if (S == 1) {  // every warp is done with the one stage
      __syncthreads();
      if (t + 1 < nk) load_tile(0, (t + 1) * kRB);
      cp_async_commit();
    }
    cp_async_wait_mem<0>();
    if (t + 1 < nk) {
      float* next = ring + (S == 2 ? stg ^ 1 : 0) * kStage;
      round_tile(next);
      round_tile(next + C::kTile);
    }
    __syncthreads();
  }
  write_rows<DK>(static_cast<float*>(p.dq) + (long long)bh * p.Tq * D, dq,
                 rows[0], p.Tq, D, lane);
}

// Pass 3, a bias slice shared by several (b, h) rows (one for all rows, or
// one per head): dbias of one [64 queries x 64 keys] tile of slice n, the
// unscaled dS of each row that shares it summed in f32 registers in row
// order and written once. Each row's Q, g, K, V tiles (rounded to TF32
// there), lse and delta come through a ring of kS3 stages; the bias tile
// is staged once and read into registers. Two products a row (S and dP).
template <int DK>
__global__ void __launch_bounds__(kRThreads, 1)
flash_bwd_dbias_tf32_kernel(Params p, int n_rep) {
  using C = Tf32Cfg<DK, true>;
  constexpr int LD = C::LD, S = C::kS3, kStage = C::kStage3 / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sB = reinterpret_cast<float*>(smem);
  float* ring = sB + kRB * kTBLD;  // [S][Q, g, K, V, lse, delta]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kRB - 1) / kRB, nk = (p.Tk + kRB - 1) / kRB;
  const int k0 = (blockIdx.x % nk) * kRB;
  const int q0 = (blockIdx.x / nk % nq) * kRB;
  const int n = blockIdx.x / (nk * nq);
  const int D = p.D;

  auto load_row = [&](int s, int rep) {
    const int bh = row_of(p.bias_mode, n, rep, p.H);
    const int b = bh / p.H, h = bh % p.H;
    float* dst = ring + s * kStage;
    stage_rows_f32<kRB, DK, LD, kRThreads>(
        p.vec, dst, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
        p.q_st, q0, p.Tq, D);
    stage_rows_f32<kRB, DK, LD, kRThreads>(
        p.vec, dst + C::kTile,
        static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh, p.g_st, q0,
        p.Tq, D);
    stage_rows_f32<kRB, DK, LD, kRThreads>(
        p.vec, dst + 2 * C::kTile,
        static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh, p.k_st, k0,
        p.Tk, D);
    stage_rows_f32<kRB, DK, LD, kRThreads>(
        p.vec, dst + 3 * C::kTile,
        static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh, p.v_st, k0,
        p.Tk, D);
    stage_row_stats(dst + 4 * C::kTile, p.lse + (long long)bh * p.Tq,
                    p.delta + (long long)bh * p.Tq, q0, p.Tq);
  };
  auto round_row = [&](int s) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i)
      round_rows_tf32_any<kRB, DK, LD, kRThreads, kTf32Round>(
          p.vec, ring + s * kStage + i * C::kTile);
  };
  stage_bias_any<float, kTBLD>(
      p.bgran, sB, static_cast<const float*>(p.bias) + n * p.bias_sn,
      p.bias_sq, q0, k0, p.Tq, p.Tk);
  load_row(0, 0);
  cp_async_commit();
  cp_async_wait_mem<0>();
  round_row(0);
  __syncthreads();

  const Tf32Lanes<LD> lo(lane);
  const int kd8 = (D + 7) / 8;
  const int row_l = warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const bool row_ok[2] = {q0 + row_l < p.Tq, q0 + row_l + 8 < p.Tq};
  float bias[kRB / 8][4];  // this lane's bias values
  bool key_ok[kRB / 8][2];
#pragma unroll
  for (int j = 0; j < kRB / 8; ++j) {
    const int kl = j * 8 + (lane & 3) * 2;
    key_ok[j][0] = k0 + kl < p.Tk;
    key_ok[j][1] = k0 + kl + 1 < p.Tk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 bb =
          *reinterpret_cast<const float2*>(sB + (row_l + 8 * r) * kTBLD + kl);
      bias[j][2 * r] = bb.x;
      bias[j][2 * r + 1] = bb.y;
    }
  }
  float acc[kRB / 8][4];
#pragma unroll
  for (int j = 0; j < kRB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 1
  for (int rep = 0; rep < n_rep; ++rep) {
    const int stg = S == 2 ? rep & 1 : 0;
    if (S == 2 && rep + 1 < n_rep) load_row(stg ^ 1, rep + 1);
    cp_async_commit();
    const float* st = ring + stg * kStage;
    const uint32_t qs = smem_addr(st), gs = qs + 4 * C::kTile,
                   ks_ = qs + 8 * C::kTile, vs_ = qs + 12 * C::kTile;
    const float* s_lse = st + 4 * C::kTile;
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse[r] = s_lse[row_l + 8 * r];
      dlt[r] = s_lse[kRB + row_l + 8 * r];
    }
#pragma unroll
    for (int kc = 0; kc < kRB; kc += kRC) {
      float s[kRC / 8][4], dp[kRC / 8][4];
      two_scores_tf32<DK>(s, dp, qs + (warp * 16 * LD + lo.a) * 4,
                          gs + (warp * 16 * LD + lo.a) * 4,
                          ks_ + (kc * LD + lo.nt) * 4,
                          vs_ + (kc * LD + lo.nt) * 4, kd8);
#pragma unroll
      for (int j = 0; j < kRC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jt = kc / 8 + j, r = e >> 1, c = e & 1;
          const float x = s[j][e] * p.scale + bias[jt][e];
          const float pv =
              row_ok[r] && key_ok[jt][c] ? expf(x - lse[r]) : 0.f;
          acc[jt][e] += pv * (dp[j][e] - dlt[r]);
        }
    }
    if (S == 1) {  // every warp is done with the one stage
      __syncthreads();
      if (rep + 1 < n_rep) load_row(0, rep + 1);
      cp_async_commit();
    }
    cp_async_wait_mem<0>();
    if (rep + 1 < n_rep) round_row(S == 2 ? stg ^ 1 : 0);
    __syncthreads();
  }

  float* dbg = p.dbias + (long long)n * p.Tq * p.Tk;
  const bool pairs = (p.Tk & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* drow = dbg + (long long)(q0 + row_l + 8 * r) * p.Tk + k0;
#pragma unroll
    for (int j = 0; j < kRB / 8; ++j) {
      const int kl = j * 8 + (lane & 3) * 2;
      if (!key_ok[j][0]) continue;
      if (key_ok[j][1] && pairs) {
        *reinterpret_cast<float2*>(drow + kl) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        drow[kl] = acc[j][2 * r];
        if (key_ok[j][1]) drow[kl + 1] = acc[j][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (TF32) at 128 < D <= 512, unbiased: the accumulators and the depth of
// S and dP split by columns across 8 warps

constexpr int kXB = 16;              // rows a block owns (keys, then
                                     // queries) and rows of a ring tile
constexpr int kXThreads = 256;       // 8 warps, 64 columns of D each
constexpr int kXWarps = kXThreads / 32;
constexpr int kXDK = 512;            // the head dim padded in shared memory
constexpr int kXLD = kXDK + 4;       // row stride in floats, as the forward's
constexpr int kXStages = 3;          // ring tiles in flight: two ahead
constexpr int kXTile = kXB * kXLD;   // floats of a [16][kXLD] tile
// a ring stage: two operand tiles (pass 1: Q, g; pass 2: K, V), then
// (pass 1) the 16 queries' lse and delta
constexpr int kXStage = 2 * kXTile + 2 * kXB;
constexpr int kXLDS = kXB + 8;       // row stride of the partials, P and dS
constexpr int kXPart = kXWarps * kXB * kXLDS;  // floats of one partial set
constexpr int kXSmem = 4 * (kXStages * kXStage + 2 * kXPart + 2 * kXB * kXLDS);
static_assert(2 * kXTile <= kXStage, "the resident tiles are staged in the "
                                     "last stage");
static_assert(kXB * kXB == kXThreads, "one element of S a thread");

// A warp's 64 columns of two resident [16][kXLD] tiles as TF32 A fragments
// (8 k8 steps of the 16 rows each): x0 of `a`, x1 of `b`.
__device__ __forceinline__ void hold_tf32(uint32_t (&x0)[8][4],
                                          uint32_t (&x1)[8][4],
                                          const float* a, const float* b,
                                          int col0, int lane) {
  const int off = (lane >> 2) * kXLD + col0 + (lane & 3);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const float* pa = a + off + ks * 8;
    const float* pb = b + off + ks * 8;
    x0[ks][0] = to_tf32(pa[0]);
    x0[ks][1] = to_tf32(pa[8 * kXLD]);
    x0[ks][2] = to_tf32(pa[4]);
    x0[ks][3] = to_tf32(pa[8 * kXLD + 4]);
    x1[ks][0] = to_tf32(pb[0]);
    x1[ks][1] = to_tf32(pb[8 * kXLD]);
    x1[ks][2] = to_tf32(pb[4]);
    x1[ks][3] = to_tf32(pb[8 * kXLD + 4]);
  }
}

// This warp's 64-column shares of c1 = A1 B1^T and c2 = A2 B2^T, [16 x 16]
// each: A1, A2 the held fragments, B1, B2 two ring tiles [16][kXLD] (rows
// the n index) read by ldmatrix and rounded to TF32 in registers; then
// both written to the partial sets p1, p2 ([warp][16][kXLDS], C layout).
__device__ __forceinline__ void two_partials(const uint32_t (&f1)[8][4],
                                             const uint32_t (&f2)[8][4],
                                             const float* b1, const float* b2,
                                             float* p1, float* p2, int col0,
                                             int warp, int lane) {
  float c1[2][4], c2[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
  // this lane's ldmatrix row: matrix lane / 8 is (k8 step lane / 16, half
  // (lane / 8) % 2) of 8 rows
  const int lrow = (lane & 7) * kXLD + col0 + (lane >> 4) * 8 +
                   ((lane >> 3) & 1) * 4;
  const uint32_t a1 = smem_addr(b1 + lrow), a2 = smem_addr(b2 + lrow);
#pragma unroll
  for (int ks = 0; ks < 8; ks += 2)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t r1[4], r2[4];
      ldmatrix_x4(r1, a1 + (j * 8 * kXLD + ks * 8) * 4);
      ldmatrix_x4(r2, a2 + (j * 8 * kXLD + ks * 8) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r1[e] = to_tf32(__uint_as_float(r1[e]));
        r2[e] = to_tf32(__uint_as_float(r2[e]));
      }
      mma_tf32(c1[j], f1[ks], r1);
      mma_tf32(c1[j], f1[ks + 1], r1 + 2);
      mma_tf32(c2[j], f2[ks], r2);
      mma_tf32(c2[j], f2[ks + 1], r2 + 2);
    }
  const int at = warp * kXB * kXLDS + (lane >> 2) * kXLDS + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<float2*>(p1 + at + j * 8) = make_float2(c1[j][0], c1[j][1]);
    *reinterpret_cast<float2*>(p1 + at + 8 * kXLDS + j * 8) =
        make_float2(c1[j][2], c1[j][3]);
    *reinterpret_cast<float2*>(p2 + at + j * 8) = make_float2(c2[j][0], c2[j][1]);
    *reinterpret_cast<float2*>(p2 + at + 8 * kXLDS + j * 8) =
        make_float2(c2[j][2], c2[j][3]);
  }
}

// acc += A B on this warp's 64 columns: A [16 x 16] from a [16][kXLDS]
// tile already rounded to TF32, its k index t standing for column 2t and
// t + 4 for 2t + 1 (the key permutation of mma_sm80.cuh), B the rows of a
// ring tile [16][kXLD] (k x n), read as rows 2t and 2t + 1 and rounded to
// TF32 in registers.
__device__ __forceinline__ void product_cols(float (&acc)[8][4],
                                             const float* a, const float* b,
                                             int col0, int lane) {
  const int g = lane >> 2, tl = lane & 3;
  const uint32_t b_addr = smem_addr(b + 2 * tl * kXLD + col0 + g);
#pragma unroll
  for (int j = 0; j < kXB / 8; ++j) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + g * kXLDS + j * 8 + 2 * tl);
    const float2 x1 =
        *reinterpret_cast<const float2*>(a + (g + 8) * kXLDS + j * 8 + 2 * tl);
    const uint32_t af[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                            __float_as_uint(x0.y), __float_as_uint(x1.y)};
    uint32_t bf[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      bf[n][0] = to_tf32(__uint_as_float(lds_b32(b_addr + (j * 8 * kXLD + n * 8) * 4)));
      bf[n][1] = to_tf32(__uint_as_float(
          lds_b32(b_addr + ((j * 8 + 1) * kXLD + n * 8) * 4)));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32(acc[n], af, bf[n]);
  }
}

// Write a warp's [16 x 64] f32 accumulator (rows row0 + lane / 4 and + 8,
// columns col0 ..) to [n, D] rows at out; rows past n and columns past D
// are not written.
__device__ __forceinline__ void write_cols(float* out, const float (&acc)[8][4],
                                           int row0, int n, int col0, int D,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= n) continue;
    float* orow = out + (long long)row * D;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = col0 + t * 8 + (lane & 3) * 2;
      if (col >= D) continue;
      const float v0 = acc[t][2 * r], v1 = acc[t][2 * r + 1];
      if (col + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        orow[col] = v0;
        if (col + 1 < D) orow[col + 1] = v1;
      }
    }
  }
}

// The element of a [16 x 16] block this thread reduces: row rr, column cc.
// A warp takes rows r and r + 2 (16 banks apart in a kXLDS-float row), so
// its reads of the partials take one pass.
__device__ __forceinline__ int reduce_row() {
  const int warp = threadIdx.x >> 5;
  return 4 * (warp >> 1) + (warp & 1) + 2 * ((threadIdx.x >> 4) & 1);
}

// Sum of the first nw warps' partials at offset `at`, in warp order.
__device__ __forceinline__ float sum_partials(const float* part, int at,
                                              int nw) {
  float x = part[at];
  for (int w = 1; w < nw; ++w) x += part[w * kXB * kXLDS + at];
  return x;
}

// Pass 1: dK and dV of 16 keys of one (b, h). Warp w owns columns 64w ..
// 64w + 63 of D: it holds K's and V's as TF32 A fragments (64 registers)
// and the f32 dK and dV accumulators of those columns (64). Q, g, lse and
// delta of each 16-query tile come through a 3-stage cp.async ring, two
// tiles ahead. Per tile: each warp adds its columns' share of S^T = K Q^T
// and dP^T = V g^T (keys x queries; Q and g by ldmatrix) and writes the
// two partials; after a barrier every thread sums one element of each over
// the warps in warp order, and writes P^T = exp(S^T*scale - lse) and
// dS^T*scale = P^T (dP^T - delta) scale (zero past Tq and Tk) rounded to
// TF32; after a second barrier (which also publishes the next tile) each
// warp adds P^T g into dV and (dS^T*scale) Q into dK on its columns.
__global__ void __launch_bounds__(kXThreads, 1)
flash_bwd_dkdv_wide_tf32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [stage][Q, g, lse, delta]
  float* sPartS = ring + kXStages * kXStage;
  float* sPartP = sPartS + kXPart;
  float* sP = sPartP + kXPart;   // P^T [16 keys][kXLDS]
  float* sdS = sP + kXB * kXLDS;  // dS^T * scale

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (p.Tk + kXB - 1) / kXB;
  const int k0 = (blockIdx.x % nk) * kXB;
  const int bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + (long long)bh * p.Tq;
  const float* delta = p.delta + (long long)bh * p.Tq;
  const int nq = (p.Tq + kXB - 1) / kXB;
  const int nw = (D + 63) / 64;  // warps whose columns hold D
  const bool active = warp < nw;
  const int col0 = warp * 64;

  auto stage_tile = [&](int tile) {
    float* dst = ring + (tile % kXStages) * kXStage;
    const int q0 = tile * kXB;
    stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, dst, qg, p.q_st, q0,
                                               p.Tq, D);
    stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, dst + kXTile, gg,
                                               p.g_st, q0, p.Tq, D);
    if (threadIdx.x < 2 * kXB) {  // lse, then delta (zero past Tq)
      const int i = threadIdx.x % kXB;
      const float* src = threadIdx.x < kXB ? lse : delta;
      const bool ok = q0 + i < p.Tq;
      cp_async<4>(smem_addr(dst + 2 * kXTile + threadIdx.x),
                  ok ? src + q0 + i : src, ok ? 4 : 0);
    }
  };

  // K and V in the last stage until tile 2 comes; copy groups: K, V with
  // tile 0, tile 1, then one a tile (empty past the last)
  float* sK = ring + (kXStages - 1) * kXStage;
  stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, sK, kg, p.k_st, k0, p.Tk,
                                             D);
  stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, sK + kXTile, vg, p.v_st,
                                             k0, p.Tk, D);
  stage_tile(0);
  cp_async_commit();
  if (nq > 1) stage_tile(1);
  cp_async_commit();
  cp_async_wait_mem<1>();
  __syncthreads();

  uint32_t kf[8][4], vf[8][4];
  hold_tf32(kf, vf, sK, sK + kXTile, col0, lane);
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int rr = reduce_row(), cc = lane & 15;  // key rr, query cc
  const bool key_ok = k0 + rr < p.Tk;

  for (int t = 0; t < nq; ++t) {
    const float* st = ring + (t % kXStages) * kXStage;
    const int q0 = t * kXB;
    if (active)
      two_partials(kf, vf, st, st + kXTile, sPartS, sPartP, col0, warp, lane);
    // the partials are whole; every warp is done with tile t - 1 (and K,
    // V), whose stage takes tile t + 2
    __syncthreads();
    if (t + kXStages - 1 < nq) stage_tile(t + kXStages - 1);
    cp_async_commit();
    {
      const int at = rr * kXLDS + cc;
      const float s = sum_partials(sPartS, at, nw);
      const float dp = sum_partials(sPartP, at, nw);
      float pv = 0.f, ds = 0.f;
      if (key_ok && q0 + cc < p.Tq) {
        pv = expf(s * p.scale - st[2 * kXTile + cc]);
        ds = pv * (dp - st[2 * kXTile + kXB + cc]) * p.scale;
      }
      sP[at] = __uint_as_float(to_tf32(pv));
      sdS[at] = __uint_as_float(to_tf32(ds));
    }
    cp_async_wait_mem<1>();  // this thread's copies of tile t + 1 are in
    // P^T and dS^T are whole, and so is tile t + 1
    __syncthreads();
    if (active) {
      product_cols(dv, sP, st + kXTile, col0, lane);  // dV += P^T g
      product_cols(dk, sdS, st, col0, lane);          // dK += dS^T Q
    }
  }

  if (!active) return;
  const long long out = (long long)bh * p.Tk * D;
  write_cols(p.dk + out, dk, k0, p.Tk, col0, D, lane);
  write_cols(p.dv + out, dv, k0, p.Tk, col0, D, lane);
}

// Pass 2: dQ of 16 queries of one (b, h). Warp w holds its 64 columns of Q
// and g as TF32 A fragments and of dQ as an f32 accumulator; K and V tiles
// of 16 keys come through the ring. Per tile: the partials of S = Q K^T and
// dP = g V^T, summed by element in warp order after a barrier, dS*scale =
// P (dP - delta) scale rounded to TF32, and after a second barrier dQ +=
// (dS*scale) K on each warp's columns. Written once in f32.
__global__ void __launch_bounds__(kXThreads, 1)
flash_bwd_dq_wide_tf32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [stage][K, V]
  float* sPartS = ring + kXStages * kXStage;
  float* sPartP = sPartS + kXPart;
  float* sdS = sPartP + kXPart;  // dS * scale [16 queries][kXLDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (p.Tq + kXB - 1) / kXB;
  const int q0 = (blockIdx.x % nq) * kXB;
  const int bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  const int nk = (p.Tk + kXB - 1) / kXB;
  const int nw = (D + 63) / 64;
  const bool active = warp < nw;
  const int col0 = warp * 64;
  const int rr = reduce_row(), cc = lane & 15;  // query rr, key cc
  const bool row_ok = q0 + rr < p.Tq;
  const float lse_r = row_ok ? p.lse[(long long)bh * p.Tq + q0 + rr] : 0.f;
  const float dlt_r = row_ok ? p.delta[(long long)bh * p.Tq + q0 + rr] : 0.f;

  auto stage_tile = [&](int tile) {
    float* dst = ring + (tile % kXStages) * kXStage;
    stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, dst, kg, p.k_st,
                                               tile * kXB, p.Tk, D);
    stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, dst + kXTile, vg,
                                               p.v_st, tile * kXB, p.Tk, D);
  };
  float* sQ = ring + (kXStages - 1) * kXStage;
  stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, sQ, qg, p.q_st, q0, p.Tq,
                                             D);
  stage_rows_f32<kXB, kXDK, kXLD, kXThreads>(p.vec, sQ + kXTile, gg, p.g_st,
                                             q0, p.Tq, D);
  stage_tile(0);
  cp_async_commit();
  if (nk > 1) stage_tile(1);
  cp_async_commit();
  cp_async_wait_mem<1>();
  __syncthreads();

  uint32_t qf[8][4], gf[8][4];
  hold_tf32(qf, gf, sQ, sQ + kXTile, col0, lane);
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const float* st = ring + (t % kXStages) * kXStage;
    if (active)
      two_partials(qf, gf, st, st + kXTile, sPartS, sPartP, col0, warp, lane);
    __syncthreads();
    if (t + kXStages - 1 < nk) stage_tile(t + kXStages - 1);
    cp_async_commit();
    {
      const int at = rr * kXLDS + cc;
      const float s = sum_partials(sPartS, at, nw);
      const float dp = sum_partials(sPartP, at, nw);
      float ds = 0.f;
      if (row_ok && t * kXB + cc < p.Tk)
        ds = expf(s * p.scale - lse_r) * (dp - dlt_r) * p.scale;
      sdS[at] = __uint_as_float(to_tf32(ds));
    }
    cp_async_wait_mem<1>();
    __syncthreads();
    if (active) product_cols(dq, sdS, st, col0, lane);  // dQ += dS K
  }

  if (!active) return;
  write_cols(static_cast<float*>(p.dq) + (long long)bh * p.Tq * D, dq, q0,
             p.Tq, col0, D, lane);
}

cudaError_t launch_wide_tf32(Params p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wide_tf32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wide_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kXSmem);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)p.B * p.H;
  const long long nk = (p.Tk + kXB - 1) / kXB, nq = (p.Tq + kXB - 1) / kXB;
  flash_bwd_dkdv_wide_tf32_kernel<<<(unsigned)(bh * nk), kXThreads, kXSmem,
                                    stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_tf32_kernel<<<(unsigned)(bh * nq), kXThreads, kXSmem,
                                  stream>>>(p);
  return cudaGetLastError();
}

// The padded head dim of the register kernels' instance for D, 0 past 128.
inline int reg_dk(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128 : 0;
}

// Shared memory of the largest kernel (the biased pass 1 or the dbias
// kernel) at instance DK.
template <int DK>
constexpr int reg_smem_as() {
  return RegCfg<DK, true>::kSmem1 > DbiasCfg<DK>::kSmem
             ? RegCfg<DK, true>::kSmem1 : DbiasCfg<DK>::kSmem;
}

inline int reg_smem(int dk) {
  switch (dk) {
    case 32: return reg_smem_as<32>();
    case 64: return reg_smem_as<64>();
    case 96: return reg_smem_as<96>();
    default: return reg_smem_as<128>();
  }
}

// The largest of 16, 8 and 4 bytes that the bias rows (elements of esize
// bytes) move in (the pointer, the row stride and, with more than one
// slice, the slice stride multiples of it), else 0.
int bias_granule(const void* bias, long long sn, long long sq, int mode,
                 int esize) {
  static const int kGrans[] = {16, 8, 4};
  for (int g : kGrans) {
    if (reinterpret_cast<uintptr_t>(bias) % g == 0 && (esize * sq) % g == 0
        && (mode == 1 || (esize * sn) % g == 0))
      return g;
  }
  return 0;
}

template <int DK, bool kBias>
cudaError_t launch_reg_as(Params p, cudaStream_t stream) {
  using C = RegCfg<DK, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_reg_kernel<DK, kBias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_reg_kernel<DK, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem2);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)p.B * p.H;
  const long long nk = (p.Tk + kRB - 1) / kRB, nq = (p.Tq + kRB - 1) / kRB;
  flash_bwd_dkdv_reg_kernel<DK, kBias><<<(unsigned)(bh * nk), kRThreads,
                                         C::kSmem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_reg_kernel<DK, kBias><<<(unsigned)(bh * nq), kRThreads,
                                       C::kSmem2, stream>>>(p);
  err = cudaGetLastError();
  if constexpr (kBias) {
    if (err != cudaSuccess || p.bias_mode == 3) return err;
    // a slice shared by all rows (mode 1) or by the B rows of a head (2)
    const long long slices = p.bias_mode == 1 ? 1 : p.H;
    constexpr int kSmem3 = DbiasCfg<DK>::kSmem;
    err = cudaFuncSetAttribute(flash_bwd_dbias_reg_kernel<DK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem3);
    if (err != cudaSuccess) return err;
    flash_bwd_dbias_reg_kernel<DK><<<(unsigned)(slices * nq * nk), kRThreads,
                                     kSmem3, stream>>>(p, (int)(bh / slices));
    err = cudaGetLastError();
  }
  return err;
}

template <int DK>
cudaError_t launch_reg_dk(Params p, cudaStream_t stream) {
  return p.bias ? launch_reg_as<DK, true>(p, stream)
                : launch_reg_as<DK, false>(p, stream);
}

cudaError_t launch_reg(Params p, cudaStream_t stream) {
  switch (reg_dk(p.D)) {
    case 32: return launch_reg_dk<32>(p, stream);
    case 64: return launch_reg_dk<64>(p, stream);
    case 96: return launch_reg_dk<96>(p, stream);
    case 128: return launch_reg_dk<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The padded head dim of the TF32 register kernels' instance for D (the f32
// head dims the paths launch: 32; 52 and 64; 128), 0 past 128.
inline int tf32_dk(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

// Shared memory of the largest of the TF32 register kernels at instance DK
// (the passes, biased and unbiased, and the dbias kernel).
template <int DK>
constexpr int tf32_smem_as() {
  using B = Tf32Cfg<DK, true>;
  using U = Tf32Cfg<DK, false>;
  const int a = B::kSmem1 > B::kSmem2 ? B::kSmem1 : B::kSmem2;
  const int b = U::kSmem1 > U::kSmem2 ? U::kSmem1 : U::kSmem2;
  const int c = a > b ? a : b;
  return c > B::kSmem3 ? c : B::kSmem3;
}

inline int tf32_smem(int dk) {
  switch (dk) {
    case 32: return tf32_smem_as<32>();
    case 64: return tf32_smem_as<64>();
    default: return tf32_smem_as<128>();
  }
}

template <int DK, bool kBias>
cudaError_t launch_tf32_as(Params p, cudaStream_t stream) {
  using C = Tf32Cfg<DK, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tf32_kernel<DK, kBias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<DK, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem2);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)p.B * p.H;
  const long long nk = (p.Tk + kRB - 1) / kRB, nq = (p.Tq + kRB - 1) / kRB;
  flash_bwd_dkdv_tf32_kernel<DK, kBias><<<(unsigned)(bh * nk), kRThreads,
                                          C::kSmem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tf32_kernel<DK, kBias><<<(unsigned)(bh * nq), kRThreads,
                                        C::kSmem2, stream>>>(p);
  err = cudaGetLastError();
  if constexpr (kBias) {
    if (err != cudaSuccess || p.bias_mode == 3) return err;
    // a slice shared by all rows (mode 1) or by the B rows of a head (2)
    const long long slices = p.bias_mode == 1 ? 1 : p.H;
    err = cudaFuncSetAttribute(flash_bwd_dbias_tf32_kernel<DK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem3);
    if (err != cudaSuccess) return err;
    flash_bwd_dbias_tf32_kernel<DK><<<(unsigned)(slices * nq * nk), kRThreads,
                                      C::kSmem3, stream>>>(
        p, (int)(bh / slices));
    err = cudaGetLastError();
  }
  return err;
}

template <int DK>
cudaError_t launch_tf32_dk(Params p, cudaStream_t stream) {
  return p.bias ? launch_tf32_as<DK, true>(p, stream)
                : launch_tf32_as<DK, false>(p, stream);
}

cudaError_t launch_tf32(Params p, cudaStream_t stream) {
  switch (tf32_dk(p.D)) {
    case 32: return launch_tf32_dk<32>(p, stream);
    case 64: return launch_tf32_dk<64>(p, stream);
    case 128: return launch_tf32_dk<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, bias and dq). bias_mode: 0 =
// no bias (bias and dbias null), 1 = one [Tq, Tk] slice, 2 = one per head,
// 3 = one per (b, h). vec: the bytes every row of q, k, v and g can move in
// (16, 8 or 4: D, the token strides and the pointers are multiples of it),
// or 0 for element loads. g, lse and delta must not alias the outputs.
// bf16 at D <= 128 launches the register kernels, f32 at D <= 128 the TF32
// register kernels, unbiased f32 at 128 < D <= 512 the TF32 column-split
// ones, anything else (a biased f32 launch past 128, D past 512) the WMMA
// ones. Returns a cudaError_t (0 on success).
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
  if (vec != 0 && vec != 4 && vec != 8 && vec != 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && reg_dk(D)) {
    p.vec = vec;
    p.bgran = bias ? bias_granule(bias, bias_sn, bias_sq, bias_mode, 2) : 0;
    return (int)launch_reg(p, s);
  }
  if (dtype == 0 && (tf32_dk(D) || (D <= kXDK && !bias))) {
    if (vec != 4 && vec != 8 && vec != 16)  // f32 rows move in 4-byte units
      return (int)cudaErrorInvalidValue;
    p.vec = vec;
    if (!tf32_dk(D)) return (int)launch_wide_tf32(p, s);
    p.bgran = bias ? bias_granule(bias, bias_sn, bias_sq, bias_mode, 4) : 0;
    return (int)launch_tf32(p, s);
  }
  p.vec = vec == 16;  // the WMMA kernels move 16 bytes or one element
  const int esize = dtype == 1 ? 2 : 4;
  if (!pick_tiles(p.DP, esize, max_block_smem(), &p.bq, &p.bk))
    return (int)cudaErrorInvalidConfiguration;
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// The tiles (query rows, keys) and the larger shared-memory size of the
// kernels an unbiased launch at head dim D would use (for the register
// instances, the largest of their kernels, the biased ones too), and its
// kernels: 1 flash_bwd_dkdv_kernel and flash_bwd_dq_kernel (the first
// design), 2 the bf16 register kernels, 3 flash_bwd_dkdv_wide_tf32_kernel
// and flash_bwd_dq_wide_tf32_kernel (f32 past 128), 4 the TF32 register
// kernels (f32 up to 128); 0 when no tile fits.
int flash_attn_bwd_tiles(int D, int dtype, int* bq, int* bk, int* smem) {
  if (dtype == 1 && reg_dk(D)) {
    *bq = *bk = kRB;
    *smem = reg_smem(reg_dk(D));
    return 2;
  }
  if (dtype == 0 && D > 128 && D <= kXDK) {
    *bq = *bk = kXB;
    *smem = kXSmem;
    return 3;
  }
  if (dtype == 0 && tf32_dk(D)) {
    *bq = *bk = kRB;
    *smem = tf32_smem(tf32_dk(D));
    return 4;
  }
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
