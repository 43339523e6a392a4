// Temporal (per-pixel, across-frame) attention forward for Hopper (sm_90a),
// bound through a plain C interface and loaded with ctypes
// (neurons_tpu_torch/ops/temporal_attention.py).
//
// Replaces the JAX package's Pallas TPU kernel
//   neurons_tpu/ops/temporal_attention.py:91  _temporal_kernel
// which computes the motion modules' attention in the layout the q/k/v
// projections emit, [(B F), D, C] with C innermost: for every batch b, pixel d
// and head h (C = H * hd), out[b, i, d, h, :] = sum_j softmax_j(scale *
// q[b, i, d, h, :] . k[b, j, d, h, :]) v[b, j, d, h, :] over the F frames.
// Logits, softmax and accumulation are f32; the output is in the input type
// (bf16 or f32). Nothing is transposed in device memory.
//
// What is not carried over: the TPU kernel packs the F x H logits of a pixel
// into one 128-lane vector row, so it only runs when F * H == 128, F is a
// power of two and hd % 8 == 0, and it rounds each bf16 q*k product to bf16
// before its selector matmul. None of that applies here: any F <= 32, any H
// and any hd run, and every q*k product is exact in f32.
//
// What bounds it on an H100: a 16 x 16 softmax per (pixel, head) is little
// arithmetic (4 * F * F * hd operations per F * hd * 4 elements moved), so
// the kernel is bound by the bytes it must move: q, k and v read once and the
// output written once (about 84 MB at the 32x32 motion-module site in bf16,
// 25 us at 3.35 TB/s). The first design (the warp route below) reached a
// quarter of that: each warp copied its slices in with synchronous loads and
// only then computed, so no copy overlapped any compute, and the products
// were scalar f32 FMAs fed from shared memory.
//
// Three routes, chosen per call:
//
// Tensor-core route (temporal_tc_kernel: bf16, F <= 16, hd % 8 == 0,
// hd <= 160, 16-byte aligned rows; every launch of the clip). A persistent
// block of W warps walks tiles of W consecutive (pixel, head) units, which
// in this layout are, for each frame, one contiguous run of W * hd
// elements. Tiles come in through a 2- or 3-stage cp.async ring (16-byte
// copies), so the loads of the next tiles overlap the compute of this one;
// W and the stages depend on hd (TcShape). Each
// unit's q, k and v sit in [16 frames][hd padded to 16, + 8] tiles whose pad
// rows and columns are zeroed once and never written (the + 8 makes the
// ldmatrix rows hit distinct banks). One warp a unit:
//   S = Q K^T with mma.sync m16n8k16 (F = 16 is exactly M; Q by ldmatrix, K
//   by ldmatrix as the column-major B operand, hd / 16 k-steps); the
//   softmax on the C fragment in registers (quad shuffles; padded keys get
//   p = 0); P rounded to bf16 straight from the C layout into the A
//   fragments (as the JAX kernel and the plain version round the weights
//   before P V); O = P V with V by ldmatrix.trans; O staged as bf16 in the
//   unit's q tile and written back as 16-byte row runs (padded query rows
//   are not written).
//
// f32 route (temporal_f32_kernel: f32, F <= 16, hd % 4 == 0, 4 <= hd <=
// 160, 16-byte aligned rows; every f32 launch of validate and of the tiny
// CLI chain). It replaces the warp route there. In f32 the work is F / 4
// operations a byte (4 at F = 16), a fifth of what the card's 67 TFLOP/s
// of f32 FMAs could do at 3.35 TB/s, so it is bound by bytes, and by
// latency where a level has few units. What the design does about the
// warp route's four limits:
//   1. Loads that overlapped nothing: a persistent block of 4 warps walks
//      tiles of W consecutive units (one run of W * hd floats in each
//      frame, as on the tensor-core route) through a 2-stage cp.async ring
//      of 16-byte copies, so the next tile loads while this one is
//      computed; each thread's copies of a usual tile are a table set once.
//      Two stages measured 2% faster over a validate run than three (3
//      blocks an SM against 2; PERF.md); 8 warps on 320-float runs slower.
//   2. Occupancy starved by shared memory: a tile holds at most 160 floats
//      of each frame (4 units at hd <= 40, 2 at hd <= 80, 1 at hd <= 160),
//      so a stage is 3 x [16 frames][164] floats (the + 4 makes 41 16-byte
//      units a row, odd, so row-strided reads hit distinct banks) and a
//      block 62,976 bytes at every hd: three blocks an SM, hd 160 included.
//      Rows of frames F..15 are zeroed once and never written.
//   3. Too few units at the small levels: the 4 warps split the tile's W
//      units by query rows, 4 / W warps a unit (R, F32Split) each taking
//      16 / R rows through S, the softmax and P V, sharing the unit's K
//      and V tiles with nothing recomputed. The split goes with hd because
//      the levels do: hd 160 is the 8x8 and 4x4 levels, 128-1024 units a
//      launch, fewer tiles than the card's 396 resident blocks at 4x4, so
//      four warps share each unit there; hd 40 and 80 have 2048-16384
//      units, enough tiles at one and two warps a unit (splitting them a
//      level earlier, 2 and 4 warps, measured 4% slower over validate).
//   4. Serial arithmetic from shared memory: the products are f32 FMAs
//      from register tiles. Lane (r, n) of a warp holds the logits of 2,
//      1 or 1 rows against 4, 4 or 2 keys (R = 1, 2, 4) and reads 16 bytes
//      of q and of k at a time: 6, 5 or 3 loads, each one conflict-free
//      request (k reads broadcast across the row groups), for 32, 16 or 8
//      FMAs. Each logit is four partial sums, one per element of a 16-byte
//      chunk, over the chunks in order, added as (p0 + p1) + (p2 + p3).
//      The softmax runs on the logits in registers (max and sum across
//      the row's NK lanes by xor shuffles; keys past F get p = 0), each
//      lane gathers its rows' 16 weights by shuffles, and O = P V takes
//      16-byte chunks of V (broadcast across the row groups) into f32 FMAs
//      over the keys in order, written straight from registers as 16-byte
//      stores (query rows past F are not written).
// Every q.k product is an exact f32 product, summed in f32, as in the JAX
// kernel's f32 path and the plain version. A 3-term TF32 tensor-core split
// (hi.hi + hi.lo + lo.hi) was not built: the arithmetic is not what bounds
// the route, and the split drops lo.lo and rounds lo, about 2^-21 of each
// product where an FMA keeps 2^-24.
//
// Warp route (temporal_fwd_kernel: 16 < F <= 32, and rows that are not
// whole 16-byte units, bf16 or f32; no path launches it). One warp owns
// one (b, pixel, head) unit; a block holds up to four warps on
// consecutive units. A warp
//   1. stages the F x hd slices of q, k and v in its shared memory (16-byte
//      loads where hd and C allow, else element by element, both coalesced
//      along hd), rows padded to an odd number of 16-byte units so that the
//      row-strided reads below hit distinct banks;
//   2. forms the F x F logits, lane (g, i) taking query row i against keys
//      j = g, g + G, ... (G = 32 / F lane groups), reading 16 bytes of q and k
//      at a time (the k reads are broadcasts across the lanes of a group);
//   3. takes the softmax of each query row, one lane per row;
//   4. forms P V in f32, one lane per (row, 16-byte chunk of hd), stages the
//      output in the q buffer and writes it back along hd as in 1.
//
// Each route sets its launch attributes and reads the card's limits once
// per kernel instance and device, not on every call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

#include "mma_sm80.cuh"

namespace {

constexpr int kMaxFrames = 32;
constexpr int kMaxWarps = 4;   // warp route: units a block
constexpr int kTcFrames = 16;  // tensor-core route: frames padded to M = 16
constexpr int kTcMaxHd = 160;
constexpr int kMaxDevices = 64;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;  // elements in 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(in[2 * t], in[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
  __device__ static float zero() { return 0.f; }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long D;      // pixels per frame
  long long units;  // B * D * H
  int C, F, H, hd;
  int hdp;          // hd rounded up to a whole 16-byte chunk
  int rs;           // shared-memory row stride in elements
  int warp_bytes;   // shared memory of one warp
  int warps;        // warps a block
  int vec;          // 16-byte global loads and stores
  float scale;
};

template <typename T>
__device__ void copy_in(const T* g, T* s, long long fstride, const Params& p,
                        int lane) {
  constexpr int N = Vec<T>::N;
  if (p.vec) {  // hd % N == 0, so hdp == hd
    const int nv = p.hd / N;
    for (int idx = lane; idx < p.F * nv; idx += 32) {
      const int i = idx / nv, c = idx % nv;
      *reinterpret_cast<uint4*>(s + i * p.rs + c * N) =
          *reinterpret_cast<const uint4*>(g + i * fstride + c * N);
    }
  } else {
    for (int idx = lane; idx < p.F * p.hdp; idx += 32) {
      const int i = idx / p.hdp, e = idx % p.hdp;
      s[i * p.rs + e] = e < p.hd ? g[i * fstride + e] : Vec<T>::zero();
    }
  }
}

template <typename T, int JPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
temporal_fwd_kernel(Params p) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * p.warps + warp;
  if (unit >= p.units) return;  // whole warps only: no block-wide barrier below

  const int F = p.F, rs = p.rs, ldp = F + 1;
  T* sq = reinterpret_cast<T*>(smem + (size_t)warp * p.warp_bytes);
  T* sk = sq + F * rs;
  T* sv = sk + F * rs;
  float* sp = reinterpret_cast<float*>(sv + F * rs);

  const int h = (int)(unit % p.H);
  const long long rest = unit / p.H;
  const long long d = rest % p.D, b = rest / p.D;
  // element offset of (frame 0, pixel d, head h); frame i adds i * D * C
  const long long base = (b * F * p.D + d) * p.C + (long long)h * p.hd;
  const long long fstride = p.D * p.C;

  // 1. stage q, k, v
  copy_in(static_cast<const T*>(p.q) + base, sq, fstride, p, lane);
  copy_in(static_cast<const T*>(p.k) + base, sk, fstride, p, lane);
  copy_in(static_cast<const T*>(p.v) + base, sv, fstride, p, lane);
  __syncwarp();

  // 2. logits; within a 16-byte chunk the products are summed as a tree,
  // which keeps the serial f32 sum over hd short
  const int G = 32 / F;
  const int qi = lane % F, g = lane / F;
  if (g < G) {
    float acc[JPL];
#pragma unroll
    for (int jj = 0; jj < JPL; ++jj) acc[jj] = 0.f;
    const T* qrow = sq + qi * rs;
    for (int e0 = 0; e0 < p.hdp; e0 += N) {
      float qv[N];
      V::load(qrow + e0, qv);
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj) {
        const int j = g + jj * G;
        if (j < F) {
          float kv[N];
          V::load(sk + j * rs + e0, kv);
#pragma unroll
          for (int t = 0; t < N; ++t) kv[t] *= qv[t];
#pragma unroll
          for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
            for (int t = 0; t < w; ++t) kv[t] += kv[t + w];
          }
          acc[jj] += kv[0];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JPL; ++jj) {
      const int j = g + jj * G;
      if (j < F) sp[qi * ldp + j] = acc[jj] * p.scale;
    }
  }
  __syncwarp();

  // 3. softmax over the keys, one lane per query row
  if (lane < F) {
    float* row = sp + lane * ldp;
    float m = row[0];
    for (int j = 1; j < F; ++j) m = fmaxf(m, row[j]);
    float s = 0.f;
    for (int j = 0; j < F; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    for (int j = 0; j < F; ++j) row[j] = row[j] / s;
  }
  __syncwarp();

  // 4. out = P V, staged in the q buffer (q was last read in 2)
  const int nc = p.hdp / N;
  for (int idx = lane; idx < F * nc; idx += 32) {
    const int r = idx / nc, c = idx % nc;
    const float* prow = sp + r * ldp;
    float acc[N];
#pragma unroll
    for (int t = 0; t < N; ++t) acc[t] = 0.f;
    for (int j = 0; j < F; ++j) {
      const float pj = prow[j];
      float vv[N];
      V::load(sv + j * rs + c * N, vv);
#pragma unroll
      for (int t = 0; t < N; ++t) acc[t] = fmaf(pj, vv[t], acc[t]);
    }
    V::store(sq + r * rs + c * N, acc);
  }
  __syncwarp();

  T* go = static_cast<T*>(p.o) + base;
  if (p.vec) {
    const int nv = p.hd / N;
    for (int idx = lane; idx < F * nv; idx += 32) {
      const int i = idx / nv, c = idx % nv;
      *reinterpret_cast<uint4*>(go + i * fstride + c * N) =
          *reinterpret_cast<const uint4*>(sq + i * rs + c * N);
    }
  } else {
    for (int idx = lane; idx < F * p.hd; idx += 32) {
      const int i = idx / p.hd, e = idx % p.hd;
      go[i * fstride + e] = sq[i * rs + e];
    }
  }
}

// ---- tensor-core route -----------------------------------------------------

struct TcParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int units;  // B * D * H; the route takes tensors under 2^31 elements
  int DH;     // units of one batch row b
  int DC;     // elements between frames
  int tiles;  // ceil(units / units a tile)
  int F;
  float scale;
};

template <int HD>
struct TcShape {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // k depth of Q K^T
  static constexpr int LD = HDP + 8;  // odd count of 16-byte units a row
  static constexpr int TILE = kTcFrames * LD;  // one tensor of a unit
  // units a tile (one warp each) and copy stages, as measured at the clip's
  // head dims (PERF.md): at hd 40, 8 units (640-byte runs of each
  // frame's row) in 2 stages, two blocks an SM; at hd 80, 4 units in 2
  // stages, three blocks an SM; at hd 160, few tiles a clip level, so 2
  // units a tile in 3 stages
  static constexpr int W = HD <= 48 ? 8 : HD <= 96 ? 4 : 2;
  static constexpr int STAGES = HD <= 96 ? 2 : 3;
  static constexpr int STAGE = 3 * W * TILE;      // q, k, v of a tile
  static constexpr int SMEM = STAGES * STAGE * 2;  // bytes
  static constexpr int CHUNKS = HD / 8;            // 16-byte chunks a row
  static constexpr int ROW = W * CHUNKS;           // chunks of a frame's run
  static constexpr int PER = kTcFrames * ROW;      // chunks of one tensor
  static constexpr int COPIES = (PER + W * 32 - 1) / (W * 32);  // a thread
  static constexpr int STORES = (kTcFrames * CHUNKS + 31) / 32;  // a lane
};

// element offset of unit u's frame 0: the (d, h) units of one batch row are
// consecutive runs of hd elements (d * C + h * hd = (d * H + h) * hd)
template <int HD>
__device__ __forceinline__ int unit_base(const TcParams& p, int u) {
  const int b = u / p.DH;
  return b * p.F * p.DC + (u - b * p.DH) * HD;
}

// A thread's share of the copies of one tensor of a tile, the same for q,
// k and v and for every tile that lies within one batch row, set once:
// element offsets from the tile's first unit's frame-0 row (-1 where the
// frame is past F) and into the tensor's W tiles in shared memory.
template <int HD>
struct CopyTable {
  int src[TcShape<HD>::COPIES], dst[TcShape<HD>::COPIES];

  __device__ void init(const TcParams& p) {
    using S = TcShape<HD>;
#pragma unroll
    for (int k = 0; k < S::COPIES; ++k) {
      const int i = threadIdx.x + k * S::W * 32;
      const int f = i / S::ROW, w = i % S::ROW / S::CHUNKS,
                c = i % S::CHUNKS;
      const bool ok = i < S::PER && f < p.F;
      src[k] = ok ? f * p.DC + w * HD + c * 8 : -1;
      dst[k] = w * S::TILE + f * S::LD + c * 8;
    }
  }
};

// q, k, v of the tile's units into `dst` (one stage), 16 bytes a copy,
// consecutive threads along each frame's run of the tile's units
template <int HD>
__device__ __forceinline__ void issue_tile(const TcParams& p,
                                           const CopyTable<HD>& tab, int tile,
                                           __nv_bfloat16* dst) {
  using S = TcShape<HD>;
  const int u0 = tile * S::W;
  const int b0 = u0 / p.DH, r0 = u0 - b0 * p.DH;
  if (r0 + S::W <= p.DH && u0 + S::W <= p.units) {  // the usual tile
    const int base = b0 * p.F * p.DC + r0 * HD;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16* src = (t == 0 ? p.q : t == 1 ? p.k : p.v) + base;
      const uint32_t to = smem_addr(dst + t * S::W * S::TILE);
#pragma unroll
      for (int k = 0; k < S::COPIES; ++k)
        if (tab.src[k] >= 0)
          cp_async<16>(to + 2 * tab.dst[k], src + tab.src[k], 16);
    }
    return;
  }
  // the last tile, or one that crosses into the next batch row
  for (int i = threadIdx.x; i < 3 * S::PER; i += S::W * 32) {
    const int t = i / S::PER, f = i % S::PER / S::ROW,
              w = i % S::ROW / S::CHUNKS, c = i % S::CHUNKS;
    if (f >= p.F || u0 + w >= p.units) continue;
    const __nv_bfloat16* src = t == 0 ? p.q : t == 1 ? p.k : p.v;
    cp_async<16>(smem_addr(dst + (t * S::W + w) * S::TILE + f * S::LD +
                           c * 8),
                 src + unit_base<HD>(p, u0 + w) + f * p.DC + c * 8, 16);
  }
}

// One warp: attention of one unit whose q, k, v tiles are sq, sk, sv; O is
// staged in sq and written to `out` (the unit's frame-0 row).
template <int HD>
__device__ __forceinline__ void unit_attention(const TcParams& p,
                                               __nv_bfloat16* sq,
                                               const __nv_bfloat16* sk,
                                               const __nv_bfloat16* sv,
                                               __nv_bfloat16* out, int lane) {
  using S = TcShape<HD>;
  constexpr int LD = S::LD, HDP = S::HDP, NT = HDP / 8;
  const int g = lane >> 2, t = lane & 3;

  // S = Q K^T: keys 0-7 in s[0], keys 8-15 in s[1]
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HDP; kk += 16) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, smem_addr(sq + (lane & 15) * LD + kk + (lane >> 4) * 8));
    ldmatrix_x4(b, smem_addr(sk + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                             kk + ((lane >> 3) & 1) * 8));
    mma_bf16(s[0], a, b);
    mma_bf16(s[1], a, b + 2);
  }

  // softmax over the keys of rows g (c0, c1) and g + 8 (c2, c3); a row's
  // keys are spread over the 4 lanes of its quad; padded keys get p = 0
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = n * 8 + 2 * t + (e & 1) < p.F ? s[n][e] * p.scale : -INFINITY;
  float mx[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                  fmaxf(s[1][2 * r], s[1][2 * r + 1]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = __expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.f / sum[r];
  }
  // P in bf16, straight from the C layout into the A fragments
  uint32_t pa[4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    pa[2 * n] = pack_bf16(s[n][0] * sum[0], s[n][1] * sum[0]);
    pa[2 * n + 1] = pack_bf16(s[n][2] * sum[1], s[n][3] * sum[1]);
  }

  // O = P V, two n8 tiles of hd a step
  float o[NT][4] = {};
#pragma unroll
  for (int n0 = 0; n0 < HDP; n0 += 16) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_addr(sv + (lane & 15) * LD + n0 +
                                   (lane >> 4) * 8));
    mma_bf16(o[n0 / 8], pa, b);
    mma_bf16(o[n0 / 8 + 1], pa, b + 2);
  }

  // O as bf16 into the q tile (q was last read above), query rows < F,
  // then out as 16-byte row runs
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (g < p.F)
      *reinterpret_cast<uint32_t*>(sq + g * LD + col) =
          pack_bf16(o[n][0], o[n][1]);
    if (g + 8 < p.F)
      *reinterpret_cast<uint32_t*>(sq + (g + 8) * LD + col) =
          pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < S::STORES; ++k) {
    const int i = lane + 32 * k, row = i / S::CHUNKS, c = i % S::CHUNKS;
    if (row < p.F && row < kTcFrames)
      *reinterpret_cast<uint4*>(out + row * p.DC + c * 8) =
          *reinterpret_cast<const uint4*>(sq + row * S::LD + c * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(TcShape<HD>::W * 32)
temporal_tc_kernel(TcParams p) {
  using S = TcShape<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grid = gridDim.x;
  CopyTable<HD> copies;
  copies.init(p);

  // zero the pads once: rows of frames F..15 and columns hd..HDP-1 are
  // never written (there are none at F = 16 and hd % 16 == 0)
  if (p.F < kTcFrames || HD < S::HDP) {
    constexpr int ROWS = S::STAGES * 3 * S::W * kTcFrames;
    for (int i = threadIdx.x; i < ROWS; i += S::W * 32) {
      uint4* row = reinterpret_cast<uint4*>(smem + i * S::LD);
      for (int c = i % kTcFrames < p.F ? HD / 8 : 0; c < S::HDP / 8; ++c)
        row[c] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    const int tile = blockIdx.x + st * grid;
    if (tile < p.tiles) issue_tile<HD>(p, copies, tile, smem + st * S::STAGE);
    cp_async_commit();
  }
  int stage = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += grid) {
    // refill the stage the previous iteration freed
    const int ahead = tile + (S::STAGES - 1) * grid;
    if (ahead < p.tiles)
      issue_tile<HD>(p, copies, ahead,
                     smem + (stage + S::STAGES - 1) % S::STAGES * S::STAGE);
    cp_async_commit();
    cp_async_wait<S::STAGES - 1>();  // this tile's copies have landed
    __syncthreads();
    const int u = tile * S::W + warp;
    if (u < p.units) {
      __nv_bfloat16* base = smem + stage * S::STAGE + warp * S::TILE;
      unit_attention<HD>(p, base, base + S::W * S::TILE,
                         base + 2 * S::W * S::TILE,
                         p.o + unit_base<HD>(p, u), lane);
    }
    __syncthreads();  // the stage is free for the copies of a later tile
    stage = (stage + 1) % S::STAGES;
  }
  cp_async_wait<0>();
}

// A kernel instance's launch attributes, set once per device.
struct InstanceCache {
  std::atomic<bool> ready[kMaxDevices];
  int value[kMaxDevices];  // e.g. blocks an SM x SMs
  std::mutex mutex;
};

template <typename Init>
cudaError_t cached(InstanceCache& cache, Init init, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache.ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(cache.mutex);
    if (!cache.ready[dev].load(std::memory_order_relaxed)) {
      err = init(dev, &cache.value[dev]);
      if (err != cudaSuccess) return err;
      cache.ready[dev].store(true, std::memory_order_release);
    }
  }
  *value = cache.value[dev];
  return cudaSuccess;
}

// Blocks of a persistent kernel the card holds at once (its shared-memory
// attribute set first), read once per kernel instance and device.
template <typename Kernel>
cudaError_t resident_blocks(InstanceCache& cache, Kernel kernel, int threads,
                            int smem, int* resident) {
  return cached(
      cache,
      [=](int dev, int* out) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        int sms = 0, per_sm = 0;
        if (e == cudaSuccess)
          e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
        if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
        *out = sms * per_sm;
        return e;
      },
      resident);
}

template <int HD>
cudaError_t launch_tc(TcParams p, cudaStream_t stream) {
  using S = TcShape<HD>;
  static InstanceCache cache;
  int resident = 0;
  cudaError_t err = resident_blocks(cache, temporal_tc_kernel<HD>, S::W * 32,
                                    S::SMEM, &resident);
  if (err != cudaSuccess) return err;
  p.tiles = (p.units + S::W - 1) / S::W;
  const int grid = std::min(p.tiles, resident);
  temporal_tc_kernel<HD><<<(unsigned)grid, S::W * 32, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_tc(int hd, const TcParams& p, cudaStream_t stream) {
  if constexpr (HD > kTcMaxHd) {
    return cudaErrorInvalidValue;
  } else {
    if (hd == HD) return launch_tc<HD>(p, stream);
    return dispatch_tc<HD + 8>(hd, p, stream);
  }
}

bool tc_route(int F, int hd, int dtype, int vec) {
  return dtype == 1 && vec && F <= kTcFrames && hd % 8 == 0 &&
         hd <= kTcMaxHd;
}

struct TcPlan {
  int warps, smem;  // a block; shared-memory bytes a block
};

template <int HD>
constexpr TcPlan tc_plan(int hd) {
  if constexpr (HD > kTcMaxHd) {
    return {0, 0};
  } else {
    return hd == HD ? TcPlan{TcShape<HD>::W, TcShape<HD>::SMEM}
                    : tc_plan<HD + 8>(hd);
  }
}

// ---- f32 route -------------------------------------------------------------

constexpr int kF32Frames = 16;  // frames padded to 16 rows
constexpr int kF32Warps = 4;    // warps a block
constexpr int kF32Run = 160;    // floats a tile holds of each frame
constexpr int kF32Ld = kF32Run + 4;  // 41 16-byte units a row: odd
constexpr int kF32Stages = 2;
constexpr int kF32Tensor = kF32Frames * kF32Ld;  // floats of q, k or v
constexpr int kF32Stage = 3 * kF32Tensor;
constexpr int kF32Smem = kF32Stages * kF32Stage * 4;  // bytes a block
// 16-byte copies a thread of one tensor of a tile (16 x 40 at most)
constexpr int kF32Copies = kF32Frames * kF32Run / 4 / (kF32Warps * 32);

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int units;  // B * D * H; the route takes tensors under 2^31 elements
  int DH;     // units of one batch row b
  int DC;     // elements between frames
  int tiles;  // ceil(units / units a tile)
  int F, hd;
  float scale;
};

// R warps a unit, each taking 16 / R query rows; W = 4 / R units a tile.
// A warp's lanes are NR row groups x NK key groups: lane (r, n) holds
// the logits of rows r + NR i (i < RPL) against keys n + NK m (m < KPL).
template <int R>
struct F32Split {
  static constexpr int W = kF32Warps / R;
  static constexpr int M = kF32Frames / R;
  static constexpr int NR = R == 4 ? 4 : 8;
  static constexpr int NK = 32 / NR;
  static constexpr int RPL = M / NR;
  static constexpr int KPL = kF32Frames / NK;
};

// units of a tile by head dim: a tile holds at most kF32Run floats of each
// frame, so 4 units at hd <= 40, 2 at hd <= 80 and 1 at hd <= 160
int f32_split(int hd) { return hd <= 40 ? 1 : hd <= 80 ? 2 : 4; }

bool f32_route(int F, int hd, int dtype, int vec) {
  return dtype == 0 && vec && F <= kF32Frames && hd % 4 == 0 &&
         hd <= kF32Run;
}

__device__ __forceinline__ int f32_unit_base(const F32Params& p, int u) {
  const int b = u / p.DH;
  return b * p.F * p.DC + (u - b * p.DH) * p.hd;
}

// A thread's copies of one tensor of a tile whose W units are one run of
// W * hd floats in each frame (every tile within a batch row): offsets
// from the run's frame-0 start (-1: none) and into the tensor's tile.
struct F32CopyTable {
  int src[kF32Copies], dst[kF32Copies];

  __device__ void init(const F32Params& p, int W) {
    const int run = W * p.hd / 4;  // 16-byte chunks of a frame's run
#pragma unroll
    for (int k = 0; k < kF32Copies; ++k) {
      const int i = threadIdx.x + k * kF32Warps * 32;
      const int f = i / run, c = i - f * run;
      src[k] = f < p.F ? f * p.DC + 4 * c : -1;
      dst[k] = f * kF32Ld + 4 * c;
    }
  }
};

// q, k, v of the tile's units into one stage, 16 bytes a copy
template <int W>
__device__ __forceinline__ void f32_issue(const F32Params& p,
                                          const F32CopyTable& tab, int tile,
                                          float* stage) {
  const int u0 = tile * W;
  const int b0 = u0 / p.DH, r0 = u0 - b0 * p.DH;
  const uint32_t to = smem_addr(stage);
  if (r0 + W <= p.DH && u0 + W <= p.units) {  // the usual tile
    const int base = b0 * p.F * p.DC + r0 * p.hd;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float* src = (t == 0 ? p.q : t == 1 ? p.k : p.v) + base;
#pragma unroll
      for (int k = 0; k < kF32Copies; ++k)
        if (tab.src[k] >= 0)
          cp_async<16>(to + 4 * (t * kF32Tensor + tab.dst[k]),
                       src + tab.src[k], 16);
    }
    return;
  }
  // the last tile, or one that crosses into the next batch row
  const int chunks = p.hd / 4, row = W * chunks, per = p.F * row;
  for (int i = threadIdx.x; i < 3 * per; i += kF32Warps * 32) {
    const int t = i / per, f = i % per / row, w = i % row / chunks,
              c = i % chunks;
    if (u0 + w >= p.units) continue;
    const float* src = t == 0 ? p.q : t == 1 ? p.k : p.v;
    cp_async<16>(to + 4 * (t * kF32Tensor + f * kF32Ld + w * p.hd + 4 * c),
                 src + f32_unit_base(p, u0 + w) + f * p.DC + 4 * c, 16);
  }
}

// One warp: query rows row0 .. row0 + 16 / R - 1 of one unit whose q, k,
// v tiles (rows of stride kF32Ld) are sq, sk, sv; out is the unit's
// frame-0 row. Every product is an f32 FMA from registers.
template <int R>
__device__ __forceinline__ void f32_rows(const F32Params& p, const float* sq,
                                         const float* sk, const float* sv,
                                         float* out, int row0, int lane) {
  using S = F32Split<R>;
  constexpr int RPL = S::RPL, KPL = S::KPL, NR = S::NR, NK = S::NK;
  const int rg = lane / NK, kg = lane % NK;

  // S = Q K^T: four partial sums a logit, one per element of a 16-byte
  // chunk, each over the chunks in order
  float acc[RPL][KPL][4] = {};
  const float* qrow = sq + (row0 + rg) * kF32Ld;
  const float* krow = sk + kg * kF32Ld;
  for (int e = 0; e < p.hd; e += 4) {
    float4 qv[RPL], kv[KPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qrow + i * NR * kF32Ld + e);
#pragma unroll
    for (int m = 0; m < KPL; ++m)
      kv[m] = *reinterpret_cast<const float4*>(krow + m * NK * kF32Ld + e);
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        acc[i][m][0] = fmaf(qv[i].x, kv[m].x, acc[i][m][0]);
        acc[i][m][1] = fmaf(qv[i].y, kv[m].y, acc[i][m][1]);
        acc[i][m][2] = fmaf(qv[i].z, kv[m].z, acc[i][m][2]);
        acc[i][m][3] = fmaf(qv[i].w, kv[m].w, acc[i][m][3]);
      }
  }

  // softmax over each row's keys, spread over the NK lanes of its row
  // group (keys past F get p = 0), then every lane gathers its rows' 16
  // weights
  float pw[RPL][kF32Frames];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float s[KPL], mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      s[m] = kg + m * NK < p.F
                 ? ((acc[i][m][0] + acc[i][m][1]) +
                    (acc[i][m][2] + acc[i][m][3])) * p.scale
                 : -INFINITY;
      mx = fmaxf(mx, s[m]);
    }
#pragma unroll
    for (int x = 1; x < NK; x *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      s[m] = expf(s[m] - mx);
      sum += s[m];
    }
#pragma unroll
    for (int x = 1; x < NK; x *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, x);
#pragma unroll
    for (int m = 0; m < KPL; ++m) s[m] = s[m] / sum;
#pragma unroll
    for (int j = 0; j < kF32Frames; ++j)
      pw[i][j] = __shfl_sync(0xffffffffu, s[j / NK], rg * NK + j % NK);
  }

  // O = P V, lane (r, n) taking 16-byte chunks n, n + NK, ... of its rows,
  // the keys in order (pad rows of V are zero, their weights 0); query
  // rows past F are not written
  for (int c = kg; c < p.hd / 4; c += NK) {
    float4 o[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kF32Frames; ++j) {
      const float4 vv =
          *reinterpret_cast<const float4*>(sv + j * kF32Ld + 4 * c);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        o[i].x = fmaf(pw[i][j], vv.x, o[i].x);
        o[i].y = fmaf(pw[i][j], vv.y, o[i].y);
        o[i].z = fmaf(pw[i][j], vv.z, o[i].z);
        o[i].w = fmaf(pw[i][j], vv.w, o[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int row = row0 + rg + i * NR;
      if (row < p.F)
        *reinterpret_cast<float4*>(out + row * p.DC + 4 * c) = o[i];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kF32Warps * 32)
temporal_f32_kernel(F32Params p) {
  using S = F32Split<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grid = gridDim.x;
  F32CopyTable copies;
  copies.init(p, S::W);

  // zero the rows of frames F..15 once: no copy writes them
  if (p.F < kF32Frames) {
    const int n = (kF32Frames - p.F) * kF32Ld / 4;  // 16-byte units a tensor
    for (int i = threadIdx.x; i < kF32Stages * 3 * n; i += kF32Warps * 32)
      reinterpret_cast<float4*>(smem + i / n * kF32Tensor +
                                p.F * kF32Ld)[i % n] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    const int tile = blockIdx.x + st * grid;
    if (tile < p.tiles) f32_issue<S::W>(p, copies, tile, smem + st * kF32Stage);
    cp_async_commit();
  }
  const int w = warp / R, row0 = warp % R * S::M;
  int stage = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += grid) {
    // refill the stage the previous iteration freed
    const int ahead = tile + (kF32Stages - 1) * grid;
    if (ahead < p.tiles)
      f32_issue<S::W>(p, copies, ahead,
                      smem + (stage + kF32Stages - 1) % kF32Stages * kF32Stage);
    cp_async_commit();
    cp_async_wait_mem<kF32Stages - 1>();  // this tile's copies have landed
    __syncthreads();
    const int u = tile * S::W + w;
    if (u < p.units) {
      const float* base = smem + stage * kF32Stage + w * p.hd;
      f32_rows<R>(p, base, base + kF32Tensor, base + 2 * kF32Tensor,
                  p.o + f32_unit_base(p, u), row0, lane);
    }
    __syncthreads();  // the stage is free for the copies of a later tile
    stage = (stage + 1) % kF32Stages;
  }
  cp_async_wait<0>();
}

template <int R>
cudaError_t launch_f32(F32Params p, cudaStream_t stream) {
  static InstanceCache cache;
  int resident = 0;
  cudaError_t err = resident_blocks(cache, temporal_f32_kernel<R>,
                                    kF32Warps * 32, kF32Smem, &resident);
  if (err != cudaSuccess) return err;
  constexpr int W = F32Split<R>::W;
  p.tiles = (p.units + W - 1) / W;
  const int grid = std::min(p.tiles, resident);
  temporal_f32_kernel<R>
      <<<(unsigned)grid, kF32Warps * 32, kF32Smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- warp route ------------------------------------------------------------

int max_block_smem() {
  static InstanceCache cache;
  int bytes = 0;
  if (cached(cache,
             [](int dev, int* out) {
               return cudaDeviceGetAttribute(
                   out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
             },
             &bytes) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename T, int JPL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static InstanceCache cache;
  int unused = 0;
  cudaError_t err = cached(
      cache,
      [](int, int* out) {
        *out = 0;
        return cudaFuncSetAttribute(temporal_fwd_kernel<T, JPL>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    max_block_smem());
      },
      &unused);
  if (err != cudaSuccess) return err;
  const int smem = p.warps * p.warp_bytes;
  const long long blocks = (p.units + p.warps - 1) / p.warps;
  temporal_fwd_kernel<T, JPL><<<(unsigned)blocks, p.warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// keys per lane in the logits step: ceil(F / (32 / F)), rounded up to an
// instantiated size
template <typename T>
cudaError_t launch_frames(const Params& p, cudaStream_t stream) {
  const int groups = 32 / p.F;
  const int jpl = (p.F + groups - 1) / groups;
  if (jpl <= 1) return launch<T, 1>(p, stream);
  if (jpl <= 2) return launch<T, 2>(p, stream);
  if (jpl <= 4) return launch<T, 4>(p, stream);
  if (jpl <= 8) return launch<T, 8>(p, stream);
  if (jpl <= 16) return launch<T, 16>(p, stream);
  return launch<T, 32>(p, stream);
}

// Row layout and warps a block for F frames of head dim hd; false when one
// warp's slices do not fit a block's shared memory.
bool plan(int F, int hd, int esize, Params* p) {
  const int n = 16 / esize;
  p->hdp = (hd + n - 1) / n * n;
  p->rs = (p->hdp / n) % 2 ? p->hdp : p->hdp + n;  // odd count of 16-byte units
  const long long bytes = 3LL * F * p->rs * esize + 4LL * F * (F + 1);
  p->warp_bytes = (int)((bytes + 15) / 16 * 16);
  const int limit = max_block_smem();
  p->warps = kMaxWarps;
  while (p->warps > 0 && (long long)p->warps * p->warp_bytes > limit) --p->warps;
  return p->warps > 0;
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous [BF, D, C]; BF = B * F. dtype: 0 = float32,
// 1 = bfloat16. vec: hd and C are multiples of 16 / element size and q, k,
// v, o are 16-byte aligned. Returns a cudaError_t (0 on success).
int temporal_attn_fwd(const void* q, const void* k, const void* v, void* o,
                      long long BF, long long D, int C, int F, int H,
                      float scale, int dtype, int vec, void* stream) {
  if (BF <= 0 || D <= 0 || C <= 0 || H <= 0 || F <= 0 || F > kMaxFrames ||
      BF % F != 0 || C % H != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int hd = C / H;
  const long long units = BF / F * D * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_route(F, hd, dtype, vec) && BF * D * C < 0x7fffffffLL) {
    TcParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.units = (int)units;
    p.DH = (int)(D * H);
    p.DC = (int)(D * C);
    p.F = F;
    p.scale = scale;
    return (int)dispatch_tc<8>(hd, p, s);
  }
  if (f32_route(F, hd, dtype, vec) && BF * D * C < 0x7fffffffLL) {
    F32Params p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.o = static_cast<float*>(o);
    p.units = (int)units;
    p.DH = (int)(D * H);
    p.DC = (int)(D * C);
    p.F = F;
    p.hd = hd;
    p.scale = scale;
    const int split = f32_split(hd);
    return (int)(split == 1   ? launch_f32<1>(p, s)
                 : split == 2 ? launch_f32<2>(p, s)
                              : launch_f32<4>(p, s));
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.D = D;
  p.C = C; p.F = F; p.H = H; p.hd = hd;
  p.units = units;
  p.scale = scale;
  p.vec = vec;
  const int esize = dtype == 1 ? 2 : 4;
  if (!plan(F, p.hd, esize, &p)) return (int)cudaErrorInvalidConfiguration;
  return (int)(dtype == 1 ? launch_frames<__nv_bfloat16>(p, s)
                          : launch_frames<float>(p, s));
}

// How a launch at (F, hd, dtype, vec) runs, for tensors under 2^31
// elements (larger ones take the warp route): route 1 = tensor cores, 2 =
// the f32 route, 0 = warp route; warps a block; shared-memory bytes a
// block; warps a unit. Returns 0 when it cannot launch.
int temporal_attn_fwd_plan(int F, int hd, int dtype, int vec, int* route,
                           int* warps, int* smem, int* split) {
  if (F <= 0 || F > kMaxFrames || hd <= 0) return 0;
  *split = 1;
  if (tc_route(F, hd, dtype, vec)) {
    const TcPlan tp = tc_plan<8>(hd);
    *route = 1;
    *warps = tp.warps;
    *smem = tp.smem;
    return 1;
  }
  if (f32_route(F, hd, dtype, vec)) {
    *route = 2;
    *warps = kF32Warps;
    *smem = kF32Smem;
    *split = f32_split(hd);
    return 1;
  }
  Params p;
  if (!plan(F, hd, dtype == 1 ? 2 : 4, &p)) return 0;
  *route = 0;
  *warps = p.warps;
  *smem = p.warps * p.warp_bytes;
  return 1;
}

const char* temporal_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
