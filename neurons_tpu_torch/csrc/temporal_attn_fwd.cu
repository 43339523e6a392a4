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
// Products, logits, softmax and accumulation are f32; the output is in the
// input type (bf16 or f32). Nothing is transposed in device memory.
//
// What is not carried over: the TPU kernel packs the F x H logits of a pixel
// into one 128-lane vector row, so it only runs when F * H == 128, F is a
// power of two and hd % 8 == 0, and it rounds each bf16 q*k product to bf16
// before its selector matmul. None of that applies here: any F <= 32, any H
// and any hd run, and every product is formed in f32.
//
// What bounds it on an H100: a 16 x 16 softmax per (pixel, head) is little
// arithmetic (4 * F * F * hd operations per F * hd * 4 elements moved), so
// the kernel is bound by the bytes it must move: q, k and v read once and the
// output written once (about 84 MB at the 32x32 motion-module site in bf16,
// 25 us at 3.35 TB/s).
//
// Design. One warp owns one (b, pixel, head) unit; a block holds up to four
// warps on consecutive units, so consecutive warps (and blocks) read the
// neighbouring hd-runs of the same C row. A warp
//   1. stages the F x hd slices of q, k and v in its shared memory (16-byte
//      loads where hd and C allow, else element by element, both coalesced
//      along hd), rows padded to an odd number of 16-byte units so that the
//      row-strided reads below hit distinct banks;
//   2. forms the F x F logits, lane (g, i) taking query row i against keys
//      j = g, g + G, ... (G = 32 / F lane groups), reading 16 bytes of q and k
//      at a time (the k reads are broadcasts across the lanes of a group);
//   3. takes the softmax of each query row, one lane per row;
//   4. forms P V, one lane per (row, 16-byte chunk of hd), stages the output
//      in the q buffer and writes it back along hd as in 1.
// Warps synchronise only with __syncwarp: no data is shared across warps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxFrames = 32;
constexpr int kMaxWarps = 4;

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

template <typename T, int JPL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = p.warps * p.warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      temporal_fwd_kernel<T, JPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
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

int max_block_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
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
// 1 = bfloat16. Returns a cudaError_t (0 on success).
int temporal_attn_fwd(const void* q, const void* k, const void* v, void* o,
                      long long BF, long long D, int C, int F, int H,
                      float scale, int dtype, int vec, void* stream) {
  if (BF <= 0 || D <= 0 || C <= 0 || H <= 0 || F <= 0 || F > kMaxFrames ||
      BF % F != 0 || C % H != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.D = D;
  p.C = C; p.F = F; p.H = H; p.hd = C / H;
  p.units = BF / F * D * H;
  p.scale = scale;
  p.vec = vec;
  const int esize = dtype == 1 ? 2 : 4;
  if (!plan(F, p.hd, esize, &p)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_frames<__nv_bfloat16>(p, s)
                          : launch_frames<float>(p, s));
}

// The warps a block and the shared memory a launch at (F, hd) would use; 0
// when it cannot launch.
int temporal_attn_fwd_plan(int F, int hd, int dtype, int* warps, int* smem) {
  if (F <= 0 || F > kMaxFrames || hd <= 0) return 0;
  Params p;
  if (!plan(F, hd, dtype == 1 ? 2 : 4, &p)) return 0;
  *warps = p.warps;
  *smem = p.warps * p.warp_bytes;
  return 1;
}

const char* temporal_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
