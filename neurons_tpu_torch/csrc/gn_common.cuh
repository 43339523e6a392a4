// GroupNorm helpers shared by the GroupNorm+SiLU kernel (gn_silu.cu) and
// the GroupNorm+SiLU+3x3-conv kernel (gn_silu_conv.cu), on the port's
// channels-first layout: x [N, C, HW], in which each (sample n, group g) is
// one contiguous slab of L = (C / G) * HW elements.
//
// Always: element conversions, the GroupNorm parameters in f32 or bf16,
// SiLU and a block sum.
//
// Where the includer defines GN_STATS_NAME(kernel) (gn_silu_conv.cu), also
// moments (count, mean, centred M2) with Chan's pairwise combine in f32,
// and the chunked statistics in two launches (named <prefix>partial_kernel and
// <prefix>finalize_kernel):
//   partial_kernel      splits every slab into chunks of kStatChunk elements,
//                       one block per (slab, chunk), so that even 32 slabs
//                       (the 768x768 VAE decode at batch 1) fill the card.
//                       A block holds its chunk in registers and takes the
//                       chunk's count, mean and centred M2 = sum (x - mean)^2
//                       in two passes over those registers, in f32 (the
//                       second also corrects the mean): the
//                       JAX kernel's two-pass stability
//                       (neurons_tpu/ops/fused_norm.py:113-117) at one read
//                       of x from device memory.
//   finalize_kernel     one block per slab merges its chunks with Chan's
//                       parallel combine, in a fixed order (no atomics: the
//                       same bits on every run), and writes per-(n, c) f32
//                       terms of the affine, y = (x - mean[n, c]) *
//                       scale[n, c] + shift[n, c], with scale = rstd * gamma
//                       and shift = beta.
// The prefix gives these kernels a name of the including library's own, so
// that a profile credits them to it. gn_silu.cu takes its statistics in its
// own cluster kernels instead.
// Each .cu file is compiled on its own into its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// element i of a parameter vector held in f32 or bf16
__device__ __forceinline__ float param_at(const void* p, long long i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// Sum over the block, the same value (and the same bits) in every thread.
// `red` holds one float per warp.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

#ifdef GN_STATS_NAME

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise update of (count, mean, M2)
__device__ __forceinline__ Moments combine(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float d = b.mean - a.mean, fb = b.n / n;
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

constexpr int kStatThreads = 256;
constexpr int kStatPerThread = 16;
constexpr int kStatChunk = kStatThreads * kStatPerThread;  // elements a block

// part[slab * chunks + chunk] = (count, mean, M2, 0) of one chunk
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
GN_STATS_NAME(partial_kernel)(const T* __restrict__ x, long long L,
                              int chunks, float4* __restrict__ part) {
  __shared__ float red[kStatThreads / 32];
  const long long slab = blockIdx.x / chunks;
  const int chunk = (int)(blockIdx.x % chunks);
  const long long start = (long long)chunk * kStatChunk;
  const int cnt = (int)min((long long)kStatChunk, L - start);
  const T* xs = x + slab * L + start;
  float v[kStatPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kStatPerThread; ++i) {
    const int e = i * kStatThreads + threadIdx.x;
    v[i] = e < cnt ? to_f(xs[e]) : 0.f;
    s += v[i];
  }
  const float m1 = block_sum(s, red) / (float)cnt;
  // second pass over the registers: the centred sums, and the mean's
  // correction sum (x - m1) / cnt (Bjorck's corrected two-pass form), so
  // that a large mean is not left with the first pass's rounding
  float sd = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < kStatPerThread; ++i) {
    const int e = i * kStatThreads + threadIdx.x;
    const float d = e < cnt ? v[i] - m1 : 0.f;
    sd += d;
    q = fmaf(d, d, q);
  }
  sd = block_sum(sd, red);
  q = block_sum(q, red);
  const float c = sd / (float)cnt;
  if (threadIdx.x == 0)
    part[slab * chunks + chunk] =
        make_float4((float)cnt, m1 + c, fmaxf(q - sd * c, 0.f), 0.f);
}

// One block per slab (n, g): merge the chunks, then write mean, scale and
// shift of the group's C / G channels of sample n, each [N, C] f32.
__global__ void __launch_bounds__(kStatThreads)
GN_STATS_NAME(finalize_kernel)(const float4* __restrict__ part, int chunks,
                               int C, int G, float eps, const void* gamma,
                               const void* beta, int param_bf16,
                               float* __restrict__ mean_out,
                               float* __restrict__ scale_out,
                               float* __restrict__ shift_out) {
  __shared__ float sn[kStatThreads], smean[kStatThreads], sm2[kStatThreads];
  __shared__ float stat[2];
  const long long slab = blockIdx.x;
  Moments acc = {0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < chunks; c += kStatThreads) {
    const float4 p = part[slab * chunks + c];
    acc = combine(acc, {p.x, p.y, p.z});
  }
  sn[threadIdx.x] = acc.n;
  smean[threadIdx.x] = acc.mean;
  sm2[threadIdx.x] = acc.m2;
  __syncthreads();
  for (int w = kStatThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const int o = threadIdx.x + w;
      const Moments r = combine({sn[threadIdx.x], smean[threadIdx.x],
                                 sm2[threadIdx.x]},
                                {sn[o], smean[o], sm2[o]});
      sn[threadIdx.x] = r.n;
      smean[threadIdx.x] = r.mean;
      sm2[threadIdx.x] = r.m2;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stat[0] = smean[0];
    // population variance, as the plain version's mean of squares
    stat[1] = 1.f / sqrtf(sm2[0] / sn[0] + eps);
  }
  __syncthreads();
  const int cg = C / G;
  const long long n = slab / G;
  const int c0 = (int)(slab % G) * cg;
  for (int i = threadIdx.x; i < cg; i += kStatThreads) {
    const long long nc = n * C + c0 + i;
    mean_out[nc] = stat[0];
    scale_out[nc] = stat[1] * param_at(gamma, c0 + i, param_bf16);
    shift_out[nc] = param_at(beta, c0 + i, param_bf16);
  }
}

inline int stat_chunks(long long L) {
  return (int)((L + kStatChunk - 1) / kStatChunk);
}

// Bytes of scratch the statistics need: the partials, then mean, scale and
// shift ([N, C] f32 each).
inline long long stat_scratch_bytes(long long N, long long C, long long HW,
                                    int G) {
  const long long L = C / G * HW;
  return N * G * stat_chunks(L) * (long long)sizeof(float4) +
         3 * N * C * (long long)sizeof(float);
}

// Both statistics launches on `stream`; the per-(n, c) terms land at
// scratch + the partials, as mean, scale, shift.
template <typename T>
cudaError_t launch_stats(const T* x, long long N, int C, long long HW, int G,
                         float eps, const void* gamma, const void* beta,
                         int param_bf16, void* scratch, float** mean,
                         float** scale, float** shift, cudaStream_t stream) {
  const long long L = C / G * HW;
  const int chunks = stat_chunks(L);
  const long long slabs = N * G;
  float4* part = static_cast<float4*>(scratch);
  *mean = reinterpret_cast<float*>(part + slabs * chunks);
  *scale = *mean + N * C;
  *shift = *scale + N * C;
  GN_STATS_NAME(partial_kernel)<T><<<(unsigned)(slabs * chunks),
                                     kStatThreads, 0, stream>>>(x, L, chunks,
                                                                part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GN_STATS_NAME(finalize_kernel)<<<(unsigned)slabs, kStatThreads, 0,
                                   stream>>>(
      part, chunks, C, G, eps, gamma, beta, param_bf16, *mean, *scale,
      *shift);
  return cudaGetLastError();
}

#endif  // GN_STATS_NAME

}  // namespace
