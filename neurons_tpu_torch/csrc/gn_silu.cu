// GroupNorm followed by SiLU for Hopper (sm_90a), on channels-first tensors,
// bound through a plain C interface and loaded with ctypes
// (neurons_tpu_torch/ops/fused_norm.py).
//
// Replaces the JAX package's Pallas TPU kernel
//   neurons_tpu/ops/fused_norm.py:102  _kernel  (launched by _pallas_gn_silu)
// which computes, for x [N, HW, C] NHWC, the group statistics of each sample
// (two-pass centred variance, f32), the affine and SiLU, one sample per
// program with the whole sample in VMEM and the group sums as one-hot [C, G]
// matmuls. None of that tiling carries over: here x is [N, C, HW] (the
// port's layout, never transposed), each (n, group) is one contiguous slab,
// and the statistics split every slab over many blocks (gn_common.cuh).
// The TPU's VMEM cap (fused_norm.py:167-171) has no counterpart: every shape
// launches, the 768x768 VAE decode at [1, 256, 768, 768] included.
//
// Three launches: the two statistics kernels of gn_common.cuh, then
// gn_silu_apply_kernel, which computes silu((x - mean) * scale + shift) in
// f32 per element and writes it in x's type (bf16 or f32).
//
// What bounds it on an H100: a few operations per element, so bytes: x read
// once and y written once, 2 * 2 bytes an element in bf16 (604 MB, 0.18 ms
// at 3.35 TB/s, for the 768x768 decode's input). This kernel reads x twice
// (statistics, apply).

#define GN_STATS_NAME(kernel) gn_silu_stats_##kernel
#include "gn_common.cuh"

namespace {

constexpr int kApplyThreads = 256;

template <typename T, int V>
struct Pack;  // V consecutive elements moved as one 16-byte access

template <>
struct Pack<__nv_bfloat16, 8> {
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
    for (int t = 0; t < 4; ++t)
      h[t] = __floats2bfloat162_rn(in[2 * t], in[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Pack<float, 4> {
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
};

template <typename T>
struct Pack<T, 1> {
  __device__ static void load(const T* p, float* out) { out[0] = to_f(*p); }
  __device__ static void store(T* p, const float* in) {
    *p = from_f<T>(in[0]);
  }
};

// Each thread takes V consecutive elements of one (n, c) row (HW % V == 0).
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
gn_silu_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ mean,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, long long total,
                     long long HW) {
  const long long i0 =
      ((long long)blockIdx.x * kApplyThreads + threadIdx.x) * V;
  if (i0 >= total) return;
  const long long row = i0 / HW;
  const float m = mean[row], a = scale[row], b = shift[row];
  float v[V];
  Pack<T, V>::load(x + i0, v);
#pragma unroll
  for (int t = 0; t < V; ++t) v[t] = silu((v[t] - m) * a + b);
  Pack<T, V>::store(y + i0, v);
}

template <typename T, int V>
cudaError_t launch_apply(const T* x, T* y, const float* mean,
                         const float* scale, const float* shift,
                         long long total, long long HW, cudaStream_t stream) {
  const long long blocks = (total / V + kApplyThreads - 1) / kApplyThreads;
  gn_silu_apply_kernel<T, V><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      x, y, mean, scale, shift, total, HW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* gamma, const void* beta, void* y,
                void* scratch, long long N, int C, long long HW, int G,
                float eps, int param_bf16, int vec, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  float *mean, *scale, *shift;
  cudaError_t err = launch_stats<T>(xt, N, C, HW, G, eps, gamma, beta,
                                    param_bf16, scratch, &mean, &scale,
                                    &shift, stream);
  if (err != cudaSuccess) return err;
  const long long total = N * C * HW;
  constexpr int V = 16 / sizeof(T);
  if (vec)
    return launch_apply<T, V>(xt, static_cast<T*>(y), mean, scale, shift,
                              total, HW, stream);
  return launch_apply<T, 1>(xt, static_cast<T*>(y), mean, scale, shift,
                            total, HW, stream);
}

}  // namespace

extern "C" {

// x, y: contiguous [N, C, HW]; gamma, beta: [C] (f32, or bf16 when
// param_bf16); scratch: gn_silu_scratch_bytes(N, C, HW, G) bytes, 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. vec: HW is a multiple of
// 16 / element size and x, y are 16-byte aligned. Returns a cudaError_t
// (0 on success).
int gn_silu(const void* x, const void* gamma, const void* beta, void* y,
            void* scratch, long long N, int C, long long HW, int G, float eps,
            int dtype, int param_bf16, int vec, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long L = C / G * HW;
  if (N * G * (long long)stat_chunks(L) > 0x7fffffffLL ||
      N * C * HW / (vec ? 16 / (dtype == 1 ? 2 : 4) : 1) / kApplyThreads >
          0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? run<__nv_bfloat16>(x, gamma, beta, y, scratch, N, C, HW,
                                        G, eps, param_bf16, vec, s)
                   : run<float>(x, gamma, beta, y, scratch, N, C, HW, G, eps,
                                param_bf16, vec, s));
}

long long gn_silu_scratch_bytes(long long N, long long C, long long HW,
                                int G) {
  return stat_scratch_bytes(N, C, HW, G);
}

const char* gn_silu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
