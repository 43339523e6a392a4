// Pieces shared by the flash-attention forward (flash_attn_fwd.cu) and
// backward (flash_attn_bwd.cu): the tensor-core fragment types of each input
// type (WMMA bf16 16x16x16, or TF32 16x16x8 for f32 inputs), the tile loader
// that zero-pads ragged rows and the head dim in shared memory, warp
// reductions, and the bias addressing.
//
// Each .cu file is compiled on its own into its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;     // depth of one tensor-core step
  static constexpr int kSkew = 8;  // row padding of 16-bit tiles (16 bytes)
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename F>
  __device__ static void to_tf32(F&) {}
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  static constexpr int kSkew = 4;  // row padding of 32-bit tiles (16 bytes)
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                           wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                              wmma::precision::tf32, wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename F>
  __device__ static void to_tf32(F& f) {
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
  }
  __device__ static float from_float(float x) { return x; }
  __device__ static float to_float(float x) { return x; }
};

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Copy `rows` rows of D elements starting at row `row0` of a [n, D] operand
// (row stride `st`) into a [rows, ldt] shared tile; rows past n and columns
// past D are zero.
template <typename T>
__device__ void load_tile(T* dst, const T* src, long long st, int row0, int n,
                          int rows, int D, int DP, int ldt, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = DP / V;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * V;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < n && c < D)
        val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
      *reinterpret_cast<uint4*>(dst + r * ldt + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      T val = Mma<T>::from_float(0.f);
      if (row0 + r < n && c < D) val = src[(long long)(row0 + r) * st + c];
      dst[r * ldt + c] = val;
    }
  }
}

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The additive bias is [N, Tq, Tk] with N in {1, H, B*H}; its slice for the
// (b, h) row of q. mode 0: no bias, 1: one slice shared by all rows,
// 2: one per head (shared over the batch), 3: one per (b, h).
__host__ __device__ inline int bias_slice(int mode, int bh, int H) {
  return mode == 1 ? 0 : (mode == 2 ? bh % H : bh);
}

int max_block_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace
