// Warp-level tensor-core building blocks in inline PTX, shared by the
// redesigned bf16 kernels (gn_silu_conv.cu, flash_attn_fwd.cu,
// flash_attn_bwd.cu): ldmatrix fragment loads, mma.sync m16n8k16 bf16 with
// f32 accumulators, and cp.async copies (16, 8 or 4 bytes, zero-filled past
// the source's valid bytes) with their group commit/wait, and the staging
// of token rows into skewed [rows][D + 8] tiles. These are the sm_80
// instructions; sm_90a runs them as they are.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                           a3 (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// ldmatrix (non-trans) of an 8 x 8 b16 matrix gives lane l row l / 4,
// columns 2(l % 4)..+1; .trans gives the transposed element pair, which is
// B's layout for a matrix stored k-major ([k][n], n contiguous).
//
// Each .cu file is compiled on its own into its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a * b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `bytes` (16, 8 or 4) from global to shared; only the first
// `src_bytes` are read and the rest of the destination is zeroed (0 reads
// nothing, and `src` must still be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copy ROWS rows of D elements (row `row0` on, of n, row stride st) into a
// [ROWS][LD] tile with NT threads; rows past n and columns past D (up to
// DK) are zero. kGran: bytes a cp.async moves (16, 8, 4), or 0 for
// synchronous element copies. kRolled keeps the copy a loop, which leaves
// the caller's registers to its products: the inference instances measured
// faster so (118-164 registers against 195-255 when the compiler unrolls
// it; d = 512 ran the same either way at fewer registers), while some
// training instances then spilled a few bytes; those leave the loop to the
// compiler.
template <int ROWS, int DK, int NT, int kGran, bool kRolled>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int row0, int n,
                                           int D) {
  constexpr int LD = DK + 8;
  constexpr int E = kGran ? kGran / 2 : 1, per_row = DK / E;
  auto copy = [&](int i) {
    const int r = i / per_row, c = (i % per_row) * E;
    const bool ok = row0 + r < n && c < D;
    if constexpr (kGran == 0) {
      dst[r * LD + c] = ok ? src[(long long)(row0 + r) * st + c]
                           : __float2bfloat16(0.f);
    } else {
      cp_async<kGran>(smem_addr(dst + r * LD + c),
                      ok ? src + (long long)(row0 + r) * st + c : src,
                      ok ? kGran : 0);
    }
  };
  if constexpr (kRolled) {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * per_row; i += NT) copy(i);
  } else {
    for (int i = threadIdx.x; i < ROWS * per_row; i += NT) copy(i);
  }
}

template <int ROWS, int DK, int NT, bool kRolled = true>
__device__ __forceinline__ void stage_rows_any(int gran, __nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int row0, int n,
                                               int D) {
  switch (gran) {
    case 16: stage_rows<ROWS, DK, NT, 16, kRolled>(dst, src, st, row0, n, D); break;
    case 8: stage_rows<ROWS, DK, NT, 8, kRolled>(dst, src, st, row0, n, D); break;
    case 4: stage_rows<ROWS, DK, NT, 4, kRolled>(dst, src, st, row0, n, D); break;
    default: stage_rows<ROWS, DK, NT, 0, kRolled>(dst, src, st, row0, n, D); break;
  }
}

}  // namespace
