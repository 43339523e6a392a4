// Warp-level tensor-core building blocks in inline PTX, shared by the
// redesigned kernels (gn_silu_conv.cu, flash_attn_fwd.cu,
// flash_attn_bwd.cu): ldmatrix fragment loads, mma.sync m16n8k16 bf16 and
// m16n8k8 TF32 with f32 accumulators, the round to TF32, and cp.async
// copies (16, 8 or 4 bytes, zero-filled past the source's valid bytes)
// with their group commit/wait, and the staging of token rows into skewed
// [rows][LD] tiles. These are the sm_80 instructions; sm_90a runs them as
// they are.
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
// Fragment layouts of mma.m16n8k8 with .tf32 operands (one 32-bit element
// a register):
//   A (16 x 8, row-major):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k x n):       b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8, f32):        as m16n8k16's
// C is not A here: a C fragment holds columns 2t and 2t + 1, A wants t and
// t + 4. Where a product's C becomes the next product's A over a summed
// index (P of S = Q K^T into O += P V), take a = (c0, c2, c1, c3): A's k
// index t then stands for column 2t and t + 4 for 2t + 1, and B's rows
// must follow (b0 from row 2t, b1 from row 2t + 1). The same ldmatrix of
// 8 x 8 b16 reads an 8-row x 4-float matrix: lane l gets element (l / 4,
// l % 4), which is B's layout for a matrix stored n-major ([n][k]). The
// tensor core drops the low 13 mantissa bits of a .tf32 operand, so each
// is rounded first (to_tf32: cvt.rna, to nearest, ties away from zero).
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

// A 32-bit shared-memory load kept in program order among the volatile
// asm here (ldmatrix, mma): a loop of loads then products then stays in
// that order, so the compiler does not hoist every later load into
// registers ahead of the products (which spilled the TF32 kernel's).
__device__ __forceinline__ uint32_t lds_b32(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
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

// d += a * b, TF32 operands (to_tf32 bits), f32 accumulators
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32 -> the nearest TF32 value (ties away from zero), as the bits of an
// f32 register
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
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

// cp_async_wait with a memory clobber, for a caller that reads the copied
// data with plain loads (the compiler keeps them after the wait)
template <int kPending>
__device__ __forceinline__ void cp_async_wait_mem() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy ROWS rows of D elements (row `row0` on, of n, row stride st) into a
// [ROWS][LD] tile with NT threads; rows past n and columns past D (up to
// DK) are zero. kGran: bytes a cp.async moves (16, 8, 4), or 0 for
// synchronous element copies (bf16 only: an f32 row always moves in 4-byte
// copies). kRolled keeps the copy a loop, which leaves
// the caller's registers to its products: the inference instances measured
// faster so (118-164 registers against 195-255 when the compiler unrolls
// it; d = 512 ran the same either way at fewer registers), while some
// training instances then spilled a few bytes; those leave the loop to the
// compiler.
template <int ROWS, int DK, int NT, int kGran, bool kRolled, int LD,
          typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long st, int row0, int n,
                                           int D) {
  constexpr int E = kGran ? kGran / (int)sizeof(T) : 1, per_row = DK / E;
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

// bf16 rows into [ROWS][DK + 8] tiles (a 16-byte skew), any granule
template <int ROWS, int DK, int NT, bool kRolled = true>
__device__ __forceinline__ void stage_rows_any(int gran, __nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int row0, int n,
                                               int D) {
  constexpr int LD = DK + 8;
  switch (gran) {
    case 16: stage_rows<ROWS, DK, NT, 16, kRolled, LD>(dst, src, st, row0, n, D); break;
    case 8: stage_rows<ROWS, DK, NT, 8, kRolled, LD>(dst, src, st, row0, n, D); break;
    case 4: stage_rows<ROWS, DK, NT, 4, kRolled, LD>(dst, src, st, row0, n, D); break;
    default: stage_rows<ROWS, DK, NT, 0, kRolled, LD>(dst, src, st, row0, n, D); break;
  }
}

// f32 rows into [ROWS][LD] tiles in 16-, 8- or 4-byte copies
template <int ROWS, int DK, int LD, int NT>
__device__ __forceinline__ void stage_rows_f32(int gran, float* dst,
                                               const float* src,
                                               long long st, int row0, int n,
                                               int D) {
  switch (gran) {
    case 16: stage_rows<ROWS, DK, NT, 16, true, LD>(dst, src, st, row0, n, D); break;
    case 8: stage_rows<ROWS, DK, NT, 8, true, LD>(dst, src, st, row0, n, D); break;
    default: stage_rows<ROWS, DK, NT, 4, true, LD>(dst, src, st, row0, n, D); break;
  }
}

// Round a tile that stage_rows_f32 staged with granule kGran to TF32 in
// place (to_tf32 bits, which only a TF32 product reads), each thread the
// elements it copied itself: its own cp.async copies are visible to it
// after its cp_async_wait, so the one barrier that publishes the tile
// comes after this. kBatch: copies rounded together (their loads in
// flight at once; more registers).
template <int ROWS, int DK, int LD, int NT, int kGran, int kBatch>
__device__ __forceinline__ void round_rows_tf32(float* tile) {
  constexpr int E = kGran / 4, per_row = DK / E, n = ROWS * per_row / NT;
  static_assert(ROWS * per_row % NT == 0, "whole rounds of copies");
#pragma unroll (kBatch)
  for (int it = 0; it < n; ++it) {
    const int i = threadIdx.x + it * NT;
    float* x = tile + (i / per_row) * LD + (i % per_row) * E;
    if constexpr (E == 4) {
      float4 v = *reinterpret_cast<const float4*>(x);
      v = make_float4(__uint_as_float(to_tf32(v.x)), __uint_as_float(to_tf32(v.y)),
                      __uint_as_float(to_tf32(v.z)), __uint_as_float(to_tf32(v.w)));
      *reinterpret_cast<float4*>(x) = v;
    } else if constexpr (E == 2) {
      float2 v = *reinterpret_cast<const float2*>(x);
      v = make_float2(__uint_as_float(to_tf32(v.x)), __uint_as_float(to_tf32(v.y)));
      *reinterpret_cast<float2*>(x) = v;
    } else {
      x[0] = __uint_as_float(to_tf32(x[0]));
    }
  }
}

template <int ROWS, int DK, int LD, int NT, int kBatch>
__device__ __forceinline__ void round_rows_tf32_any(int gran, float* tile) {
  switch (gran) {
    case 16: round_rows_tf32<ROWS, DK, LD, NT, 16, kBatch>(tile); break;
    case 8: round_rows_tf32<ROWS, DK, LD, NT, 8, kBatch>(tile); break;
    default: round_rows_tf32<ROWS, DK, LD, NT, 4, kBatch>(tile); break;
  }
}

}  // namespace
