// What the wgmma kernels of the prior's biased multi-query attention
// (flash_attn_fwd_bias_sm90.cu, flash_attn_bwd_bias_sm90.cu) share: the
// staging of token rows TMA cannot address into the swizzled tiles the
// wgmma descriptors read, and the bias's reads.
//
// A tile is 64 token rows of 128 bytes: the head dim (D <= 64, D % 4 == 0)
// zero-padded to 64 bf16, each row swizzled as a 128-byte TMA box would
// write it (16-byte chunk c of row r at chunk c ^ (r % 8)), so the tile
// starts on a 1024-byte boundary and the descriptors are the 128-byte
// swizzle's (K-major: SBO = 8 rows, a k16 step 32 bytes on; MN-major: a k16
// step 16 rows on). The prior's rows (d 52) are 104 bytes with 104-byte
// token strides, no multiple of 16: TMA cannot take them, so each row moves
// in D / 4 cp.async copies of 8 bytes into its swizzled place, issued by
// the threads that read the tile. The pad pieces (D / 4 .. 15 of a row) are
// zeroed once per kernel and never written again; rows past the tensor's
// end are zero-filled by the copy (src-size 0). The writers wait for their
// copies, fence (generic -> async proxy) and meet at a barrier before a
// wgmma reads the tile.

#pragma once

#include "mma_sm80.cuh"  // cp_async, cp_async_commit, cp_async_wait
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = 128;              // one tile row: 64 bf16
constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr int kMode = 1;                    // the 128-byte swizzle
constexpr int kMaxKeyTiles = 9;             // Tk <= 576 (the prior's 514)

// byte offset of 8-byte piece j (bf16 columns 4j .. 4j + 3) of row r in a
// swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * kRowBytes + (((j >> 1) ^ (r & 7)) << 4) + ((j & 1) << 3));
}

// zero the pad pieces (np .. 15) of `rows` rows from `tile`, by `nthreads`
// threads from `tid` (generic stores: the caller's fence and barrier make
// them visible to the products)
__device__ __forceinline__ void zero_pads(unsigned char* tile, int rows,
                                          int np, int tid, int nthreads) {
  const int pads = 16 - np;
  for (int i = tid; i < rows * pads; i += nthreads) {
    const int r = i / pads, j = np + i % pads;
    *reinterpret_cast<uint2*>(tile + swz(r, j)) = make_uint2(0u, 0u);
  }
}

// rows row0 .. row0 + 63 of a token-major bf16 matrix (row stride st
// elements, np = D / 4 pieces a row) into the swizzled tile at `tile`,
// zero past row n; thread tid of nthreads (a multiple of 16): lane group
// tid / 16 takes every (nthreads / 16)-th row, lane tid % 16 its piece, so
// 16 neighbouring threads read one row
__device__ __forceinline__ void stage_tile(uint32_t tile,
                                           const __nv_bfloat16* base,
                                           long long st, int row0, int n,
                                           int np, int tid, int nthreads) {
  const int j = tid & 15;
  if (j >= np) return;
  for (int r = tid >> 4; r < kTileRows; r += nthreads >> 4) {
    const int row = row0 + r;
    const bool ok = row < n;
    const __nv_bfloat16* src = base + (ok ? (long long)row * st : 0) + 4 * j;
    cp_async<8>(tile + swz(r, j), src, ok ? 8 : 0);
  }
}

// the bf16 pair of row `row` (a pointer to its element 0, 4-byte aligned
// at even columns) at columns col, col + 1 (col even), as one word; 0 past
// n columns (at an odd n the last pair's second element)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row,
                                             int col, int n) {
  if (col + 1 < n) return *reinterpret_cast<const uint32_t*>(row + col);
  if (col >= n) return 0u;
  return (uint32_t)*reinterpret_cast<const unsigned short*>(row + col);
}

// a register A fragment (mma m16n8k16 layout, per warp: rows g and g + 8,
// columns 2t.., 2t + 8..) of k16 step kk of 16 token rows from global
// memory; zero past D columns and for a row past the tensor (nullptr)
__device__ __forceinline__ void load_a_frag(uint32_t* a,
                                            const __nv_bfloat16* r0,
                                            const __nv_bfloat16* r1, int kk,
                                            int t4, int D) {
  const int c0 = 16 * kk + 2 * t4, c1 = c0 + 8;
  a[0] = (r0 && c0 < D) ? *reinterpret_cast<const uint32_t*>(r0 + c0) : 0u;
  a[1] = (r1 && c0 < D) ? *reinterpret_cast<const uint32_t*>(r1 + c0) : 0u;
  a[2] = (r0 && c1 < D) ? *reinterpret_cast<const uint32_t*>(r0 + c1) : 0u;
  a[3] = (r1 && c1 < D) ? *reinterpret_cast<const uint32_t*>(r1 + c1) : 0u;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// an accumulator's registers packed to bf16 pairs: the A fragments of the
// k16 steps over its N columns (chunks 2 kk and 2 kk + 1 of C are A's k
// step kk)
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16x2(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// acc (64 x 64) = A B^T over KS k16 steps, both K-major swizzled tiles of
// 128-byte rows, issued under one fence, not committed; the first step
// overwrites acc
template <int KS>
__device__ __forceinline__ void issue_ss64(float* acc, uint32_t a,
                                           uint32_t b) {
  uint64_t da[KS], db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    da[ks] = gmma_desc(a + 32 * ks, 16, 8 * kRowBytes, kMode);
    db[ks] = gmma_desc(b + 32 * ks, 16, 8 * kRowBytes, kMode);
  }
  pin<KS>(da);
  pin<KS>(db);
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));
  wgmma_fence();
  Wgmma<64>::ss0(acc, da[0], db[0], zero);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) Wgmma<64>::ss(acc, da[ks], db[ks], one);
}

// acc (64 x DN) += A B over the 64 rows of B: A the bf16 fragments a[4] in
// registers, B the tile at b read MN-major (its rows the product's depth),
// issued under one fence, not committed
template <int DN>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t (*a)[4],
                                         uint32_t b) {
  uint64_t db[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    db[kk] = gmma_desc(b + kk * 16 * kRowBytes, kTileBytes, 8 * kRowBytes,
                       kMode);
  pin<4>(db);
  int one = 1;
  asm volatile("" : "+r"(one));
  fence_regs<DN / 2>(acc);
  fence_regs<16>(&a[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<DN>::rs(acc, a[kk], db[kk], one);
}

}  // namespace
