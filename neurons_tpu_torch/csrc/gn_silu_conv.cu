// GroupNorm -> SiLU -> 3x3 same-pad convolution for Hopper (sm_90a), on
// channels-first tensors, bound through a plain C interface and loaded with
// ctypes (neurons_tpu_torch/ops/fused_conv.py).
//
// Replaces the JAX package's Pallas TPU kernel
//   neurons_tpu/ops/fused_conv.py:91  _kernel  (launched by
//   _pallas_gn_silu_conv)
// which brings one NHWC sample into VMEM, normalises and activates it in
// place and runs the conv as 9 shifted [rows * W, Cin] x [Cin, Cout] MXU
// products; the normalised tensor never reaches HBM. That is what carries
// over. Its tiling and its shape gates (C % 128, HW >= 1024, an 8 MB
// sample, fused_conv.py:215-231) are TPU limits and do not: every shape
// launches here.
//
// Steps on the port's layout, x [N, Cin, H, W] (never transposed in device
// memory):
//   1. the GroupNorm statistics of gn_common.cuh (two launches): per-(n, c)
//      mean, scale = rstd * gamma, shift = beta, from the centred two-pass
//      moments; the JAX wrapper's single-pass E[x^2] - mean^2
//      (fused_conv.py:72) is not copied;
//   2. the conv as an implicit GEMM with the activation applied while its
//      input is staged, never written to device memory;
//   3. where the grid is small, split over input channels: a fixed-order
//      reduction of the f32 partial sums (no atomics: the same bits on
//      every run) that adds the bias and writes y.
//
// The bf16 instance (gn_silu_conv_halo_kernel) is a staged-halo implicit
// GEMM. A block owns 128 output pixels (256 where BN = 64) made of whole
// rows of one sample (R rows x W, or S whole samples when a sample is at
// most half the tile; rows of more than 128 pixels are cut into column
// tiles) and a BN-wide tile of output channels (BN = 128, 64 for Cout =
// 320, or 16 for the UNet head's Cout = 4); each of its 8 warps holds a
// 64 x 32 tile of the output (16 x 16 at BN = 16). For every chunk of 32
// input channels it stages the (R + 2) x (W + 2) halo of those rows once:
// 16-byte loads along W (contiguous in NCHW), the chunk's mean, scale and
// shift loaded with them, the affine and SiLU applied once per element, and
// the result written to shared memory transposed to [halo pixel][channel]
// (64 bytes a pixel, the 16-byte chunks XOR-swizzled by the pixel index
// against bank conflicts). Halo pixels outside the image stay zero: the
// conv pads the ACTIVATED tensor (JAX fused_conv.py:110-114), so a pad tap
// is 0, not SiLU(shift). The 9 taps are then 9 shifted row-address sets
// into that one tile, read by ldmatrix as A fragments. B, the weights
// packed to [9, Kc, Np] (tap, Cin padded to 32, Cout padded to BN), comes
// in by cp.async, the whole chunk's 9 x 32 x BN slice, double-buffered
// with the halo: the next chunk's weights and raw x are in flight while
// the current chunk's 18 k16 steps run as mma.sync m16n8k16 with f32
// accumulators in registers. One barrier a chunk. Where the output tiles
// fill fewer than two waves of the card (the 4x4, 8x8 and 24x24 levels),
// the chunks are split across blocks (grid z) into a workspace from the
// wrapper, then reduced in a fixed order.
//
// The f32 instance (gn_silu_conv_tf32_kernel) serves only the small
// card-vs-CPU checks and keeps the first design: a WMMA TF32 implicit GEMM
// over 128-pixel x 64-channel tiles that gathers and activates every A
// element per tap and per Cout tile.
//
// What bounds it on an H100: 2 * M * Cout * 9 * Cin operations at 989
// TFLOP/s (bf16), against x read once, W read and y written at 3.35 TB/s:
// the ResBlock convs are bound by operations, the Cout = 4 head by bytes.
// mma.sync reaches a part of the wgmma peak; the measured times stand in
// PERF.md.

#include <mma.h>

#include <algorithm>

#define GN_STATS_NAME(kernel) gn_conv_stats_##kernel
#include "gn_common.cuh"
#include "mma_sm80.cuh"

namespace {

using namespace nvcuda;

// The activation on the conv's operand path: exp on the fast unit (a few
// ulp of f32, far below the bf16 or TF32 rounding that follows).
__device__ __forceinline__ float silu_operand(float v) {
  return v / (1.f + __expf(-v));
}

constexpr int kChunk = 32;  // input channels a K step (the packed Kc pad)

// ---------------------------------------------------------------------------
// bf16: the staged-halo implicit GEMM

constexpr int kSlots = 128;      // output pixels a block owns (256 at BN = 64)
constexpr int kMaxHalo = 400;    // halo pixels a block stages
constexpr int kHThreads = 256;   // 8 warps
constexpr int kBRows = 9 * kChunk;  // packed weight rows of one chunk
constexpr int kMaxItems = 3;     // staged (sample, 8-pixel vector, channel
                                 // pair) items a thread
constexpr int kHaloBytes = kMaxHalo * kChunk * 2;

// the pixels a block owns for an N tile: 256 at BN = 64, so that every
// warp holds a 64 x 32 tile of the output, as at BN = 128
constexpr int slots_for(int bn) { return bn == 64 ? 2 * kSlots : kSlots; }

template <int BN>
struct HaloCfg {
  static constexpr int kSlotsB = slots_for(BN);
  static constexpr int kWarpsN = BN == 128 ? 4 : (BN == 64 ? 2 : 1);
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int WM = kSlotsB / kWarpsM;  // 64, 64, 16 pixels a warp
  static constexpr int WN = BN / kWarpsN;       // 32, 32, 16 channels a warp
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int CPR = BN / 8;           // 16-byte chunks a B row
  static constexpr int kBBytes = kBRows * BN * 2;
  static constexpr int kSmem = 2 * kBBytes + 2 * kHaloBytes;
  // blocks an SM holds (shared memory decides)
  static constexpr int kPerSM = 232448 / kSmem;
};

// B rows are [k][BN] bf16; the 16-byte chunk index is XORed with the row so
// that ldmatrix.trans's 8 rows at one chunk hit 8 different bank groups.
template <int CPR>
__device__ __forceinline__ int b_swz(int row, int ch) {
  if constexpr (CPR >= 8) {
    return ch ^ (row & 7);
  } else {
    return ch ^ ((row >> 2) & 1);  // CPR == 2: 32-byte rows
  }
}

// element q of 8 bf16 held in a uint4, as f32 (q known at compile time)
__device__ __forceinline__ float bf16_at(const uint4& v, int q) {
  const uint32_t w = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}

// byte offset of channel chunk c (0..3, 8 channels each) of halo pixel pos
__device__ __forceinline__ int halo_off(int pos, int c) {
  return pos * (kChunk * 2) + ((c ^ ((pos >> 1) & 3)) << 4);
}

struct HaloParams {
  const __nv_bfloat16* x;  // [N, Cin, H, W]
  const __nv_bfloat16* w;  // packed [9, Kc, Np]
  const void* bias;        // [Cout] or null
  __nv_bfloat16* y;        // [N, Cout, H, W]
  float* ws;               // [splits, N, Cout, H, W] f32 partials, or null
  const float* mean;       // [N, Cin] each
  const float* scale;
  const float* shift;
  long long HW;
  int N, Cin, H, W, Cout, Kc, Np, bias_bf16;
  int S, R, Wt;       // a tile: S samples x R rows x Wt columns
  int ry, cx;         // row tiles and column tiles of a sample
  int nvmax;          // 8-element vectors of a sample's widest halo span
  int vec;            // 1: halo rows move in 16-byte loads
  int nchunks, cps;   // Cin chunks, chunks a split
};

template <int BN>
__global__ void __launch_bounds__(kHThreads, 1)
gn_silu_conv_halo_kernel(HaloParams p) {
  using C = HaloCfg<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sB = smem;                      // [2][kBRows][BN]
  unsigned char* sHalo = smem + 2 * C::kBBytes;  // [2][kMaxHalo][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;

  // the tile
  const int per_n = p.ry * p.cx;
  const int mt = blockIdx.x;
  const int n0 = (mt / per_n) * p.S;
  const int y0 = ((mt % per_n) / p.cx) * p.R;
  const int x0 = (mt % p.cx) * p.Wt;
  const int co0 = blockIdx.y * BN;
  const int hw_w = p.Wt + 2, hw_hw = (p.R + 2) * hw_w;
  const int tile_px = p.S * p.R * p.Wt;
  const int c_begin = blockIdx.z * p.cps;
  const int c_end = min(p.nchunks, c_begin + p.cps);

  // this lane's A rows: the halo pixel under tap (1, 1) of each m16 tile
  int a_pos[C::MI];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const int slot = wm * C::WM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int pos = hw_w + 1;  // a slot past the tile reads pixel 0; not written
    if (slot < tile_px) {
      const int s = slot / (p.R * p.Wt), rem = slot - s * p.R * p.Wt;
      const int r = rem / p.Wt, c = rem - r * p.Wt;
      pos = s * hw_hw + (r + 1) * hw_w + c + 1;
    }
    a_pos[mi] = pos;
  }

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // both halo buffers start zero: pixels outside the image are never
  // written again
  for (int i = tid; i < 2 * kHaloBytes / 16; i += kHThreads)
    reinterpret_cast<uint4*>(sHalo)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto stage_b = [&](int chunk, int buf) {
    unsigned char* dst = sB + buf * C::kBBytes;
    const __nv_bfloat16* src = p.w + (long long)chunk * kChunk * p.Np + co0;
    for (int v = tid; v < kBRows * C::CPR; v += kHThreads) {
      const int row = v / C::CPR, ch = v % C::CPR;
      const int tap = row / kChunk, kk = row % kChunk;
      cp_async<16>(smem_addr(dst + row * (BN * 2) +
                             (b_swz<C::CPR>(row, ch) << 4)),
                   src + ((long long)tap * p.Kc + kk) * p.Np + ch * 8, 16);
    }
    cp_async_commit();
  };

  // the vector path's span: image rows y0 - 1 .. y0 + R of each sample,
  // contiguous in NCHW
  const long long e_lo = max(0LL, (long long)(y0 - 1) * p.W);
  const long long e_hi = min(p.HW, (long long)(y0 + p.R + 1) * p.W);
  const int nv = (int)((e_hi - e_lo) >> 3);

  uint4 raw[kMaxItems][2];
  float st[kMaxItems][6];

  auto load_raw = [&](int chunk) {
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int idx = tid + i * kHThreads;
      const int cp = idx & 15, j = (idx >> 4) % p.nvmax,
                s = (idx >> 4) / p.nvmax;
      const int c = chunk * kChunk + 2 * cp;
      raw[i][0] = raw[i][1] = make_uint4(0, 0, 0, 0);
      if (s < p.S && n0 + s < p.N && j < nv) {
        const long long nc = (long long)(n0 + s) * p.Cin + c;
        const __nv_bfloat16* src = p.x + nc * p.HW + e_lo + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c + h < p.Cin) {
            raw[i][h] = __ldg(reinterpret_cast<const uint4*>(src + h * p.HW));
            st[i][3 * h] = p.mean[nc + h];
            st[i][3 * h + 1] = p.scale[nc + h];
            st[i][3 * h + 2] = p.shift[nc + h];
          }
        }
      }
    }
  };

  auto store_halo = [&](int chunk, int buf) {
    unsigned char* dst = sHalo + buf * kHaloBytes;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int idx = tid + i * kHThreads;
      const int cp = idx & 15, j = (idx >> 4) % p.nvmax,
                s = (idx >> 4) / p.nvmax;
      if (!(s < p.S && n0 + s < p.N && j < nv)) continue;
      const int c = chunk * kChunk + 2 * cp;
      const bool in0 = c < p.Cin, in1 = c + 1 < p.Cin;
      const long long e = e_lo + 8 * j;
      int yy = (int)(e / p.W), xx = (int)(e - (long long)yy * p.W);
      int pos = s * hw_hw + (yy - y0 + 1) * hw_w + xx + 1;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float a0 = in0 ? silu_operand((bf16_at(raw[i][0], q) - st[i][0]) *
                                            st[i][1] + st[i][2])
                             : 0.f;
        const float a1 = in1 ? silu_operand((bf16_at(raw[i][1], q) - st[i][3]) *
                                            st[i][4] + st[i][5])
                             : 0.f;
        *reinterpret_cast<uint32_t*>(dst + halo_off(pos, cp >> 2) +
                                     (cp & 3) * 4) = pack_bf16(a0, a1);
        ++pos;
        if (++xx == p.W) {  // next image row: skip the two pad columns
          xx = 0;
          pos += 2;
        }
      }
    }
  };

  // any shape: element loads, synchronous
  auto stage_scalar = [&](int chunk, int buf) {
    unsigned char* dst = sHalo + buf * kHaloBytes;
    for (int idx = tid; idx < 16 * p.S * hw_hw; idx += kHThreads) {
      const int cp = idx & 15, hp = idx >> 4;
      const int s = hp / hw_hw, rem = hp - s * hw_hw;
      const int hr = rem / hw_w, hc = rem - hr * hw_w;
      const int n = n0 + s, yy = y0 - 1 + hr, xx = x0 - 1 + hc;
      if (n >= p.N || yy < 0 || yy >= p.H || xx < 0 || xx >= p.W) continue;
      const int c = chunk * kChunk + 2 * cp;
      float a[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c + h < p.Cin) {
          const long long nc = (long long)n * p.Cin + c + h;
          const float v = __bfloat162float(p.x[nc * p.HW + (long long)yy * p.W + xx]);
          a[h] = silu_operand((v - p.mean[nc]) * p.scale[nc] + p.shift[nc]);
        }
      }
      *reinterpret_cast<uint32_t*>(dst + halo_off(hp, cp >> 2) +
                                   (cp & 3) * 4) = pack_bf16(a[0], a[1]);
    }
  };

  // ldmatrix lane roles: A rows (lane & 15) of the m16 tile at chunk
  // (lane >> 4); B.trans rows k = (lane & 15) at chunk (lane >> 4)
  const int a_chunk = lane >> 4;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_ch0 = wn * C::WN / 8 + (lane >> 4);

  auto compute = [&](int buf) {
    const uint32_t hb = smem_addr(sHalo + buf * kHaloBytes);
    const uint32_t bb = smem_addr(sB + buf * C::kBBytes);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3 - 1) * hw_w + (tap % 3 - 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[C::MI][4], b[C::NI][2];
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
          ldmatrix_x4(a[mi], hb + halo_off(a_pos[mi] + shift, ks * 2 + a_chunk));
#pragma unroll
        for (int j = 0; j < C::NI / 2; ++j) {
          const int row = tap * kChunk + ks * 16 + b_k;
          uint32_t r[4];
          ldmatrix_x4_trans(r, bb + row * (BN * 2) +
                                   (b_swz<C::CPR>(row, b_ch0 + 2 * j) << 4));
          b[2 * j][0] = r[0];
          b[2 * j][1] = r[1];
          b[2 * j + 1][0] = r[2];
          b[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
  };

  stage_b(c_begin, 0);
  if (p.vec) {
    load_raw(c_begin);
    store_halo(c_begin, 0);
  } else {
    stage_scalar(c_begin, 0);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const bool more = c + 1 < c_end;
    if (more) {
      stage_b(c + 1, buf ^ 1);
      if (p.vec) load_raw(c + 1);  // in flight during the products
    }
    compute(buf);
    if (more) {
      if (p.vec) {
        store_halo(c + 1, buf ^ 1);
      } else {
        stage_scalar(c + 1, buf ^ 1);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: straight from the accumulators to NCHW (or the workspace)
  const long long plane = (long long)p.N * p.Cout * p.HW;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int slot = wm * C::WM + mi * 16 + (lane >> 2) + half * 8;
      if (slot >= tile_px) continue;
      const int s = slot / (p.R * p.Wt), rem = slot - s * p.R * p.Wt;
      const int r = rem / p.Wt, cc = rem - r * p.Wt;
      const int n = n0 + s, yy = y0 + r, xx = x0 + cc;
      if (n >= p.N || yy >= p.H || xx >= p.W) continue;
      const long long base = (long long)n * p.Cout * p.HW + (long long)yy * p.W + xx;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn * C::WN + ni * 8 + (lane & 3) * 2 + e;
          if (co >= p.Cout) continue;
          const float v = acc[mi][ni][half * 2 + e];
          const long long o = base + (long long)co * p.HW;
          if (p.ws) {
            p.ws[blockIdx.z * plane + o] = v;
          } else {
            p.y[o] = __float2bfloat16(
                p.bias ? v + param_at(p.bias, co, p.bias_bf16) : v);
          }
        }
      }
    }
  }
}

// y = the split partials summed in split order, plus the bias
__global__ void __launch_bounds__(256)
gn_silu_conv_splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                                  long long total, long long HW, int Cout,
                                  const void* bias, int bias_bf16,
                                  __nv_bfloat16* __restrict__ y) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * total + i];
    if (bias) v += param_at(bias, (int)((i / HW) % Cout), bias_bf16);
    y[i] = __float2bfloat16(v);
  }
}

struct HaloPlan {
  int bn, S, R, Wt, ry, cx, nvmax, vec, mtiles, ntiles, splits, cps, nchunks;
};

inline int halo_bn(int cout) {
  return cout <= 16 ? 16 : (cout % 128 == 0 ? 128 : 64);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

HaloPlan halo_plan(long long N, int Cin, int H, int W, int Cout, int Kc,
                   int x_aligned) {
  HaloPlan t;
  t.bn = halo_bn(Cout);
  const int slots = slots_for(t.bn);
  const int HW = H * W;
  if (HW <= slots / 2) {  // whole samples
    t.R = H;
    t.Wt = W;
    t.S = std::min(slots / HW, kMaxHalo / ((H + 2) * (W + 2)));
  } else {
    t.S = 1;
    t.Wt = std::min(W, kSlots);
    t.R = std::min(H, std::max(1, slots / t.Wt));
    // the halo fits its buffer, its rows the staging registers
    while (t.R > 1 && ((t.R + 2) * (t.Wt + 2) > kMaxHalo ||
                       2 * (t.R + 2) * t.Wt > kMaxItems * kHThreads))
      --t.R;
  }
  t.ry = (H + t.R - 1) / t.R;
  t.cx = (W + t.Wt - 1) / t.Wt;
  t.vec = x_aligned && HW % 8 == 0 && t.Wt == W && (W % 8 == 0 || t.R == H);
  t.nvmax = std::min((t.R + 2) * W, HW) / 8;
  if (t.vec && t.S * t.nvmax * 16 > kMaxItems * kHThreads) t.vec = 0;
  t.mtiles = (int)((N + t.S - 1) / t.S) * t.ry * t.cx;
  t.ntiles = (Cout + t.bn - 1) / t.bn;
  t.nchunks = Kc / kChunk;
  // split the chunks where the tiles fill fewer than two waves, keeping
  // at least 4 chunks a split
  const int per_sm = t.bn == 128 ? HaloCfg<128>::kPerSM
                     : t.bn == 64 ? HaloCfg<64>::kPerSM
                                  : HaloCfg<16>::kPerSM;
  const long long tiles = (long long)t.mtiles * t.ntiles;
  const long long want = 2LL * sm_count() * per_sm;
  int splits = 1;
  if (tiles < want)
    splits = (int)std::min((want + tiles - 1) / tiles,
                      (long long)std::max(1, t.nchunks / 4));
  t.cps = (t.nchunks + splits - 1) / splits;
  t.splits = (t.nchunks + t.cps - 1) / t.cps;
  return t;
}

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

template <int BN>
cudaError_t launch_halo(const HaloParams& p, const HaloPlan& t,
                        cudaStream_t stream) {
  using C = HaloCfg<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_conv_halo_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)t.mtiles, (unsigned)t.ntiles, (unsigned)t.splits);
  gn_silu_conv_halo_kernel<BN><<<grid, kHThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the TF32 WMMA implicit GEMM (the first design)

constexpr int kTfBM = 128, kTfBN = 64;
constexpr int kTfThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kLdC = kTfBM + 4;  // epilogue tile [BN][kLdC] f32
constexpr int kTfK = 8;
constexpr int kLdA = kTfBM + 4;  // 16 bytes of row padding
constexpr int kLdB = kTfBN + 4;
constexpr int kBOff = (kChunk * kLdA * 4 + 127) / 128 * 128;
constexpr int kTfTile = kBOff + kChunk * kLdB * 4;
constexpr int kTfOut = kTfBN * kLdC * 4;
constexpr int kTfSmem = kTfTile > kTfOut ? kTfTile : kTfOut;

using TfA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                          wmma::col_major>;
using TfB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                          wmma::row_major>;
using TfAcc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

struct ConvParams {
  const void* x;      // [N, Cin, H, W]
  const void* w;      // packed [9, Kc, Np]
  const void* bias;   // [Cout] or null
  void* y;            // [N, Cout, H, W]
  const float* mean;  // [N, Cin] each
  const float* scale;
  const float* shift;
  long long M, HW;
  int Cin, H, W, Cout, Kc, Np;
  int bias_bf16;
};

__global__ void __launch_bounds__(kTfThreads, 2)
gn_silu_conv_tf32_kernel(ConvParams p) {
  constexpr int kAPer = kTfBM * kChunk / kTfThreads;  // A elements a thread
  constexpr int kVec = 4;                             // floats in 16 bytes
  constexpr int kRowVecs = kTfBN / kVec;
  constexpr int kBPer = kChunk * kRowVecs / kTfThreads;  // B vectors a thread
  __shared__ __align__(128) unsigned char smem[kTfSmem];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + kBOff);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long m0 = (long long)blockIdx.x * kTfBM;
  const int n0 = blockIdx.y * kTfBN;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  // the A gather: this thread's output pixel (row am of the tile) and its
  // depth rows ak0, ak0 + 2, ...; a warp covers 32 neighbouring pixels
  const int am = tid % kTfBM, ak0 = tid / kTfBM;
  const long long gm = m0 + am;
  const bool mvalid = gm < p.M;
  long long n = 0;
  int oy = 0, ox = 0;
  if (mvalid) {
    n = gm / p.HW;
    const long long r = gm % p.HW;
    oy = (int)(r / p.W);
    ox = (int)(r % p.W);
  }
  const float* xn = x + n * p.Cin * p.HW;
  const float* mean_n = p.mean + n * p.Cin;
  const float* scale_n = p.scale + n * p.Cin;
  const float* shift_n = p.shift + n * p.Cin;

  const int kc_tiles = p.Kc / kChunk;
  const int n_k = 9 * kc_tiles;

  float areg[kAPer];
  unsigned amask = 0;
  uint4 breg[kBPer];

  auto load_tile = [&](int kt) {
    const int tap = kt / kc_tiles, ci0 = (kt % kc_tiles) * kChunk;
    const int iy = oy + tap / 3 - 1, ix = ox + tap % 3 - 1;
    const bool inside = mvalid && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    amask = 0;
    if (inside) {
      const float* src = xn + (long long)iy * p.W + ix;
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int ci = ci0 + ak0 + 2 * j;
        areg[j] = 0.f;
        if (ci < p.Cin) {
          areg[j] = src[(long long)ci * p.HW];
          amask |= 1u << j;
        }
      }
    }
    const float* wsrc = w + ((long long)tap * p.Kc + ci0) * p.Np + n0;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kTfThreads;
      breg[i] = *reinterpret_cast<const uint4*>(
          wsrc + (long long)(v / kRowVecs) * p.Np + (v % kRowVecs) * kVec);
    }
  };

  auto store_tile = [&](int kt) {
    const int ci0 = (kt % kc_tiles) * kChunk;
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int kk = ak0 + 2 * j, ci = ci0 + kk;
      float v = 0.f;  // zero padding of the ACTIVATED tensor
      if ((amask >> j) & 1u)
        v = silu_operand((areg[j] - mean_n[ci]) * scale_n[ci] + shift_n[ci]);
      As[kk * kLdA + am] = wmma::__float_to_tf32(v);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kTfThreads;
      float* f = reinterpret_cast<float*>(&breg[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = wmma::__float_to_tf32(f[e]);
      *reinterpret_cast<uint4*>(Bs + (v / kRowVecs) * kLdB +
                                (v % kRowVecs) * kVec) = breg[i];
    }
  };

  TfAcc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;

  load_tile(0);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();  // the previous tile's products are done with smem
    store_tile(kt);
    __syncthreads();
    if (kt + 1 < n_k) load_tile(kt + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += kTfK) {
      TfA a[2];
      TfB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * kLdA + wm + 16 * i, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: the tile through shared memory as [BN][BM], so that
  // neighbouring threads write neighbouring pixels of one output channel
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wn + 16 * j) * kLdC + wm + 16 * i,
                              acc[i][j], kLdC, wmma::mem_col_major);
  __syncthreads();
  float* y = static_cast<float*>(p.y);
  for (int idx = tid; idx < kTfBM * kTfBN; idx += kTfThreads) {
    const int nl = idx / kTfBM, ml = idx % kTfBM;
    const long long g = m0 + ml;
    const int co = n0 + nl;
    if (g < p.M && co < p.Cout) {
      float v = Cs[nl * kLdC + ml];
      if (p.bias) v += param_at(p.bias, co, p.bias_bf16);
      const long long nn = g / p.HW, r = g % p.HW;
      y[(nn * p.Cout + co) * p.HW + r] = v;
    }
  }
}

// the N tile the packed weights are padded to, per type
inline int tile_bn(int cout, int dtype) {
  return dtype == 1 ? halo_bn(cout) : kTfBN;
}

long long workspace_bytes(long long N, int Cin, int H, int W, int Cout,
                          int dtype) {
  if (dtype != 1) return 0;
  const int kc = (Cin + kChunk - 1) / kChunk * kChunk;
  const HaloPlan t = halo_plan(N, Cin, H, W, Cout, kc, 1);
  return t.splits > 1 ? (long long)t.splits * N * Cout * H * W * 4 : 0;
}

}  // namespace

extern "C" {

// x: contiguous [N, Cin, H, W]; gn_gamma, gn_beta: [Cin] (f32, or bf16 when
// gn_param_bf16); w: the packed weights [9, Kc, Np] in x's type, 16-byte
// aligned, Kc a multiple of 32 and >= Cin, Np a multiple of the N tile
// (gn_silu_conv_tiles) and >= Cout, zero outside [Cin, Cout]; bias: [Cout]
// (f32, or bf16 when bias_bf16) or null; y: contiguous [N, Cout, H, W];
// scratch: gn_silu_conv_scratch_bytes bytes, 256-byte aligned. dtype: 0 =
// float32 (TF32 products), 1 = bfloat16. Returns a cudaError_t (0 on
// success).
int gn_silu_conv(const void* x, const void* gn_gamma, const void* gn_beta,
                 const void* w, const void* bias, void* y, void* scratch,
                 long long N, int Cin, int H, int W, int Cout, int G,
                 float eps, int Kc, int Np, int dtype, int gn_param_bf16,
                 int bias_bf16, void* stream) {
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || G <= 0 ||
      Cin % G != 0 || Kc < Cin || Kc % kChunk != 0 || Np < Cout ||
      (dtype != 0 && dtype != 1) || Np % tile_bn(Cout, dtype) != 0)
    return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const long long L = Cin / G * HW;
  if (N * G * (long long)stat_chunks(L) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *mean, *scale, *shift;
  cudaError_t err =
      dtype == 1
          ? launch_stats<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                        N, Cin, HW, G, eps, gn_gamma, gn_beta,
                                        gn_param_bf16, scratch, &mean, &scale,
                                        &shift, s)
          : launch_stats<float>(static_cast<const float*>(x), N, Cin, HW, G,
                                eps, gn_gamma, gn_beta, gn_param_bf16, scratch,
                                &mean, &scale, &shift, s);
  if (err != cudaSuccess) return (int)err;

  if (dtype == 0) {
    ConvParams p;
    p.x = x;
    p.w = w;
    p.bias = bias;
    p.y = y;
    p.mean = mean;
    p.scale = scale;
    p.shift = shift;
    p.HW = HW;
    p.M = N * HW;
    p.Cin = Cin;
    p.H = H;
    p.W = W;
    p.Cout = Cout;
    p.Kc = Kc;
    p.Np = Np;
    p.bias_bf16 = bias_bf16;
    if ((p.M + kTfBM - 1) / kTfBM > 0x7fffffffLL || Np / kTfBN > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)((p.M + kTfBM - 1) / kTfBM),
                    (unsigned)(Np / kTfBN));
    gn_silu_conv_tf32_kernel<<<grid, kTfThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }

  const HaloPlan t = halo_plan(N, Cin, H, W, Cout, Kc,
                               reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (t.ntiles > 65535 || t.splits > 65535)
    return (int)cudaErrorInvalidConfiguration;
  HaloParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = bias;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = t.splits > 1
             ? reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                        align256(stat_scratch_bytes(N, Cin, HW, G)))
             : nullptr;
  p.mean = mean;
  p.scale = scale;
  p.shift = shift;
  p.HW = HW;
  p.N = (int)N;
  p.Cin = Cin;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.Kc = Kc;
  p.Np = Np;
  p.bias_bf16 = bias_bf16;
  p.S = t.S;
  p.R = t.R;
  p.Wt = t.Wt;
  p.ry = t.ry;
  p.cx = t.cx;
  p.nvmax = t.nvmax;
  p.vec = t.vec;
  p.nchunks = t.nchunks;
  p.cps = t.cps;
  err = t.bn == 128 ? launch_halo<128>(p, t, s)
        : t.bn == 64 ? launch_halo<64>(p, t, s)
                     : launch_halo<16>(p, t, s);
  if (err != cudaSuccess || t.splits == 1) return (int)err;
  const long long total = N * Cout * HW;
  const long long blocks = std::min((total + 255) / 256, 132LL * 16);
  gn_silu_conv_splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      p.ws, t.splits, total, HW, Cout, bias, bias_bf16, p.y);
  return (int)cudaGetLastError();
}

// The tiles the packed weights are padded to for Cout output channels in
// `dtype`: the pixels a block owns, the N tile (Np is a multiple of it)
// and the K chunk (Kc is a multiple of it).
void gn_silu_conv_tiles(int cout, int dtype, int* bm, int* bn, int* bk) {
  *bm = dtype == 1 ? slots_for(halo_bn(cout)) : kTfBM;
  *bn = tile_bn(cout, dtype);
  *bk = kChunk;
}

// Launch plan of a bf16 call (for the record and the tests): the tile
// (samples, rows, columns), the grid (pixel tiles, Cout tiles, splits) and
// whether halo rows move in 16-byte loads.
void gn_silu_conv_plan(long long N, int Cin, int H, int W, int Cout,
                       int* out) {
  const int kc = (Cin + kChunk - 1) / kChunk * kChunk;
  const HaloPlan t = halo_plan(N, Cin, H, W, Cout, kc, 1);
  const int v[8] = {t.S, t.R, t.Wt, t.mtiles, t.ntiles, t.splits, t.bn, t.vec};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

long long gn_silu_conv_scratch_bytes(long long N, int Cin, int H, int W,
                                     int Cout, int G, int dtype) {
  return align256(stat_scratch_bytes(N, Cin, (long long)H * W, G)) +
         workspace_bytes(N, Cin, H, W, Cout, dtype);
}

const char* gn_silu_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
