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
// over. Its tiling (whole sample in VMEM, row tiles, Cout tiles of 128) and
// its shape gates (C % 128, HW >= 1024, an 8 MB sample, fused_conv.py:
// 215-231) are TPU limits and do not: every shape launches here.
//
// Two steps on the port's layout, x [N, Cin, H, W] (never transposed):
//   1. the GroupNorm statistics of gn_common.cuh (two launches): per-(n, c)
//      mean, scale = rstd * gamma, shift = beta, from the centred two-pass
//      moments; the JAX wrapper's single-pass E[x^2] - mean^2
//      (fused_conv.py:72) is not copied;
//   2. gn_silu_conv_kernel, an implicit GEMM: M = N * H * W output pixels,
//      flattened across samples so that the 4x4 and 8x8 levels at 32 samples
//      still fill whole tiles; N = Cout, padded to the tile (the UNet head has
//      Cout = 4); K = 9 taps x Cin. Each BM x BK tile of A is gathered from
//      x with its halo, put through the affine and SiLU in f32 and rounded to
//      the operand type (bf16, or TF32 for f32 input) in shared memory. A tap
//      outside the image is zero AFTER the activation (the conv pads the
//      activated tensor; SiLU(shift) would be wrong there). B comes from the
//      weights packed once to [9, Kc, Np] (tap, Cin padded to BK, Cout padded
//      to BN; the wrapper caches the packed copy per parameter). WMMA
//      products, f32 accumulation, the conv bias added in the f32 epilogue,
//      the output written in NCHW through shared memory.
//
// What bounds it on an H100: 2 * M * Cout * 9 * Cin operations at 989
// TFLOP/s (bf16), against x read once, W read and y written at 3.35 TB/s;
// the ResBlock convs are operation-bound. This first kernel is simple: one
// tile in flight (the next tile's loads are issued before the current
// tile's products), and the activation is recomputed for every tap and
// every Cout tile.

#include <mma.h>

#define GN_STATS_NAME(kernel) gn_conv_stats_##kernel
#include "gn_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kConvThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kLdC = BM + 4;       // epilogue tile [BN][kLdC] f32

template <typename T>
struct Frag;

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int K = 16;
  static constexpr int kSkew = 8;  // 16 bytes of row padding
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major>;
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __device__ static __nv_bfloat16 operand(float v) {
    return __float2bfloat16(v);
  }
  __device__ static void round_operands(uint4&) {}
};

template <>
struct Frag<float> {
  static constexpr int K = 8;
  static constexpr int kSkew = 4;
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                           wmma::col_major>;
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                           wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  __device__ static float operand(float v) { return wmma::__float_to_tf32(v); }
  __device__ static void round_operands(uint4& v) {
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = wmma::__float_to_tf32(f[i]);
  }
};

// Shared memory: the A tile (k-major, i.e. column-major A: [BK][kLdA]) and
// the B tile ([BK][kLdB]) during the K loop, then the f32 output tile.
template <typename T>
struct Smem {
  static constexpr int kLdA = BM + Frag<T>::kSkew;
  static constexpr int kLdB = BN + Frag<T>::kSkew;
  static constexpr int kBOff = (BK * kLdA * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int kTile = kBOff + BK * kLdB * (int)sizeof(T);
  static constexpr int kOut = BN * kLdC * (int)sizeof(float);
  static constexpr int kBytes = kTile > kOut ? kTile : kOut;
};

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

// The activation on the conv's operand path: exp on the fast unit (a few
// ulp of f32, far below the bf16 or TF32 rounding that follows).
__device__ __forceinline__ float silu_operand(float v) {
  return v / (1.f + __expf(-v));
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads, 2)
gn_silu_conv_kernel(ConvParams p) {
  using Fr = Frag<T>;
  using S = Smem<T>;
  constexpr int kAPer = BM * BK / kConvThreads;  // A elements a thread
  constexpr int kVec = 16 / (int)sizeof(T);      // elements in 16 bytes
  constexpr int kRowVecs = BN / kVec;
  constexpr int kBPer = BK * kRowVecs / kConvThreads;  // B vectors a thread
  __shared__ __align__(128) unsigned char smem[S::kBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + S::kBOff);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  // the A gather: this thread's output pixel (row am of the tile) and its
  // depth rows ak0, ak0 + 2, ...; a warp covers 32 neighbouring pixels
  const int am = tid % BM, ak0 = tid / BM;
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
  const T* xn = x + n * p.Cin * p.HW;
  const float* mean_n = p.mean + n * p.Cin;
  const float* scale_n = p.scale + n * p.Cin;
  const float* shift_n = p.shift + n * p.Cin;

  const int kc_tiles = p.Kc / BK;
  const int n_k = 9 * kc_tiles;

  float areg[kAPer];
  unsigned amask = 0;
  uint4 breg[kBPer];

  auto load_tile = [&](int kt) {
    const int tap = kt / kc_tiles, ci0 = (kt % kc_tiles) * BK;
    const int iy = oy + tap / 3 - 1, ix = ox + tap % 3 - 1;
    const bool inside = mvalid && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    amask = 0;
    if (inside) {
      const T* src = xn + (long long)iy * p.W + ix;
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int ci = ci0 + ak0 + 2 * j;
        areg[j] = 0.f;
        if (ci < p.Cin) {
          areg[j] = to_f(src[(long long)ci * p.HW]);
          amask |= 1u << j;
        }
      }
    }
    const T* wsrc = w + ((long long)tap * p.Kc + ci0) * p.Np + n0;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kConvThreads;
      breg[i] = *reinterpret_cast<const uint4*>(
          wsrc + (long long)(v / kRowVecs) * p.Np + (v % kRowVecs) * kVec);
    }
  };

  auto store_tile = [&](int kt) {
    const int ci0 = (kt % kc_tiles) * BK;
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int kk = ak0 + 2 * j, ci = ci0 + kk;
      float v = 0.f;  // zero padding of the ACTIVATED tensor
      if ((amask >> j) & 1u)
        v = silu_operand((areg[j] - mean_n[ci]) * scale_n[ci] + shift_n[ci]);
      As[kk * S::kLdA + am] = Fr::operand(v);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kConvThreads;
      Fr::round_operands(breg[i]);
      *reinterpret_cast<uint4*>(Bs + (v / kRowVecs) * S::kLdB +
                                (v % kRowVecs) * kVec) = breg[i];
    }
  };

  typename Fr::Acc acc[2][2];
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
    for (int kk = 0; kk < BK; kk += Fr::K) {
      typename Fr::A a[2];
      typename Fr::B b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * S::kLdA + wm + 16 * i, S::kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * S::kLdB + wn + 16 * j, S::kLdB);
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
  T* y = static_cast<T*>(p.y);
  for (int idx = tid; idx < BM * BN; idx += kConvThreads) {
    const int nl = idx / BM, ml = idx % BM;
    const long long g = m0 + ml;
    const int co = n0 + nl;
    if (g < p.M && co < p.Cout) {
      float v = Cs[nl * kLdC + ml];
      if (p.bias) v += param_at(p.bias, co, p.bias_bf16);
      const long long nn = g / p.HW, r = g % p.HW;
      y[(nn * p.Cout + co) * p.HW + r] = from_f<T>(v);
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* gn_gamma, const void* gn_beta,
                int gn_param_bf16, float eps, int G, void* scratch,
                ConvParams p, long long N, cudaStream_t stream) {
  float *mean, *scale, *shift;
  cudaError_t err = launch_stats<T>(static_cast<const T*>(x), N, p.Cin, p.HW,
                                    G, eps, gn_gamma, gn_beta, gn_param_bf16,
                                    scratch, &mean, &scale, &shift, stream);
  if (err != cudaSuccess) return err;
  p.mean = mean;
  p.scale = scale;
  p.shift = shift;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)(p.Np / BN));
  gn_silu_conv_kernel<T><<<grid, kConvThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous [N, Cin, H, W]; gn_gamma, gn_beta: [Cin] (f32, or bf16 when
// gn_param_bf16); w: the packed weights [9, Kc, Np] in x's type, 16-byte
// aligned, Kc a multiple of BK and >= Cin, Np a multiple of BN and >= Cout,
// zero outside [Cin, Cout]; bias: [Cout] (f32, or bf16 when bias_bf16) or
// null; y: contiguous [N, Cout, H, W]; scratch: gn_silu_conv_scratch_bytes
// bytes, 16-byte aligned. dtype: 0 = float32 (TF32 products), 1 = bfloat16.
// Returns a cudaError_t (0 on success).
int gn_silu_conv(const void* x, const void* gn_gamma, const void* gn_beta,
                 const void* w, const void* bias, void* y, void* scratch,
                 long long N, int Cin, int H, int W, int Cout, int G,
                 float eps, int Kc, int Np, int dtype, int gn_param_bf16,
                 int bias_bf16, void* stream) {
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || G <= 0 ||
      Cin % G != 0 || Kc < Cin || Kc % BK != 0 || Np < Cout || Np % BN != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.y = y;
  p.HW = (long long)H * W;
  p.M = N * p.HW;
  p.Cin = Cin;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.Kc = Kc;
  p.Np = Np;
  p.bias_bf16 = bias_bf16;
  const long long L = Cin / G * p.HW;
  if ((p.M + BM - 1) / BM > 0x7fffffffLL || Np / BN > 65535 ||
      N * G * (long long)stat_chunks(L) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? run<__nv_bfloat16>(x, gn_gamma, gn_beta, gn_param_bf16,
                                        eps, G, scratch, p, N, s)
                   : run<float>(x, gn_gamma, gn_beta, gn_param_bf16, eps, G,
                                scratch, p, N, s));
}

// The tile sizes the packed weights are padded to.
void gn_silu_conv_tiles(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

long long gn_silu_conv_scratch_bytes(long long N, long long C, long long HW,
                                     int G) {
  return stat_scratch_bytes(N, C, HW, G);
}

const char* gn_silu_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
