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
// port's layout, never transposed) and each (n, group) is one contiguous
// slab of L = C / G * HW elements. The TPU's VMEM cap (fused_norm.py:
// 167-171) has no counterpart: every shape launches, the 768x768 VAE decode
// at [1, 256, 768, 768] included.
//
// What bounds it on an H100: a few operations per element, so bytes: x read
// once and y written once, 2 * 2 bytes an element in bf16 (604 MB, 0.18 ms
// at 3.35 TB/s, for the 768x768 decode's input). The first design made
// three launches a call (chunk statistics, finalize, apply) and read x
// twice, so it sat at 2.1-2.3x the byte bound on large maps and on a floor
// of launches and a scratch allocation on small ones.
//
// Design. One thread-block cluster per slab wherever the slab fits the
// cluster's shared memory (up to 16 blocks of up to ~226 KB, or 8 where the
// card cannot co-schedule 16):
//   1. each block copies its contiguous share of the slab into shared memory
//      once, with 1-D bulk copies (TMA) completing on an mbarrier (element
//      loads where rows are not whole 16-byte units);
//   2. it takes the share's count, mean and centred M2 in two passes over
//      shared memory, in f32, the mean corrected by the centred sum
//      (Bjorck's form, as gn_common.cuh's chunks);
//   3. after a cluster barrier, every block reads all the blocks' moments
//      through distributed shared memory and merges them with Chan's
//      combine in rank order, in f64: the same bits in every block and on
//      every run, with no atomics and no scratch;
//   4. it applies silu((x - mean) * rstd * gamma + beta) from shared memory,
//      the mean subtracted as a hi + lo pair of floats so that a large mean
//      leaves no rounding of its own, and writes y with 16-byte stores.
// One launch, one read of x. Shares are sized so that two blocks fit an SM
// where a cluster of 8 allows it (512 threads; 1024 for a block alone on
// its SM); a small grid is spread over up to 8 blocks a slab (at least 4 KB
// each) so that it reaches more SMs, and tiny slabs take a cluster of 1.
// The cluster size is compiled into each instance (1-8 and 16), so a call
// is one plain launch.
// Slabs too large for one cluster (the 384^2-768^2 VAE-decode maps) take two
// launches: gn_silu_stats_kernel, in which each slab's cluster reduces its
// blocks' moments through distributed shared memory and writes the slab's
// mean and 1/std (the finalize launch folded in), then gn_silu_apply_kernel.
// That path reads x twice, so its own floor is 1.5x the byte bound.
// What still bounds it (PERF.md): the batch-1 VAE maps have 32 slabs,
// so 16-block clusters run in a few waves in step (load, then moments, then
// apply and store) and reach about 2.5x the byte bound; batched maps with
// two blocks an SM reach about 1.5x.

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <mutex>

#include "gn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;  // a cluster block alone on its SM
constexpr int kStatThreads = 512;  // the two-launch kernels
constexpr int kTwoPerSm = 110 * 1024;  // share bytes when two blocks fit
constexpr int kMinShare = 4096;  // bytes a block at least, when spreading
constexpr uint32_t kChunkBytes = 32768;  // one bulk copy, own mbarrier
constexpr int kMaxChunks = 8;  // 8 x 32 KB hold a block's shared memory
constexpr int kMaxDevices = 64;

template <typename T, int V>
struct Pack;  // V consecutive elements moved as one 16-byte access

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
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
  using Raw = uint4;
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <typename T>
struct Pack<T, 1> {
  using Raw = T;
  __device__ static void unpack(const T& raw, float* out) {
    out[0] = to_f(raw);
  }
  __device__ static void load(const T* p, float* out) { out[0] = to_f(*p); }
  __device__ static void store(T* p, const float* in) {
    *p = from_f<T>(in[0]);
  }
};

// elements a 16-byte access moves, or 1 for element accesses
template <typename T, bool kVec>
__host__ __device__ constexpr int lanes() {
  return kVec ? 16 / (int)sizeof(T) : 1;
}

// SiLU in the output's precision: for bf16 the fast exponential and
// division (their error is far below a bf16 step; the accurate pair made
// the apply ALU-bound), for f32 the accurate ones
template <typename T>
__device__ __forceinline__ float silu_out(float v) {
  if constexpr (sizeof(T) == 2) {
    return __fdividef(v, 1.f + __expf(-v));
  } else {
    return silu(v);
  }
}

// ---- mbarrier, 1-D bulk copy (TMA) and the split cluster barrier ----------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> this block's shared memory, completing on `bar`; 16-byte
// aligned addresses, bytes a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Moments merged in f64: a merge rounds the running mean, and in f32 a
// mean of 100 would lose 4e-6 at each of up to ~40 merges a slab.
struct MomentsD {
  double n, mean, m2;
};

// Chan et al.'s pairwise update of (count, mean, M2); the weight b.n / n
// in f32 (counts below 2^24 are exact there, the quotient within 2^-24)
__device__ __forceinline__ MomentsD combine_d(MomentsD a, MomentsD b) {
  const double n = a.n + b.n;
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double d = b.mean - a.mean, fb = (double)((float)b.n / (float)n);
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

// Block sums of two values at once, the same bits in every thread; `red`
// holds two floats per warp.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    r.x += red[2 * w];
    r.y += red[2 * w + 1];
  }
  return r;
}

// Moments of `n` f32 values from their f32 sums: the first pass's mean m1
// and the centred sums sd = sum (x - m1), q = sum (x - m1)^2 of the second
// (the mean corrected by sd / n, Bjorck's form, kept in f64)
__device__ __forceinline__ MomentsD two_pass(float n, float m1, float sd,
                                             float q) {
  const float corr = sd / n;
  return {(double)n, (double)m1 + (double)corr, (double)fmaxf(q - sd * corr,
                                                              0.f)};
}

// The slab's statistics as the apply uses them: the mean as a pair of
// floats (hi + lo), so that (x - hi) - lo centres x to f32 precision
// whatever the mean's size, and 1/std
struct SlabStat {
  float hi, lo, rstd, unused;
};

__device__ __forceinline__ SlabStat slab_stat(MomentsD m, float eps) {
  const float hi = (float)m.mean;
  // population variance, as the plain version's mean of squares
  return {hi, (float)(m.mean - (double)hi),
          (float)(1.0 / sqrt(m.m2 / m.n + (double)eps)), 0.f};
}

// Warp 0: merge the cluster's blocks' moments (`part` of each rank) in rank
// order, the same bits in every block.
__device__ __forceinline__ SlabStat merge_cluster(cg::cluster_group& cluster,
                                                  MomentsD* part, float eps) {
  const int cs = (int)cluster.num_blocks();
  MomentsD p = {0.0, 0.0, 0.0};
  if ((int)threadIdx.x < cs)
    p = *cluster.map_shared_rank(part, (unsigned)threadIdx.x);
  MomentsD acc = {0.0, 0.0, 0.0};
  for (int r = 0; r < cs; ++r)
    acc = combine_d(acc, {__shfl_sync(0xffffffffu, p.n, r),
                          __shfl_sync(0xffffffffu, p.mean, r),
                          __shfl_sync(0xffffffffu, p.m2, r)});
  return slab_stat(acc, eps);
}

// y = silu((x - mean) * rstd * gamma[ch] + beta[ch]) of V elements of
// channel ch
template <typename T, int V>
__device__ __forceinline__ void apply(const SlabStat& st, const void* gamma,
                                      const void* beta, int param_bf16,
                                      int ch, float* v) {
  const float a = st.rstd * param_at(gamma, ch, param_bf16);
  const float b = param_at(beta, ch, param_bf16);
#pragma unroll
  for (int t = 0; t < V; ++t)
    v[t] = silu_out<T>(((v[t] - st.hi) - st.lo) * a + b);
}

// One cluster of CS blocks a slab, `share` elements a block (a multiple of
// the lanes; the last blocks may hold fewer, or none): load once, two-pass
// moments, cluster merge, apply. The cluster size is compiled in, so a
// launch is a plain <<<>>> (a launch that sets it at run time cost the host
// far more a call).
template <typename T, bool kVec, int CS>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(kMaxThreads)
gn_silu_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const void* gamma, const void* beta, int param_bf16,
                       int C, int G, int HW, int L, int share, float eps) {
  constexpr int V = lanes<T, kVec>();
  constexpr int CHUNK = kChunkBytes / sizeof(T);  // elements a bulk copy
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2 * kMaxThreads / 32];
  __shared__ MomentsD part;  // this block's moments, read cluster-wide
  __shared__ SlabStat stat;
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  T* xs = reinterpret_cast<T*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long slab = blockIdx.x / CS;
  const int start = rank * share;
  const int cnt = max(0, min(share, L - start));
  const int nt = blockDim.x;
  const T* xg = x + slab * L + start;
  T* yg = y + slab * L + start;

  // 1. the share into shared memory, once: one bulk copy of 32 KB on each
  // mbarrier, so that the first pass starts on a chunk as soon as it lands
  // (element loads, summed on the way, where rows are not 16-byte units)
  float s = 0.f;
  if constexpr (kVec) {
    const uint32_t bytes = (uint32_t)cnt * sizeof(T);
    const int chunks = (int)((bytes + kChunkBytes - 1) / kChunkBytes);
    if (threadIdx.x == 0) {
      for (int c = 0; c < chunks; ++c) mbar_init(&bars[c], 1);
      fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < chunks; ++c) {
        const uint32_t off = c * kChunkBytes;
        const uint32_t n = min(kChunkBytes, bytes - off);
        mbar_expect_tx(&bars[c], n);
        bulk_load(smem + off, reinterpret_cast<const unsigned char*>(xg) + off,
                  n, &bars[c]);
      }
    }
    // 2a. the first pass, chunk by chunk
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&bars[c], 0);
      const int end = min(cnt, (c + 1) * CHUNK);
      for (int i = c * CHUNK + threadIdx.x * V; i < end; i += nt * V) {
        float v[V];
        Pack<T, V>::load(xs + i, v);
#pragma unroll
        for (int t = 0; t < V; ++t) s += v[t];
      }
    }
  } else {
    for (int e = threadIdx.x; e < cnt; e += nt) {
      const T v = xg[e];
      xs[e] = v;
      s += to_f(v);
    }
  }

  // 2b. the share's moments: the mean, then the centred sums, which also
  // correct the mean
  const float m1 = cnt ? block_sum(s, red) / (float)cnt : 0.f;
  float sd = 0.f, q = 0.f;
  for (int i = threadIdx.x * V; i < cnt; i += nt * V) {
    float v[V];
    Pack<T, V>::load(xs + i, v);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float d = v[t] - m1;
      sd += d;
      q = fmaf(d, d, q);
    }
  }
  const float2 sums = block_sum2(sd, q, red);
  if (threadIdx.x == 0)
    part = cnt ? two_pass((float)cnt, m1, sums.x, sums.y)
               : MomentsD{0.0, 0.0, 0.0};

  // 3. every block merges the cluster's moments in rank order
  cluster.sync();
  if (threadIdx.x < 32) {
    const SlabStat st = merge_cluster(cluster, &part, eps);
    if (threadIdx.x == 0) stat = st;
  }
  cluster_arrive();  // this block has read the others' moments
  __syncthreads();
  const SlabStat st = stat;

  // 4. the affine and SiLU from shared memory, 16-byte stores
  const int c0 = (int)(slab % G) * (C / G);
  for (int i = threadIdx.x * V; i < cnt; i += nt * V) {
    float v[V];
    Pack<T, V>::load(xs + i, v);
    apply<T, V>(st, gamma, beta, param_bf16, c0 + (start + i) / HW, v);
    Pack<T, V>::store(yg + i, v);
  }
  cluster_wait();  // no block leaves while another may read its moments
}

// 16-byte vectors (or elements) a thread takes per step in the two-launch
// kernels
template <bool kVec>
__host__ __device__ constexpr int steps() {
  return kVec ? 4 : 8;
}

// Two-launch path, first launch: one cluster a slab, `share` elements a
// block, read through registers, the next step's loads in flight while a
// step is summed. A thread takes moments of its values of each step in two
// passes and merges them into its running moments with Chan's combine; the
// block merges its threads' in a fixed tree, the cluster its blocks' in
// rank order, and rank 0 writes the slab's statistics.
template <typename T, bool kVec, int CS>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(kStatThreads)
gn_silu_stats_kernel(const T* __restrict__ x, int L, int share, float eps,
                     SlabStat* __restrict__ stats) {
  constexpr int V = lanes<T, kVec>(), U = steps<kVec>();
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  __shared__ MomentsD sm[kStatThreads];
  __shared__ MomentsD part;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long slab = blockIdx.x / CS;
  const int start = rank * share;
  const int nvec = max(0, min(share, L - start)) / V;  // whole vectors
  const Raw* xr = reinterpret_cast<const Raw*>(x + slab * L + start);
  constexpr int STEP = kStatThreads * U;  // vectors a step

  Raw cur[U], next[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = u * kStatThreads + threadIdx.x;
    if (i < nvec) cur[u] = xr[i];
  }
  MomentsD acc = {0.0, 0.0, 0.0};
  for (int base = 0; base < nvec; base += STEP) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + STEP + u * kStatThreads + threadIdx.x;
      if (i < nvec) next[u] = xr[i];
    }
    float v[U * V];
    int n = 0;
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * kStatThreads + (int)threadIdx.x < nvec) {
        P::unpack(cur[u], v + u * V);
        n += V;
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) v[u * V + t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < V; ++t) s += v[u * V + t];
    }
    if (n > 0) {
      const float m1 = s / (float)n;
      float sd = 0.f, q = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u * kStatThreads + (int)threadIdx.x < nvec) {
#pragma unroll
          for (int t = 0; t < V; ++t) {
            const float d = v[u * V + t] - m1;
            sd += d;
            q = fmaf(d, d, q);
          }
        }
      }
      acc = combine_d(acc, two_pass((float)n, m1, sd, q));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
  }
  sm[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kStatThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w)
      sm[threadIdx.x] = combine_d(sm[threadIdx.x], sm[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) part = sm[0];
  cluster.sync();
  if (rank == 0 && threadIdx.x < 32) {
    const SlabStat st = merge_cluster(cluster, &part, eps);
    if (threadIdx.x == 0) stats[slab] = st;
  }
  cluster.sync();  // no block leaves while rank 0 may read its moments
}

// Two-launch path, second launch: `blocks` blocks a slab, each
// kStatThreads * V * U consecutive elements.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStatThreads)
gn_silu_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const SlabStat* __restrict__ stats, const void* gamma,
                     const void* beta, int param_bf16, int C, int G, int HW,
                     int L, int blocks) {
  constexpr int V = lanes<T, kVec>(), U = steps<kVec>();
  const long long slab = blockIdx.x / blocks;
  const int base = (int)(blockIdx.x % blocks) * kStatThreads * V * U;
  const SlabStat st = stats[slab];
  const int c0 = (int)(slab % G) * (C / G);
  const T* xg = x + slab * L;
  T* yg = y + slab * L;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = base + (u * kStatThreads + threadIdx.x) * V;
    if (e < L) {
      float v[V];
      Pack<T, V>::load(xg + e, v);
      apply<T, V>(st, gamma, beta, param_bf16, c0 + e / HW, v);
      Pack<T, V>::store(yg + e, v);
    }
  }
}

// ---- host side ------------------------------------------------------------

struct DeviceInfo {
  int sms;
  int share_bytes;  // dynamic shared memory a block may take
  int max_cluster;  // 16 where the card co-schedules it at that size, else 8
};

DeviceInfo g_info[kMaxDevices];
std::atomic<bool> g_ready[kMaxDevices];
std::mutex g_mutex;

// the cluster sizes the kernels are compiled for
template <typename T, bool kVec, int CS>
cudaError_t set_cluster_attributes(int share_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_cluster_kernel<T, kVec, CS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, share_bytes);
  if (err == cudaSuccess && CS > 8)
    err = cudaFuncSetAttribute(gn_silu_cluster_kernel<T, kVec, CS>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <typename T, bool kVec>
cudaError_t set_attributes(int share_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_stats_kernel<T, kVec, 16>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 1>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 2>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 3>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 4>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 5>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 6>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 7>(share_bytes);
  if (err == cudaSuccess) err = set_cluster_attributes<T, kVec, 8>(share_bytes);
  if (err == cudaSuccess)
    err = set_cluster_attributes<T, kVec, 16>(share_bytes);
  return err;
}

// The current device's limits, and every instance's attributes set, once
// per device.
cudaError_t device_info(DeviceInfo* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!g_ready[dev].load(std::memory_order_relaxed)) {
      DeviceInfo info;
      int optin = 0;
      err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return err;
      // room for the kernel's own static shared memory
      info.share_bytes = (optin - 1024) / 16 * 16;
      if ((err = set_attributes<__nv_bfloat16, true>(info.share_bytes)) ||
          (err = set_attributes<__nv_bfloat16, false>(info.share_bytes)) ||
          (err = set_attributes<float, true>(info.share_bytes)) ||
          (err = set_attributes<float, false>(info.share_bytes)))
        return err;
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = 16;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(16);
      cfg.blockDim = dim3(kMaxThreads);
      cfg.dynamicSmemBytes = info.share_bytes;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, gn_silu_cluster_kernel<__nv_bfloat16, true, 16>, &cfg);
      if (err != cudaSuccess) {
        cudaGetLastError();  // a card without 16-block clusters
        clusters = 0;
      }
      info.max_cluster = clusters >= 1 ? 16 : 8;
      g_info[dev] = info;
      g_ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = g_info[dev];
  return cudaSuccess;
}

struct Plan {
  int launches;  // 1: the cluster kernel; 2: statistics, then apply
  int cluster;   // blocks a slab's cluster
  int share;     // elements a block
  int threads;   // a block
  int smem;      // dynamic shared memory of the cluster kernel
  int blocks;    // apply blocks a slab (two launches)
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

Plan make_plan(long long slabs, long long L, int esize, int vec,
               const DeviceInfo& dev) {
  const int V = vec ? 16 / esize : 1;
  const long long bytes = L * esize;
  Plan p = {1, 0, 0, 0, 0, 0};
  long long cs = ceil_div(bytes, kTwoPerSm);
  if (cs <= 8) {
    // spread a small grid over more SMs, at least kMinShare bytes a block
    const long long spread = std::min<long long>(
        std::min<long long>(8, ceil_div(2LL * dev.sms, slabs)),
        std::max<long long>(1, bytes / kMinShare));
    cs = std::max(cs, spread);
  } else {
    cs = dev.max_cluster;
  }
  long long share = ceil_div(ceil_div(L, cs), V) * V;
  if (share * esize <= dev.share_bytes) {
    p.cluster = (int)cs;
    p.share = (int)share;
    p.smem = (int)(share * esize);
    // a block alone on its SM takes 32 warps; else about 4 vectors a
    // thread, 128 to 512 threads
    if (p.smem > kTwoPerSm) {
      p.threads = kMaxThreads;
    } else {
      p.threads = 128;
      while (p.threads < 512 && p.threads * 4 * V < share) p.threads *= 2;
    }
    return p;
  }
  p.launches = 2;
  p.cluster = dev.max_cluster;
  p.share = (int)(ceil_div(ceil_div(L, p.cluster), V) * V);
  p.threads = kStatThreads;
  p.blocks = (int)ceil_div(L, (long long)kStatThreads * V *
                                  (vec ? steps<true>() : steps<false>()));
  return p;
}

template <typename T, bool kVec, int CS>
cudaError_t launch_cs(const Plan& p, long long slabs, const T* x, T* y,
                      const void* gamma, const void* beta, int param_bf16,
                      int C, int G, int HW, int L, float eps,
                      cudaStream_t stream) {
  gn_silu_cluster_kernel<T, kVec, CS><<<(unsigned)(slabs * CS), p.threads,
                                        p.smem, stream>>>(
      x, y, gamma, beta, param_bf16, C, G, HW, L, p.share, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t run(const Plan& p, const void* x, const void* gamma,
                const void* beta, void* y, void* scratch, long long slabs,
                int C, int HW, int G, int L, float eps, int param_bf16,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.launches == 1) {
    switch (p.cluster) {
#define GN_SILU_CS(n)                                                       \
  case n:                                                                   \
    return launch_cs<T, kVec, n>(p, slabs, xt, yt, gamma, beta, param_bf16, \
                                 C, G, HW, L, eps, stream);
      GN_SILU_CS(1) GN_SILU_CS(2) GN_SILU_CS(3) GN_SILU_CS(4)
      GN_SILU_CS(5) GN_SILU_CS(6) GN_SILU_CS(7) GN_SILU_CS(8)
      GN_SILU_CS(16)
#undef GN_SILU_CS
      default:
        return cudaErrorInvalidConfiguration;
    }
  }
  SlabStat* stats = static_cast<SlabStat*>(scratch);
  const unsigned grid = (unsigned)(slabs * p.cluster);
  if (p.cluster == 16)
    gn_silu_stats_kernel<T, kVec, 16><<<grid, kStatThreads, 0, stream>>>(
        xt, L, p.share, eps, stats);
  else
    gn_silu_stats_kernel<T, kVec, 8><<<grid, kStatThreads, 0, stream>>>(
        xt, L, p.share, eps, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_silu_apply_kernel<T, kVec><<<(unsigned)(slabs * p.blocks), kStatThreads,
                                  0, stream>>>(xt, yt, stats, gamma, beta,
                                               param_bf16, C, G, HW, L,
                                               p.blocks);
  return cudaGetLastError();
}

// the plan of a call, or an error for shapes the kernels do not take
cudaError_t plan_call(long long N, int C, long long HW, int G, int dtype,
                      int vec, Plan* p) {
  if (N <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long L = C / G * HW;
  if (L > 0x7fffffffLL || HW > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err != cudaSuccess) return err;
  const long long slabs = N * G;
  *p = make_plan(slabs, L, dtype == 1 ? 2 : 4, vec, dev);
  const long long grid =
      slabs * (p->launches == 1 ? p->cluster : std::max(p->cluster, p->blocks));
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x, y: contiguous [N, C, HW]; gamma, beta: [C] (f32, or bf16 when
// param_bf16); scratch: gn_silu_plan's scratch bytes (null when it gives
// none), 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. vec: HW is a
// multiple of 16 / element size and x, y are 16-byte aligned. Returns a
// cudaError_t (0 on success).
int gn_silu(const void* x, const void* gamma, const void* beta, void* y,
            void* scratch, long long N, int C, long long HW, int G, float eps,
            int dtype, int param_bf16, int vec, void* stream) {
  Plan p;
  cudaError_t err = plan_call(N, C, HW, G, dtype, vec, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.launches == 2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long slabs = N * G;
  const int L = (int)(C / G * HW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(vec ? run<__nv_bfloat16, true>(p, x, gamma, beta, y, scratch,
                                                slabs, C, (int)HW, G, L, eps,
                                                param_bf16, s)
                     : run<__nv_bfloat16, false>(p, x, gamma, beta, y,
                                                 scratch, slabs, C, (int)HW, G,
                                                 L, eps, param_bf16, s));
  return (int)(vec ? run<float, true>(p, x, gamma, beta, y, scratch, slabs, C,
                                      (int)HW, G, L, eps, param_bf16, s)
                   : run<float, false>(p, x, gamma, beta, y, scratch, slabs,
                                       C, (int)HW, G, L, eps, param_bf16, s));
}

// How a call at (N, C, HW, G, dtype, vec) launches on the current device:
// launches (1 or 2), the cluster's blocks, the elements and threads a block
// (of the cluster kernel, or of the statistics kernel) and the scratch
// bytes the call needs (16 a slab on the two-launch path, else 0). Returns
// a cudaError_t (0 on success).
int gn_silu_plan(long long N, int C, long long HW, int G, int dtype, int vec,
                 int* launches, int* cluster, int* share, int* threads,
                 long long* scratch_bytes) {
  Plan p;
  cudaError_t err = plan_call(N, C, HW, G, dtype, vec, &p);
  if (err != cudaSuccess) return (int)err;
  *launches = p.launches;
  *cluster = p.cluster;
  *share = p.share;
  *threads = p.threads;
  *scratch_bytes = p.launches == 2 ? N * G * (long long)sizeof(SlabStat) : 0;
  return 0;
}

const char* gn_silu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
