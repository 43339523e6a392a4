// GroupNorm -> SiLU -> 3x3 same-pad convolution on Hopper's own
// instructions (sm_90a): TMA loads from a producer warpgroup into mbarrier
// rings and warpgroup products (wgmma) in two consumer warpgroups. Bound through
// a plain C interface and loaded with ctypes (neurons_tpu_torch/ops/
// fused_conv.py).
//
// Replaces, for bf16, the JAX package's Pallas TPU kernel
//   neurons_tpu/ops/fused_conv.py:91  _kernel  (launched by
//   _pallas_gn_silu_conv)
// which normalises and activates one NHWC sample in VMEM and runs the conv
// as 9 shifted [rows * W, Cin] x [Cin, Cout] MXU products; the activation
// never reaches HBM. That carries over. Every bf16 launch whose map TMA
// can address (ops/fused_conv.py: conv_route: rows of a multiple of 8
// pixels, or whole samples of 8-64 pixels) comes here, every launch of the
// fused clip among them; gn_silu_conv.cu's staged-halo mma.sync kernel
// keeps the other bf16 maps, and its TF32 kernel the f32 launches.
//
// Steps, on x [N, Cin, H, W] (never transposed in device memory):
//   1. the GroupNorm statistics of gn_common.cuh (two launches): per-(n, c)
//      mean, scale = rstd * gamma, shift = beta, centred two-pass moments;
//   2. the conv as an implicit GEMM, M = output pixels, N = Cout, K = 9
//      taps x Cin, walked in steps of (32-channel chunk, tap), the
//      activation applied in shared memory and never written to device
//      memory;
//   3. where the grid is small, split over input chunks: f32 partial sums
//      reduced in a fixed order (no atomics: the same bits on every run).
//
// Design. A tile is 128 consecutive output pixels of the flattened
// (sample, row, column) order: part of one sample (maps of 128 pixels or
// more, "rows" mode) or whole samples (maps of 8-64 pixels, "samples"
// mode), times BN output channels (16, 160 or 256). A block is a producer
// warpgroup and two consumer warpgroups of 64 pixels each, and walks tiles
// persistently (tile t, t + grid, ...), the N tiles of one pixel tile next
// to each other so that the blocks sharing a halo run together.
//   * The producer (one thread of a warpgroup that gives its registers to
//     the consumers: setmaxnreg 40 against 232) keeps two rings full: the
//     raw x halo of each 32-channel chunk, one chunk ahead, one TMA box of
//     a 4-D map over x (rows mode: W columns x the halo rows x 32 channels
//     from row max(y0 - 1, 0), TMA filling zeros past the last row;
//     samples mode: a 3-D map (HW, C, N), whole samples); and the weights,
//     packed [Np / BW][9][Kc][BW] (column blocks of BW, Cin padded to 32,
//     Cout to BN), a ring stage 3 taps of the chunk (3 x 32 x BN), one TMA
//     box (BW x 32 rows x 3 taps x the N tile's column blocks) swizzled by
//     the widest row the blocks allow (BN 256: 128 bytes, 160: 64, 16: 32)
//     and read MN-major; each stage has a full and an empty mbarrier.
//   * The consumers: per chunk, 18 k16 steps (9 taps x 32 channels) of
//     wgmma m64nBNk16 with A from registers: each tap's A fragment is
//     ldmatrix'd from the activated halo tile at the pixel shifted by the
//     tap ([pixel][32 channels], 64 bytes a pixel, 16-byte chunks XORed by
//     the pixel against bank conflicts), so every map width and whole
//     samples take one addressing; B is the stage's descriptor. A stage's
//     3 taps go under one fence and one commit. While the first stage's
//     products run, the warpgroup activates its half of the NEXT chunk's
//     raw halo into the other activated buffer: its two channels' scale and
//     shift - mean * scale loaded once a chunk, then one FMA and SiLU (one
//     tanh.approx) an element, zero where the conv pads (a pad tap is 0
//     after the activation, not SiLU(shift); the pad columns are zeroed
//     once and never written). Each warpgroup waits for its own products
//     and frees the stage; one barrier of the 256 consumer threads a chunk
//     hands the activated buffer over.
//   * The epilogue: f32 + bias to bf16 through shared memory as
//     [Cout][pixel] in pieces of 32 channels, 16-byte stores along the
//     pixels of NCHW (f32 partial sums into the split workspace, 4 pixels
//     a store).
// What was measured and kept (tools/torch_conv_variants.py, PERF.md): one
// TMA box a 3-tap stage, not one a tap and column block (the producer's
// 45 small copies a chunk had set the time); SiLU on tanh.approx (the
// activation was bound by its two MUFU ops an element); the whole
// activation beside the first stage's products. Left out: a 2-CTA cluster
// sharing each stage by multicast (slower), the activation a pixel's 8
// channels a thread (8x the statistics loads), bf16x2 tanh (slower, 0.85
// of the plain version's error against 0.68).
// Registers: a block's 12 warps share each SM sub-partition's 16 K
// registers by threes, so ptxas compiles for 168 a thread; the consumers,
// at 232 after setmaxnreg, hold the accumulator (BN / 2), a stage's A
// fragments (24) and descriptors (12) and the activation without a spill
// at every N tile (a producer of one warp, 9 warps, spilled at BN 160 and
// serialized the products at BN 256: ptxas C7512). The raw box never
// starts left of or above the map and is never wider than it: a box from
// column -1, W + 2 rounded to 8 wide, trapped on the card.
//
// What bounds it on an H100: 2 * M * Cout * 9 * Cin operations at 989
// TFLOP/s (bf16), against x read once, W read and y written at 3.35 TB/s:
// the res-block convs are bound by operations, the UNet head's Cout = 4 by
// bytes. The times stand in PERF.md.

#include <algorithm>

#define GN_STATS_NAME(kernel) gn_conv_stats_##kernel
#include "gn_common.cuh"
#include "mma_sm80.cuh"
#include "sm90.cuh"

namespace {

constexpr int kChunk = 32;          // input channels a K step (the packed Kc pad)
constexpr int kBM = 128;            // output pixels a tile
constexpr int kConsumers = 256;     // two warpgroups of 64 pixels
// and the producer warpgroup, which gives its registers to them (setmaxnreg)
constexpr int kThreads = kConsumers + 128;
constexpr int kTapsPerGroup = 3;    // taps under one fence and commit
constexpr int kGroups = 9 / kTapsPerGroup;
constexpr int kEpiLd = 64 + 4;      // floats a staged output row
constexpr int kSmemLimit = 232448;  // the 227 KB a block may use

template <int BN_>
struct ConvCfg {
  static constexpr int BN = BN_;
  // the widest swizzled column block BN divides into
  static constexpr int BW = BN % 64 == 0 ? 64 : BN % 32 == 0 ? 32 : 16;
  static constexpr int NB = BN / BW;
  static constexpr int kRowBytes = 2 * BW;
  static constexpr int kMode = swizzle_mode(kRowBytes);
  // a ring stage: the weights of 3 taps of a chunk, [NB][3][32][BW]
  static constexpr int kStageBytes = kTapsPerGroup * kChunk * BN * 2;
  static constexpr int kEpi = BN < 32 ? BN : 32;       // channels a piece
};

struct Sm90Params {
  const float* mean;  // [N, Cin] each
  const float* scale;
  const float* shift;
  const void* bias;   // [Cout] or null
  __nv_bfloat16* y;   // [N, Cout, H, W]
  float* ws;          // [splits, N, Cout, H, W] f32 partials, or null
  long long HW;
  int N, Cin, H, W, Cout, Kc, bias_bf16;
  int mode;           // 0 rows (4-D padded halo box), 1 whole samples (3-D)
  int S;              // samples a tile (1 in rows mode)
  int rb;             // activated halo rows a sample
  int wr, rr;         // raw box: row length and rows a (sample, channel)
  int tps;            // rows mode: tiles a sample
  int mtiles, ntiles, tiles, nchunks, cps, stages;
  int act_bytes, raw_bytes, raw_box_bytes;
};

// ---------------------------------------------------------------------------
// the walk: a block's steps are (tile, chunk) pairs, tile t = blockIdx.x,
// + gridDim.x, ...; a tile t is (split z, pixel tile m, N tile nt), N
// fastest

struct Step {
  int t, c, c_end;
};

__device__ __forceinline__ void tile_chunks(const Sm90Params& p, Step& s) {
  const int z = s.t / (p.mtiles * p.ntiles);
  s.c = z * p.cps;
  s.c_end = min(p.nchunks, s.c + p.cps);
}

__device__ __forceinline__ bool first_step(const Sm90Params& p, Step& s) {
  s.t = blockIdx.x;
  if (s.t >= p.tiles) return false;
  tile_chunks(p, s);
  return true;
}

__device__ __forceinline__ bool next_step(const Sm90Params& p, Step& s) {
  if (++s.c < s.c_end) return true;
  s.t += gridDim.x;
  if (s.t >= p.tiles) return false;
  tile_chunks(p, s);
  return true;
}

// a tile's place: first sample, first pixel of it, first halo row (y0 - 1)
// and N tile
struct Geo {
  int n0, p0, y_lo, nt, z;
};

__device__ __forceinline__ Geo geo_of(const Sm90Params& p, int t) {
  Geo g;
  g.z = t / (p.mtiles * p.ntiles);
  const int r = t - g.z * p.mtiles * p.ntiles;
  const int m = r / p.ntiles;
  g.nt = r - m * p.ntiles;
  if (p.mode == 0) {
    g.n0 = m / p.tps;
    g.p0 = (m - g.n0 * p.tps) * kBM;
    g.y_lo = g.p0 / p.W - 1;
  } else {
    g.n0 = m * p.S;
    g.p0 = 0;
    g.y_lo = -1;
  }
  return g;
}

// byte offset of channel chunk c (0..3, 8 channels each) of halo pixel pos
// in an activated tile: 64 bytes a pixel, the chunks XORed by pos / 2 so
// that the 8 rows of an ldmatrix hit 8 different 16-byte bank groups
__device__ __forceinline__ int halo_off(int pos, int c) {
  return pos * (kChunk * 2) + ((c ^ ((pos >> 1) & 3)) << 4);
}

// tile slot (0..127) -> (sample, pixel) and whether it is an output pixel
__device__ __forceinline__ bool slot_pixel(const Sm90Params& p, const Geo& g,
                                           int slot, int& n, int& pix) {
  if (p.mode == 0) {
    n = g.n0;
    pix = g.p0 + slot;
    return pix < p.HW;
  }
  const int s = slot / (int)p.HW;
  n = g.n0 + s;
  pix = slot - s * (int)p.HW;
  return n < p.N;
}

// the activated-tile position of a slot's pixel under tap (1, 1); a slot
// that is no output pixel reads a pixel of the tile (its result is dropped)
__device__ __forceinline__ int slot_pos(const Sm90Params& p, const Geo& g,
                                        int slot) {
  const int hw_w = p.W + 2;
  int n, pix;
  if (!slot_pixel(p, g, slot, n, pix)) return hw_w + 1;
  const int yy = pix / p.W, xx = pix - yy * p.W;
  const int s = n - g.n0;
  return (s * p.rb + yy - g.y_lo) * hw_w + xx + 1;
}

// The activation on the conv's operand path: SiLU(v) = v sigmoid(v) =
// h + h tanh(h), h = v / 2, on one MUFU op (tanh.approx.f32, relative error
// about 2^-11, below the bf16 rounding that follows) where exp and a
// division take two: the activation's MUFU ops bound it (PERF.md).
__device__ __forceinline__ float silu_operand(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// a named barrier of n threads (barrier.sync, not the aligned bar.sync:
// the threads may come from divergent code)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// items of one chunk's activation: (halo row or sample, 8-pixel group,
// channel pair), the channel pair fastest
__device__ __forceinline__ int act_groups(const Sm90Params& p) {
  return p.mode == 0 ? p.W / 8 : (int)(p.HW / 8);
}

__device__ __forceinline__ int act_items(const Sm90Params& p) {
  return (p.mode == 0 ? p.rb : p.S) * act_groups(p) * 16;
}

// element q of 8 bf16 held in a uint4, as f32 (q known at compile time)
__device__ __forceinline__ float bf16_at(const uint4& v, int q) {
  const uint32_t w = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}

// A thread's affine for one chunk: scale and shift - mean * scale of its
// channel pair (tid & 15) and its sample (rows mode: the tile's; samples
// mode: that of its one item, S x HW = 128 pixels making 256 items), and
// which of the two are channels of a sample of x. Every item of a thread
// shares them, so they are loaded once a chunk, ahead of its activation.
struct Affine {
  float s0, b0, s1, b1;
  bool in0, in1;
};

__device__ __forceinline__ Affine load_affine(const Sm90Params& p,
                                              const Geo& g, int c, int ctid) {
  const int cp = ctid & 15;
  const int n = g.n0 + (p.mode == 0 ? 0 : (ctid >> 4) / (int)(p.HW / 8));
  const int cg = c * kChunk + 2 * cp;
  Affine a;
  a.in0 = cg < p.Cin && n < p.N;
  a.in1 = cg + 1 < p.Cin && n < p.N;
  a.s0 = a.b0 = a.s1 = a.b1 = 0.f;
  const long long nc = (long long)n * p.Cin + cg;
  if (a.in0) {
    a.s0 = __ldg(p.scale + nc);
    a.b0 = fmaf(-__ldg(p.mean + nc), a.s0, __ldg(p.shift + nc));
  }
  if (a.in1) {
    a.s1 = __ldg(p.scale + nc + 1);
    a.b1 = fmaf(-__ldg(p.mean + nc + 1), a.s1, __ldg(p.shift + nc + 1));
  }
  return a;
}

// Activate item i of chunk c of tile geometry g: two channels x 8 raw
// pixels (two 16-byte shared loads), SiLU(x scale + shift - mean scale),
// 8 channel pairs written into the activated tile; zero where the conv
// pads (rows outside the image, channels past Cin, samples past N). The
// pad columns are never written: zero from the kernel's start.
__device__ __forceinline__ void activate_item(const Sm90Params& p,
                                              const Geo& g, const Affine& af,
                                              const __nv_bfloat16* raw,
                                              unsigned char* act, int i) {
  const int hw_w = p.W + 2;
  const int nj = act_groups(p);
  const int cp = i & 15, j = (i >> 4) % nj, o = (i >> 4) / nj;
  const int s = p.mode == 0 ? 0 : o;
  int pos, xx, rrow = 0;
  bool row_in = true;
  if (p.mode == 0) {  // halo row o is image row y_lo + o; the box starts
                      // at image row max(y_lo, 0)
    const int yy = g.y_lo + o;
    row_in = yy >= 0 && yy < p.H;
    rrow = row_in ? yy - max(g.y_lo, 0) : 0;
    xx = 8 * j;
    pos = o * hw_w + xx + 1;
  } else {
    const int yy = 8 * j / p.W;
    xx = 8 * j - yy * p.W;
    pos = (s * p.rb + yy + 1) * hw_w + xx + 1;
  }
  const bool in0 = row_in && af.in0, in1 = row_in && af.in1;
  const __nv_bfloat16* src =
      raw + ((s * kChunk + 2 * cp) * p.rr + rrow) * p.wr + 8 * j;
  const uint4 v0 = *reinterpret_cast<const uint4*>(src);
  const uint4 v1 = *reinterpret_cast<const uint4*>(src + p.rr * p.wr);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float a0 =
        in0 ? silu_operand(fmaf(bf16_at(v0, q), af.s0, af.b0)) : 0.f;
    const float a1 =
        in1 ? silu_operand(fmaf(bf16_at(v1, q), af.s1, af.b1)) : 0.f;
    *reinterpret_cast<uint32_t*>(act + halo_off(pos, cp >> 2) + (cp & 3) * 4) =
        pack_bf16(a0, a1);
    ++pos;
    if (++xx == p.W) {  // the next image row: past the two pad columns
      xx = 0;
      pos += 2;
    }
  }
}

// this thread's share of a chunk's activation items
__device__ __forceinline__ void activate(const Sm90Params& p, const Geo& g,
                                        const Affine& af,
                                        const __nv_bfloat16* raw,
                                        unsigned char* act, int ctid) {
  const int items = act_items(p);
  for (int i = ctid; i < items; i += kConsumers)
    activate_item(p, g, af, raw, act, i);
  __syncwarp();  // the warp converged again before its next aligned op
}

// A consumer thread of the kernel below (warpgroups 0 and 1).
template <int BN>
__device__ __forceinline__ void consume(const Sm90Params& p, unsigned char* sB,
                                        unsigned char* sAct,
                                        unsigned char* sRawB, float* sEpi,
                                        uint64_t* full_b, uint64_t* empty_b,
                                        uint64_t* full_raw,
                                        uint64_t* empty_raw) {
  using C = ConvCfg<BN>;
  // warpgroup wg owns tile slots 64 wg .. 64 wg + 63, warp w of it slots
  // 16 w .., lane rows g and g + 8
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int hw_w = p.W + 2;
  const uint32_t b_addr = smem_u32(sB);
  const __nv_bfloat16* raws = reinterpret_cast<const __nv_bfloat16*>(sRawB);
  // this lane's ldmatrix row: 16 w + (lane & 7) + 8 ((lane >> 3) & 1), at
  // 16-byte chunk 2 ks + (lane >> 4) of the k16 step
  const int a_slot = 64 * wg + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;

  Step s;
  if (!first_step(p, s)) return;
  int k = 0;  // the block's step count
  // the first chunk's activation, before any product
  {
    const Geo g0 = geo_of(p, s.t);
    const Affine af0 = load_affine(p, g0, s.c, tid);
    mbar_wait(full_raw, 0);
    activate(p, g0, af0, raws, sAct, tid);
  }
  mbar_arrive(empty_raw);

  float acc[BN / 2];
  bool live = true;
  while (live) {
    const Geo g = geo_of(p, s.t);
    const int a_pos = slot_pos(p, g, a_slot);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    bool in_tile = true;
    while (in_tile) {
      bar_sync(1, kConsumers);  // chunk k's activated tile is complete
      Step nx = s;
      const bool has_next = next_step(p, nx);
      const Geo gn = has_next ? geo_of(p, nx.t) : g;
      // the next chunk's affine, in flight while this chunk's first
      // products are issued
      const Affine af = load_affine(p, gn, has_next ? nx.c : s.c, tid);
      const uint32_t act = smem_u32(sAct + (k & 1) * p.act_bytes);
      unsigned char* act_next = sAct + ((k + 1) & 1) * p.act_bytes;
      const __nv_bfloat16* raw_next = raws + ((k + 1) & 1) * (p.raw_bytes / 2);
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        uint32_t a[2 * kTapsPerGroup][4];
        uint64_t db[2 * kTapsPerGroup];
        const int b = k * kGroups + grp, st = b % p.stages;
#pragma unroll
        for (int tt = 0; tt < kTapsPerGroup; ++tt) {
          const int tap = grp * kTapsPerGroup + tt;
          const int shift = (tap / 3 - 1) * hw_w + (tap % 3 - 1);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            ldmatrix_x4(a[2 * tt + ks],
                        act + halo_off(a_pos + shift, 2 * ks + (lane >> 4)));
            // the stage is [NB][3 taps][32 rows][BW]: LBO one column
            // block, SBO 8 rows, + 32 rows a tap, + 16 rows a k16 step
            db[2 * tt + ks] = gmma_desc(
                b_addr + st * C::kStageBytes +
                    (tt * kChunk + ks * 16) * C::kRowBytes,
                kTapsPerGroup * kChunk * C::kRowBytes, 8 * C::kRowBytes,
                C::kMode);
          }
        }
        mbar_wait(full_b + st, (b / p.stages) & 1);
        __syncwarp();
        pin<2 * kTapsPerGroup>(db);
        int one = 1;
        asm volatile("" : "+r"(one));
        fence_regs<BN / 2>(acc);
        fence_regs<8 * kTapsPerGroup>(&a[0][0]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 2 * kTapsPerGroup; ++i)
          Wgmma<BN>::rs(acc, a[i], db[i], one);
        wgmma_commit();
        // while the first group runs: the next chunk's activation
        if (has_next && grp == 0) {
          mbar_wait(full_raw + ((k + 1) & 1), ((k + 1) >> 1) & 1);
          activate(p, gn, af, raw_next, act_next, tid);
        }
        wgmma_wait<0>();
        fence_regs<BN / 2>(acc);
        if (wtid == 0) mbar_arrive(empty_b + st);
        __syncwarp();
      }
      if (has_next) mbar_arrive(empty_raw + ((k + 1) & 1));
      ++k;
      in_tile = has_next && nx.t == s.t;
      live = has_next;
      if (!in_tile) {
        // the epilogue: 32 output channels at a time through this
        // warpgroup's [channel][pixel] staging tile
        float* stg = sEpi + wg * C::kEpi * kEpiLd;
        const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int piece = 0; piece < BN / C::kEpi; ++piece) {
#pragma unroll
          for (int i = piece * C::kEpi / 8; i < (piece + 1) * C::kEpi / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              stg[(8 * i + 2 * t4 + (e & 1) - piece * C::kEpi) * kEpiLd +
                  16 * warp + gr + 8 * (e >> 1)] = acc[4 * i + e];
          bar_sync(2 + wg, 128);
          const int co_base = g.nt * BN + piece * C::kEpi;
          if (p.ws) {
            for (int v = wtid; v < C::kEpi * 16; v += 128) {
              const int col = v >> 4, r4 = (v & 15) * 4;
              int n, pix;
              const int co = co_base + col;
              if (co >= p.Cout || !slot_pixel(p, g, 64 * wg + r4, n, pix))
                continue;
              const float4 val =
                  *reinterpret_cast<const float4*>(stg + col * kEpiLd + r4);
              *reinterpret_cast<float4*>(
                  p.ws + (((long long)g.z * p.N + n) * p.Cout + co) * p.HW +
                  pix) = val;
            }
          } else {
            for (int v = wtid; v < C::kEpi * 8; v += 128) {
              const int col = v >> 3, r8 = (v & 7) * 8;
              int n, pix;
              const int co = co_base + col;
              if (co >= p.Cout || !slot_pixel(p, g, 64 * wg + r8, n, pix))
                continue;
              const float bias = p.bias ? param_at(p.bias, co, p.bias_bf16) : 0.f;
              const float4 lo =
                  *reinterpret_cast<const float4*>(stg + col * kEpiLd + r8);
              const float4 hi =
                  *reinterpret_cast<const float4*>(stg + col * kEpiLd + r8 + 4);
              uint4 out;
              out.x = pack_bf16(lo.x + bias, lo.y + bias);
              out.y = pack_bf16(lo.z + bias, lo.w + bias);
              out.z = pack_bf16(hi.x + bias, hi.y + bias);
              out.w = pack_bf16(hi.z + bias, hi.w + bias);
              *reinterpret_cast<uint4*>(
                  p.y + ((long long)n * p.Cout + co) * p.HW + pix) = out;
            }
          }
          bar_sync(2 + wg, 128);
        }
      }
      s = nx;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const Sm90Params p) {
  using C = ConvCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sB = smem;                                  // [stages][NB][32][BW]
  unsigned char* sAct = sB + p.stages * C::kStageBytes;      // [2][halo][32]
  unsigned char* sRawB = sAct + 2 * p.act_bytes;             // [2][S][32][rr][wr]
  float* sEpi = reinterpret_cast<float*>(sRawB + 2 * p.raw_bytes);  // [2][kEpi][kEpiLd]
  uint64_t* full_b = reinterpret_cast<uint64_t*>(sEpi + 2 * C::kEpi * kEpiLd);
  uint64_t* empty_b = full_b + p.stages;
  uint64_t* full_raw = empty_b + p.stages;
  uint64_t* empty_raw = full_raw + 2;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full_b + s, 1);
      mbar_init(empty_b + s, 2);  // one arrival a consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(full_raw + b, 1);
      mbar_init(empty_raw + b, kConsumers);
    }
    fence_barrier_init();
  }
  // the pad columns (and, for whole samples, the pad rows) are never
  // written: zero from here on
  for (int i = tid; i < 2 * p.act_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(sAct)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues
    setmaxnreg_dec<40>();
    Step s;
    if (tid == kConsumers && first_step(p, s)) {
      const CUtensorMap* mx = &map_x;
      auto issue_raw = [&](int k, const Step& st) {
        const int buf = k & 1;
        mbar_wait(empty_raw + buf, ((k >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full_raw + buf, p.raw_box_bytes);
        const Geo g = geo_of(p, st.t);
        if (p.mode == 0)
          tma_load_4d(sRawB + buf * p.raw_bytes, mx, full_raw + buf, 0,
                      max(g.y_lo, 0), st.c * kChunk, g.n0);
        else
          tma_load_4d(sRawB + buf * p.raw_bytes, mx, full_raw + buf, 0,
                      st.c * kChunk, g.n0, 0);
      };
      Step ahead = s;
      issue_raw(0, ahead);
      bool more = next_step(p, ahead);
      for (int k = 0;; ++k) {
        // the next chunk's halo first: the consumers activate it while
        // they run this chunk's taps
        if (more) {
          issue_raw(k + 1, ahead);
          more = next_step(p, ahead);
        }
        // the weights of step k: a ring stage a group of 3 taps, one box
        // (BW columns x 32 rows x 3 taps x the N tile's NB column blocks)
        const int blk0 = geo_of(p, s.t).nt * C::NB;
        for (int grp = 0; grp < kGroups; ++grp) {
          const int b = k * kGroups + grp, st = b % p.stages;
          mbar_wait(empty_b + st, ((b / p.stages) & 1) ^ 1);
          mbar_arrive_expect_tx(full_b + st, C::kStageBytes);
          tma_load_4d(sB + st * C::kStageBytes, &map_w, full_b + st, 0,
                      s.c * kChunk, grp * kTapsPerGroup, blk0);
        }
        if (!next_step(p, s)) break;
      }
    }
  } else {
    consume<BN>(p, sB, sAct, sRawB, sEpi, full_b, empty_b, full_raw,
                empty_raw);
  }
}

// y = the split partials summed in split order, plus the bias
__global__ void __launch_bounds__(256)
gn_silu_conv_sm90_reduce_kernel(const float* __restrict__ ws, int splits,
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

// ---------------------------------------------------------------------------
// host side

inline int round_up(long long v, int to) { return (int)((v + to - 1) / to * to); }

// Plan indices (ops/fused_conv.py: conv_plan_sm90 writes them)
enum {
  kPlanBn, kPlanStages, kPlanMode, kPlanS, kPlanRb, kPlanWr, kPlanRr,
  kPlanMtiles, kPlanNtiles, kPlanSplits, kPlanCps, kPlanBlocks, kPlanSmem,
  kPlanLen
};

// shared memory of a plan: the weight ring, two activated and two raw
// tiles, the epilogue's staging, the barriers and the 1024-byte alignment
long long smem_bytes(int bn, int stages, int act_bytes, int raw_bytes) {
  const int epi = bn < 32 ? bn : 32;
  return (long long)stages * kTapsPerGroup * kChunk * bn * 2 + 2LL * act_bytes +
         2LL * raw_bytes + 2LL * epi * kEpiLd * 4 + 8LL * (2 * stages + 4) +
         1024;
}

// the plan's derived sizes into p, or false where the plan does not fit
// this call (the wrapper's plan and the kernel's disagree)
bool fill_params(Sm90Params& p, const int* plan, long long N, int Cin, int H,
                 int W, int Cout, int Kc, int Np) {
  const int bn = plan[kPlanBn];
  const long long HW = (long long)H * W;
  p.HW = HW;
  p.N = (int)N; p.Cin = Cin; p.H = H; p.W = W; p.Cout = Cout; p.Kc = Kc;
  p.mode = plan[kPlanMode];
  p.S = plan[kPlanS];
  p.rb = plan[kPlanRb];
  p.wr = plan[kPlanWr];
  p.rr = plan[kPlanRr];
  p.mtiles = plan[kPlanMtiles];
  p.ntiles = plan[kPlanNtiles];
  p.stages = plan[kPlanStages];
  p.nchunks = Kc / kChunk;
  p.cps = plan[kPlanCps];
  const int splits = plan[kPlanSplits];
  p.tiles = p.mtiles * p.ntiles * splits;
  if (N > 0x7fffffff || HW > 0x7fffffff || Kc % kChunk || Kc < Cin ||
      Np % bn || Np < Cout || p.ntiles != Np / bn || p.stages < 2 ||
      p.cps <= 0 || (long long)p.cps * (splits - 1) >= p.nchunks ||
      (long long)p.cps * splits < p.nchunks || plan[kPlanBlocks] <= 0 ||
      plan[kPlanBlocks] > p.tiles)
    return false;
  if (p.mode == 0) {
    // rows: 128 consecutive pixels of one sample a tile; the halo box spans
    // every tile's rows
    p.tps = (int)((HW + kBM - 1) / kBM);
    int rows = 0;
    for (int t = 0; t < p.tps; ++t) {
      const long long p0 = (long long)t * kBM, pe = std::min(HW, p0 + kBM);
      rows = std::max(rows, (int)((pe - 1) / W - p0 / W) + 3);
    }
    if (W % 8 || W > 256 || rows > H || p.S != 1 || p.rb != rows ||
        p.rr != rows || p.wr != W || p.mtiles != N * p.tps)
      return false;
  } else {
    p.tps = 1;
    if (HW % 8 || HW >= kBM || kBM % HW || p.S != kBM / HW || p.rb != H + 2 ||
        p.wr != HW || p.rr != 1 || p.mtiles != (N + p.S - 1) / p.S)
      return false;
  }
  p.act_bytes = round_up((long long)p.S * p.rb * (W + 2) * kChunk * 2, 1024);
  p.raw_box_bytes = p.S * kChunk * p.rr * p.wr * 2;
  p.raw_bytes = round_up(p.raw_box_bytes, 1024);
  return smem_bytes(bn, p.stages, p.act_bytes, p.raw_bytes) == plan[kPlanSmem] &&
         plan[kPlanSmem] <= kSmemLimit;
}

template <int BN>
cudaError_t launch_as(const CUtensorMap& mx, const CUtensorMap& mw,
                      const Sm90Params& p, int blocks, int smem,
                      cudaStream_t stream) {
  auto kernel = gn_silu_conv_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(mx, mw, p);
  return cudaGetLastError();
}

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

}  // namespace

extern "C" {

// x: contiguous [N, Cin, H, W] bf16, 16-byte aligned; gn_gamma, gn_beta:
// [Cin] (f32, or bf16 when gn_param_bf16); w: the packed weights [Np / BW,
// 9, Kc, BW] bf16 (column blocks of BW = the N tile's swizzle width: 64,
// 32 or 16), 16-byte aligned, Kc a multiple of 32 and >= Cin, Np a
// multiple of the plan's BN and >= Cout, zero outside [Cin, Cout]; bias: [Cout] (f32,
// or bf16 when bias_bf16) or null; y: contiguous [N, Cout, H, W] bf16;
// scratch: gn_silu_conv_sm90_scratch_bytes bytes, 256-byte aligned; plan:
// the 13 ints of ops/fused_conv.py:conv_plan_sm90. Returns a cudaError_t (0
// on success; cudaErrorInvalidValue where the plan does not fit the call),
// or 10000 + the CUresult of a failed tensor-map encode.
int gn_silu_conv_sm90(const void* x, const void* gn_gamma, const void* gn_beta,
                      const void* w, const void* bias, void* y, void* scratch,
                      long long N, int Cin, int H, int W, int Cout, int G,
                      float eps, int Kc, int Np, int gn_param_bf16,
                      int bias_bf16, const int* plan, void* stream) {
  const int bn = plan[kPlanBn];
  if (N <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || G <= 0 ||
      Cin % G != 0 || (bn != 16 && bn != 160 && bn != 256) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  Sm90Params p;
  if (!fill_params(p, plan, N, Cin, H, W, Cout, Kc, Np))
    return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  if (N * G * (long long)stat_chunks(Cin / G * HW) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *mean, *scale, *shift;
  cudaError_t err = launch_stats<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), N, Cin, HW, G, eps, gn_gamma,
      gn_beta, gn_param_bf16, scratch, &mean, &scale, &shift, s);
  if (err != cudaSuccess) return (int)err;
  const int splits = plan[kPlanSplits];
  p.mean = mean;
  p.scale = scale;
  p.shift = shift;
  p.bias = bias;
  p.bias_bf16 = bias_bf16;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = splits > 1
             ? reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                        align256(stat_scratch_bytes(N, Cin, HW, G)))
             : nullptr;

  CUtensorMap mx, mw;
  int e;
  if (p.mode == 0) {  // (W, H, C, N), the halo rows' box from (0, max(y0 - 1, 0))
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)HW * 2,
                                   (cuuint64_t)Cin * HW * 2};
    const cuuint32_t box[4] = {(cuuint32_t)p.wr, (cuuint32_t)p.rr,
                               (cuuint32_t)kChunk, 1};
    e = encode(&mx, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {  // (HW, C, N, 1), whole samples
    const cuuint64_t dims[4] = {(cuuint64_t)HW, (cuuint64_t)Cin, (cuuint64_t)N,
                                1};
    const cuuint64_t strides[3] = {(cuuint64_t)HW * 2,
                                   (cuuint64_t)Cin * HW * 2, 16};
    const cuuint32_t box[4] = {(cuuint32_t)HW, (cuuint32_t)kChunk,
                               (cuuint32_t)p.S, 1};
    e = encode(&mx, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (e) return e;
  {  // the packed weights [Np / BW][9][Kc][BW]: a box of BW columns x 32
     // rows x 3 taps x the N tile's column blocks
    const int bw = bn % 64 == 0 ? 64 : bn % 32 == 0 ? 32 : 16;
    const cuuint64_t dims[4] = {(cuuint64_t)bw, (cuuint64_t)Kc, 9,
                                (cuuint64_t)(Np / bw)};
    const cuuint64_t strides[3] = {(cuuint64_t)bw * 2, (cuuint64_t)Kc * bw * 2,
                                   (cuuint64_t)9 * Kc * bw * 2};
    const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)kChunk,
                               (cuuint32_t)kTapsPerGroup, (cuuint32_t)(bn / bw)};
    e = encode(&mw, w, dims, strides, box,
               bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : bw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
    if (e) return e;
  }
  const int blocks = plan[kPlanBlocks], smem = plan[kPlanSmem];
  err = bn == 256   ? launch_as<256>(mx, mw, p, blocks, smem, s)
        : bn == 160 ? launch_as<160>(mx, mw, p, blocks, smem, s)
                    : launch_as<16>(mx, mw, p, blocks, smem, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = N * Cout * HW;
  const long long rblocks = std::min((total + 255) / 256, 132LL * 16);
  gn_silu_conv_sm90_reduce_kernel<<<(unsigned)rblocks, 256, 0, s>>>(
      p.ws, splits, total, HW, Cout, bias, bias_bf16, p.y);
  return (int)cudaGetLastError();
}

// Bytes of scratch a call needs: the statistics, then (splits > 1) the f32
// partial sums.
long long gn_silu_conv_sm90_scratch_bytes(long long N, int Cin, int H, int W,
                                          int Cout, int G, int splits) {
  const long long HW = (long long)H * W;
  return align256(stat_scratch_bytes(N, Cin, HW, G)) +
         (splits > 1 ? (long long)splits * N * Cout * HW * 4 : 0);
}

const char* gn_silu_conv_sm90_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
