// DPT regression-head trunk for the port (K8):
//   conv1 3x3 pad 1 (Cin -> 128, + b1) on the half-resolution grid
//   -> align-corners bilinear resize to the (H, W) image grid
//   -> conv2 3x3 pad 1 (128 -> 128, + b2) -> ReLU -> 1x1 conv3 (128 -> 4, + b3)
// input NHWC (n, hh, wc, Cin); output channel-major (n, 4, H * W), the layout
// ops/postprocess.postprocess_transposed consumes.
//
// Replaces the TPU kernel fast3r_tpu/ops/trunk_kernel.py (_trunk_kern, as
// called by _trunk_call and fused_regression_head_t).
//
// What bounds it on an H100: FLOPs.  conv2 on the full-resolution grid is
// 9 * 128 * 128 * 2 FLOPs per pixel (58 GFLOP per 384x512 image), four
// times conv1 (29 GFLOP per 192x256 grid at Cin = 256), while the bytes are
// a few tens of MB per image: 1.743 TFLOP for the 20-view request's chain,
// 1.763 ms at 989 TFLOP/s.
//
// bf16 (the served type): two launches of one warp-specialised implicit-
// GEMM kernel on wgmma fed by TMA (trunk_conv_kernel<1>: conv1,
// trunk_conv_kernel<2>: conv2 with the resize and conv3):
//   * a tile is 4 output rows x 64 output columns (256 pixels) x all 128
//     output channels; M = pixels, N = 128, K = 9 taps x input channels in
//     slices of 64 (128 bytes, the swizzle span);
//   * each K slice's input halo, 6 rows x 72 pixels (66 used) x 64
//     channels, sits in one of two halo stages as 128-byte swizzled rows,
//     one a pixel; tap (ky, kx) of output row r reads the 64 rows from
//     halo pixel (r + ky) * 72 + kx on: a shifted window whose wgmma
//     descriptor starts at that row (hopper.cuh desc_sw128: the card
//     swizzles by address, so the window reads the halo's own swizzle
//     phase), so the nine taps read one staged halo and nothing is copied
//     per tap;
//   * the tap's weights, (128 out, 64 in) K-major, stream through a ring of
//     4 stages by TMA from the (tap, out, in) layout the host lays out;
//   * warpgroup 0: one thread issues the TMA loads (conv1: the halo too, a
//     4-D box of x at (slice, x0 - 1, y0 - 1, image), whose elements past
//     the image load as zeros: the padding).  In conv2 its other three
//     warps and a fourth warpgroup build each halo stage from conv1's
//     output and the host's tap tables (ops/resize._interp_taps), as the
//     plain version's two products do: the tile's window of coarse rows
//     and columns arrives by one TMA box, fetched a slice ahead; a row pass
//     (each of the 6 halo rows between its two coarse rows, at the
//     window's columns, in fp32, rounded to bf16) into shared memory; a
//     column pass (each halo pixel between its two columns of that,
//     rounded to bf16) into the halo stage; zero outside the fine grid
//     (conv2's padding).  A tile whose window does not fit (a steep
//     downscale) takes each pixel's four taps from device memory instead.
//     The build, not the products, sets conv2's pace (NVIDIA H100 80GB
//     HBM3, 700 W, scripts/time_trunk_ln_bwd.py, the 20-view shape): 1.92-
//     1.99 ms without it; 3.33 with three builder warps taking four taps a
//     pixel from a window they loaded; 2.49-2.67 with seven warps and the
//     two passes, the window loaded by the builders; 2.40-2.42 with the
//     window by TMA (at the cost of conv2's fourth weight stage);
//   * warpgroups 1 and 2 (setmaxnreg 192; the others 120 in conv1, 64 in
//     conv2): each owns two
//     output rows, two wgmma m64n128k16 a 16-deep step (128 fp32
//     accumulators a thread), one commit group a tap, a stage handed back
//     when the group that read it has retired;
//   * the CTAs (one an SM, 177 KB of shared memory in conv1, 221 KB in
//     conv2) walk the tiles in
//     steps of the grid, image-major, so neighbours run together and share
//     their rows in L2;
//   * conv1's epilogue adds b1 and stores conv1's output as bf16 (n, hh,
//     wc, 128), the rounding point of the TPU kernel and of the plain
//     version; conv2's adds b2, applies ReLU and conv3 (+ b3) in fp32 in
//     registers, sums the 128 channels over the quad's lanes and stores
//     (n, 4, H * W) in bf16.
// fp32 (used to check the kernel tightly) runs scalar FMAs: 256 threads,
// each an 8-pixel x 8-channel register tile, 8-channel chunks, through an
// fp32 conv1 scratch.  Accumulation is fp32 throughout.
// Not yet: 2-CTA clusters multicasting the weights (each tile reads the
// 295 KB of conv2's weights from L2), TMA stores, an epilogue overlapping
// the next tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;

using bf16 = __nv_bfloat16;

constexpr int kTH = 8, kTW = 16;  // output tile: 8 rows x 16 columns
constexpr int kHalo = (kTH + 2) * (kTW + 2);  // staged input pixels
constexpr int kCo = 128;          // conv1 / conv2 output channels
constexpr int kC3 = 4;            // conv3 output channels
constexpr int kThreads = 256;

// align-corners 2-tap interpolation for output index o of in -> out
// (the same lo / hi / frac arithmetic as ops/resize._interp_taps)
__device__ inline void taps(int o, int in, int out, int& lo, int& hi,
                            float& fr) {
  if (out == 1 || in == 1) {
    lo = hi = 0;
    fr = 0.f;
    return;
  }
  const double src = (double)o * ((double)(in - 1) / (double)(out - 1));
  int l = (int)floor(src);
  l = min(max(l, 0), in - 1);
  lo = l;
  hi = min(l + 1, in - 1);
  fr = (float)(src - (double)l);
}

// resized conv1 scratch at fine pixel (y, x), 4 channels from c
__device__ inline float4 resized4(const float* y1, int n, int hh, int wc,
                                  int H, int W, int y, int x, int c) {
  int ly, hy, lx, hx;
  float fy, fx;
  taps(y, hh, H, ly, hy, fy);
  taps(x, wc, W, lx, hx, fx);
  const float* base = y1 + (long long)n * hh * wc * kCo + c;
  const float4 a = *reinterpret_cast<const float4*>(base + ((long long)ly * wc + lx) * kCo);
  const float4 b = *reinterpret_cast<const float4*>(base + ((long long)ly * wc + hx) * kCo);
  const float4 cc = *reinterpret_cast<const float4*>(base + ((long long)hy * wc + lx) * kCo);
  const float4 d = *reinterpret_cast<const float4*>(base + ((long long)hy * wc + hx) * kCo);
  // rows first, then columns, as the interp-matrix form does
  auto lerp2 = [&](float a_, float b_, float c_, float d_) {
    const float left = (1.f - fy) * a_ + fy * c_;
    const float right = (1.f - fy) * b_ + fy * d_;
    return (1.f - fx) * left + fx * right;
  };
  return make_float4(lerp2(a.x, b.x, cc.x, d.x), lerp2(a.y, b.y, cc.y, d.y),
                     lerp2(a.z, b.z, cc.z, d.z), lerp2(a.w, b.w, cc.w, d.w));
}

// ===========================================================================
// fp32: scalar FMAs
// ===========================================================================

constexpr int kCiF = 8;  // input channels staged per step

struct DirectLoadF32 {  // conv1 input: the NHWC feature map, 4 channels
  const float* x;
  int H, W, C;
  __device__ float4 operator()(int n, int y, int xx, int c) const {
    return *reinterpret_cast<const float4*>(
        x + (((long long)n * H + y) * W + xx) * C + c);
  }
};

struct ResizeLoadF32 {  // conv2 input: the conv1 scratch resized on the fly
  const float* y1;
  int hh, wc, H, W;
  __device__ float4 operator()(int n, int y, int xx, int c) const {
    return resized4(y1, n, hh, wc, H, W, y, xx, c);
  }
};

struct StoreConv1F32 {  // conv1 epilogue: + b1 -> fp32 NHWC scratch
  float* y1;
  const float* b1;
  __device__ void operator()(int n, int y, int x0, int cg,
                             const float (&acc)[8][8], int H, int W) const {
    if (y >= H) return;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int x = x0 + p;
      if (x >= W) continue;
      float* dst = y1 + (((long long)n * H + y) * W + x) * kCo + cg * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = acc[p][j] + b1[cg * 8 + j];
    }
  }
};

struct HeadOutF32 {  // conv2 epilogue: + b2, ReLU, conv3 + b3 -> (n, 4, H*W)
  float* out;
  const float* b2;
  const float* w3;  // (128, 4)
  const float* b3;
  __device__ void operator()(int n, int y, int x0, int cg,
                             const float (&acc)[8][8], int H, int W) const {
    float part[8][kC3];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < kC3; ++c) part[p][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = cg * 8 + j;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float hv = fmaxf(acc[p][j] + b2[co], 0.f);
#pragma unroll
        for (int c = 0; c < kC3; ++c)
          part[p][c] = fmaf(hv, w3[co * kC3 + c], part[p][c]);
      }
    }
    // the 16 lanes with this pixel group hold the 16 channel groups
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < kC3; ++c)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          part[p][c] += __shfl_xor_sync(0xffffffffu, part[p][c], off);
    if (cg != 0 || y >= H) return;
    const long long hw = (long long)H * W;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int x = x0 + p;
      if (x >= W) continue;
#pragma unroll
      for (int c = 0; c < kC3; ++c)
        out[((long long)n * kC3 + c) * hw + (long long)y * W + x] =
            part[p][c] + b3[c];
    }
  }
};

// weights (9, Cin, 128) fp32; Cin % 8 == 0
template <typename Load, typename Epi>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(Load load, Epi epi, const float* __restrict__ w, int Cin,
                   int H, int W) {
  __shared__ float in_s[kCiF][kTH + 2][kTW + 2];
  __shared__ __align__(16) float w_s[9][kCiF][kCo];

  const int n = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int t = threadIdx.x;
  const int cg = t & 15;  // output channels cg*8 .. cg*8+7
  const int pg = t >> 4;  // pixel group: one row, 8 columns
  const int py = pg >> 1, px0 = (pg & 1) * 8;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiF) {
    for (int e = t; e < (kCiF / 4) * kHalo; e += kThreads) {
      const int c4 = (e % (kCiF / 4)) * 4;  // channels fastest: NHWC reads
      const int pix = e / (kCiF / 4);
      const int ty = pix / (kTW + 2), tx = pix % (kTW + 2);
      const int y = y0 - 1 + ty, x = x0 - 1 + tx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // zero padding outside
      if (y >= 0 && y < H && x >= 0 && x < W) v = load(n, y, x, ci0 + c4);
      in_s[c4][ty][tx] = v.x;
      in_s[c4 + 1][ty][tx] = v.y;
      in_s[c4 + 2][ty][tx] = v.z;
      in_s[c4 + 3][ty][tx] = v.w;
    }
    for (int e = t; e < 9 * kCiF * (kCo / 4); e += kThreads) {
      const int co4 = e % (kCo / 4);
      const int rest = e / (kCo / 4);
      const int ci = rest % kCiF, tap = rest / kCiF;
      reinterpret_cast<float4*>(&w_s[tap][ci][0])[co4] =
          reinterpret_cast<const float4*>(
              w + ((long long)tap * Cin + ci0 + ci) * kCo)[co4];
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ci = 0; ci < kCiF; ++ci) {
        const float4 wa = *reinterpret_cast<const float4*>(&w_s[tap][ci][cg * 8]);
        const float4 wb =
            *reinterpret_cast<const float4*>(&w_s[tap][ci][cg * 8 + 4]);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float xv = in_s[ci][py + ky][px0 + p + kx];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
        }
      }
    }
    __syncthreads();
  }
  epi(n, y0 + py, x0 + px0, cg, acc, H, W);
}

// ===========================================================================
// bf16: wgmma fed by TMA
// ===========================================================================

namespace hop {

using namespace fast3r_hopper;

constexpr int kRows = 4;                // output rows of a tile
constexpr int kCols = 64;               // output columns: one m64 slab a row
constexpr int kHaloRows = kRows + 2;    // 6
constexpr int kHaloCols = kCols + 2;    // 66
constexpr int kPitch = 72;              // halo pixels a row, a multiple of 8
constexpr int kHaloBytes = kHaloRows * kPitch * 128;  // 55,296 a stage
constexpr int kBBytes = kCo * 64 * 2;   // a tap's (128 out, 64 in) weights
// weight stages: conv2 gives its fourth to the coarse rows
template <int kMode>
constexpr int kBStages = kMode == 1 ? 4 : 3;
// conv2's window: the coarse rows and columns a tile's halo reads, at most
constexpr int kWinRows = 6, kWinCols = 40;
constexpr int kWinBytes = kWinRows * kWinCols * 128;
static_assert(kWinRows == kHaloRows, "the row pass writes a halo row a window row");
// the CTA: warpgroup 0 (the TMA producer's warp and, in conv2, three halo
// builders), the consumer warpgroups 1 and 2, and in conv2 a fourth
// warpgroup of halo builders (7 warps build, 8 multiply)
template <int kMode>
constexpr int kThreadsW = kMode == 1 ? 384 : 512;
constexpr int kXform = 224;             // conv2's halo builders
constexpr int kConsumerWarps = 8;
// setmaxnreg moves registers within the CTA's launch allocation (the
// __launch_bounds__ cap: 168 a thread at 384, 128 at 512): conv1 128 x 120
// + 256 x 192, conv2 256 x 64 + 256 x 192, all of it (conv2 at 80 / 176
// measured the same)
template <int kMode>
constexpr int kLowRegs = kMode == 1 ? 120 : 64;
template <int kMode>
constexpr int kHighRegs = 192;
static_assert(128 * kLowRegs<1> + 256 * kHighRegs<1> == kThreadsW<1> * 168 &&
                  256 * kLowRegs<2> + 256 * kHighRegs<2> == kThreadsW<2> * 128,
              "the warpgroups' registers must add up to the CTA's");

// one fine row's or column's taps for conv2's halo: lo and hi (coarse rows;
// coarse columns relative to the tile's window, absolute without one),
// frac, and whether it lies in the fine grid (zero padding outside)
struct Tap {
  int lo, hi;
  float f;
  int in;
};

template <int kMode>
struct Smem {
  char halo[2][kHaloBytes];  // 1024-byte aligned stages
  char b[kBStages<kMode>][kBBytes];
  // conv2: a K slice's coarse window, by TMA, and its halo rows at the
  // window's columns (conv1 has no use for them)
  char coarse[kMode == 1 ? 128 : kWinBytes];
  char win[kMode == 1 ? 128 : kWinBytes];
  Tap rtap[kHaloRows];       // conv2: the tile's halo rows' taps
  Tap ctap[kHaloCols];       // and its halo columns' taps
  float bias[kCo];           // b1 or b2
  float w3[kCo * kC3];       // conv2: (128, 4)
  float b3[kC3];
  uint64_t bfull[kBStages<kMode>], bempty[kBStages<kMode>];
  uint64_t hfull[2], hempty[2], cfull;
};
template <int kMode>
constexpr int kSmemBytes = sizeof(Smem<kMode>) + 1024;  // + alignment slack
static_assert(kSmemBytes<1> <= 232448 && kSmemBytes<2> <= 232448,
              "a CTA takes at most 227 KB of shared memory");

template <int kMode>
__device__ __forceinline__ Smem<kMode>& smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t off = smem_u32(smem_raw);
  return *reinterpret_cast<Smem<kMode>*>(smem_raw +
                                         ((1024u - (off & 1023u)) & 1023u));
}

struct Maps {
  CUtensorMap x;  // conv1: x (Cin, wc, hh, n), boxes (64, 72, 6, 1); conv2:
                  // conv1's output (128, wc, hh, n), boxes (64, 40, 6, 1)
  CUtensorMap w;  // the weights (9 * 128, Cin), boxes (64, 128)
};

struct Args {
  const bf16* y1;     // conv2: conv1's output (n, hh, wc, 128)
  bf16* y1_out;       // conv1: its output
  bf16* out;          // conv2: (n, 4, H * W)
  const float* bias;  // b1 or b2
  const float* w3;    // conv2: (128, 4)
  const float* b3;
  const int* tap_i;   // conv2: lo_y[H], hi_y[H], lo_x[W], hi_x[W]
  const float* tap_f; // conv2: frac_y[H], frac_x[W]
  int n, h, w;        // the output grid
  int hh, wc;         // conv2: the coarse grid
  int slices;         // K slices of 64 input channels
  int windowed;       // conv2: every tile's coarse columns fit kWinCols
};

struct Tile {
  int img, y0, x0;
};
// tile t of the walk, image-major, then row bands, then column bands
__device__ __forceinline__ Tile tile_of(int t, int ty, int tx) {
  const int per = ty * tx, r = t % per;
  return {t / per, (r / tx) * kRows, (r % tx) * kCols};
}

__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// ---------------------------------------------------------------------------
// warpgroup 0
// ---------------------------------------------------------------------------

// one thread: the halo boxes of x (conv1) and the weight slices, in the
// consumers' order
template <int kMode>
__device__ void produce(Smem<kMode>& s, const Maps& mp, const Args& a, int ty,
                        int tx, int T) {
  Ring<kBStages<kMode>> br;
  Ring<2> hr;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const Tile q = tile_of(t, ty, tx);
    for (int cs = 0; cs < a.slices; ++cs) {
      if constexpr (kMode == 1) {
        mbar_wait(&s.hempty[hr.stage], hr.phase ^ 1u);
        uint64_t* bar = &s.hfull[hr.stage];
        mbar_arrive_expect_tx(bar, kHaloBytes);
        tma_load(s.halo[hr.stage], &mp.x, bar, cs * 64, q.x0 - 1, q.y0 - 1,
                 q.img);
        hr.advance();
      }
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(&s.bempty[br.stage], br.phase ^ 1u);
        uint64_t* bar = &s.bfull[br.stage];
        mbar_arrive_expect_tx(bar, kBBytes);
        tma_load(s.b[br.stage], &mp.w, bar, cs * 64, tap * kCo);
        br.advance();
      }
    }
  }
}

// 8 channels of conv1's output at coarse pixel (r, c) of one image
__device__ __forceinline__ uint4 coarse8(const Args& a, int img, int r, int c,
                                         int ch) {
  return __ldg(reinterpret_cast<const uint4*>(
      a.y1 + (((long long)img * a.hh + r) * a.wc + c) * kCo + ch));
}

// fp32 (1 - f) p0 + f p1 on 8 channels, rounded to bf16 once
__device__ __forceinline__ uint4 lerp2(const uint4& p0, const uint4& p1,
                                       float f) {
  const uint32_t* u0 = reinterpret_cast<const uint32_t*>(&p0);
  const uint32_t* u1 = reinterpret_cast<const uint32_t*>(&p1);
  uint4 o;
  uint32_t* uo = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a0 = unpack_bf16(u0[e]), a1 = unpack_bf16(u1[e]);
    uo[e] = pack_bf16((1.f - f) * a0.x + f * a1.x, (1.f - f) * a0.y + f * a1.y);
  }
  return o;
}

// the same from four taps, rows first, rounded once (the road without a
// window)
__device__ __forceinline__ uint4 lerp4(const uint4& p00, const uint4& p01,
                                       const uint4& p10, const uint4& p11,
                                       float fy, float fx) {
  const uint32_t* u00 = reinterpret_cast<const uint32_t*>(&p00);
  const uint32_t* u01 = reinterpret_cast<const uint32_t*>(&p01);
  const uint32_t* u10 = reinterpret_cast<const uint32_t*>(&p10);
  const uint32_t* u11 = reinterpret_cast<const uint32_t*>(&p11);
  uint4 o;
  uint32_t* uo = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a00 = unpack_bf16(u00[e]), a01 = unpack_bf16(u01[e]);
    const float2 a10 = unpack_bf16(u10[e]), a11 = unpack_bf16(u11[e]);
    const float l0 = (1.f - fy) * a00.x + fy * a10.x;
    const float r0 = (1.f - fy) * a01.x + fy * a11.x;
    const float l1 = (1.f - fy) * a00.y + fy * a10.y;
    const float r1 = (1.f - fy) * a01.y + fy * a11.y;
    uo[e] = pack_bf16((1.f - fx) * l0 + fx * r0, (1.f - fx) * l1 + fx * r1);
  }
  return o;
}

// a tile's window: its first coarse row and column, and the number of
// coarse columns its halo reads
struct Win {
  int r0, c0, nc;
};
__device__ __forceinline__ Win window_of(const Args& a, const Tile& q) {
  const int* lo_y = a.tap_i;
  const int* lo_x = lo_y + 2 * a.h;
  const int* hi_x = lo_x + a.w;
  const int c0 = __ldg(lo_x + max(q.x0 - 1, 0));
  return {__ldg(lo_y + max(q.y0 - 1, 0)), c0,
          __ldg(hi_x + min(q.x0 + kCols, a.w - 1)) - c0 + 1};
}

// conv2's halo builders (warps 1-3 of warpgroup 0 and warpgroup 3, i = 0
// .. 223).  For each tile: the taps of its 6 halo rows and 66 halo columns
// into shared memory (once, relative to the tile's window); then for each
// K slice, where the tile's window fits (every head shape): its coarse
// rows and columns arrive by one TMA box (issued by builder 0 as soon as
// the last slice's row pass is done with the buffer); the row pass: the 6
// halo rows interpolated between their two coarse rows at each of the
// window's columns, rounded to bf16 (the plain version's first product and
// its rounding); the column pass: each halo pixel between its two window
// columns, rounded to bf16, into the halo stage, handed to the consumers
// through hfull.  Without a window (steep downscales) each halo pixel
// takes its four taps from device memory.
__device__ void build_halos(Smem<2>& s, const Maps& mp, const Args& a,
                            int ty, int tx, int T) {
  const int i = threadIdx.x < 128 ? threadIdx.x - 32 : threadIdx.x - 288;
  const int H = a.h, W = a.w;
  const int* lo_y = a.tap_i;
  const int* hi_y = lo_y + H;
  const int* lo_x = hi_y + H;
  const int* hi_x = lo_x + W;
  const float* f_y = a.tap_f;
  const float* f_x = f_y + H;
  // builder 0: the coarse box of slice cs of the tile at q
  auto fetch = [&](const Tile& q, int cs) {
    const Win w = window_of(a, q);
    mbar_arrive_expect_tx(&s.cfull, kWinBytes);
    tma_load(s.coarse, &mp.x, &s.cfull, cs * 64, w.c0, w.r0, q.img);
  };
  Ring<2> hr;
  unsigned cphase = 0;
  if (a.windowed && i == 0 && (int)blockIdx.x < T)
    fetch(tile_of(blockIdx.x, ty, tx), 0);
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const Tile q = tile_of(t, ty, tx);
    const Win w = a.windowed ? window_of(a, q) : Win{0, 0, 0};
    // (the last tile's readers of the taps and the window are past the
    // named barrier that closed its last slice)
    for (int e = i; e < kHaloRows + kHaloCols; e += kXform) {
      const bool row = e < kHaloRows;
      const int f = row ? q.y0 - 1 + e : q.x0 - 1 + (e - kHaloRows);
      Tap tp{0, 0, 0.f, f >= 0 && f < (row ? H : W)};
      if (tp.in) {
        const int base = row ? w.r0 : w.c0;
        tp.lo = __ldg((row ? lo_y : lo_x) + f) - base;
        tp.hi = __ldg((row ? hi_y : hi_x) + f) - base;
        tp.f = __ldg((row ? f_y : f_x) + f);
        if (a.windowed && tp.hi >= (row ? kWinRows : kWinCols))
          __trap();  // the host's plan
      }
      if (row)
        s.rtap[e] = tp;
      else
        s.ctap[e - kHaloRows] = tp;
    }
    named_sync(1, kXform);  // the taps are in place
    for (int cs = 0; cs < 2; ++cs) {
      if (a.windowed) {  // the row pass
        mbar_wait(&s.cfull, cphase);
        cphase ^= 1u;
#pragma unroll 2
        for (int e = i; e < kHaloRows * w.nc * 8; e += kXform) {
          const int hy = e / (w.nc * 8), c = (e >> 3) % w.nc, ch = e & 7;
          const Tap ry = s.rtap[hy];
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (ry.in) {
            const int p0 = ry.lo * kWinCols + c, p1 = ry.hi * kWinCols + c;
            v = lerp2(*reinterpret_cast<const uint4*>(
                          s.coarse + p0 * 128 + ((ch ^ (p0 & 7)) << 4)),
                      *reinterpret_cast<const uint4*>(
                          s.coarse + p1 * 128 + ((ch ^ (p1 & 7)) << 4)),
                      ry.f);
          }
          *reinterpret_cast<uint4*>(s.win + (hy * kWinCols + c) * 128 + ch * 16) = v;
        }
        named_sync(1, kXform);  // the window's rows are in place
        if (i == 0) {  // the next slice's coarse box, meanwhile
          if (cs == 0)
            fetch(q, 1);
          else if (t + (int)gridDim.x < T)
            fetch(tile_of(t + gridDim.x, ty, tx), 0);
        }
      }
      mbar_wait(&s.hempty[hr.stage], hr.phase ^ 1u);
      char* halo = s.halo[hr.stage];
      for (int u = i; u < kHaloCols * 8; u += kXform) {  // the column pass
        const int hx = u >> 3, ch = u & 7;
        const Tap cx = s.ctap[hx];
#pragma unroll 1
        for (int hy = 0; hy < kHaloRows; ++hy) {
          const Tap ry = s.rtap[hy];
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (cx.in && ry.in) {
            if (a.windowed) {
              const char* wp = s.win + hy * kWinCols * 128 + ch * 16;
              v = lerp2(*reinterpret_cast<const uint4*>(wp + cx.lo * 128),
                        *reinterpret_cast<const uint4*>(wp + cx.hi * 128), cx.f);
            } else {
              const int cc = cs * 64 + ch * 8;
              v = lerp4(coarse8(a, q.img, ry.lo, cx.lo, cc),
                        coarse8(a, q.img, ry.lo, cx.hi, cc),
                        coarse8(a, q.img, ry.hi, cx.lo, cc),
                        coarse8(a, q.img, ry.hi, cx.hi, cc), ry.f, cx.f);
            }
          }
          const int p = hy * kPitch + hx;
          *reinterpret_cast<uint4*>(halo + p * 128 + ((ch ^ (p & 7)) << 4)) = v;
        }
      }
      fence_proxy_async_smem();  // the stores, before wgmma reads them
      mbar_arrive(&s.hfull[hr.stage]);
      hr.advance();
      named_sync(1, kXform);  // the window is free again
    }
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// a consumer thread: acc0 / acc1 = output rows 2 wg and 2 wg + 1 of the
// tile (64 pixels each) x 128 channels over the tile's K slices; rows
// 16 warp + g and + 8 of each, columns 8 j + 2 c + {0, 1} in
// acc[4 j + {0, 1}] and acc[4 j + {2, 3}]
template <int kMode>
__device__ __forceinline__ void mainloop(float (&acc0)[64], float (&acc1)[64],
                                         Smem<kMode>& s,
                                         Ring<kBStages<kMode>>& br,
                                         Ring<2>& hr, int slices, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  int prev_b = 0, prev_h = 0, kt = 0;
  for (int cs = 0; cs < slices; ++cs) {
    const int hs = hr.stage;
    mbar_wait(&s.hfull[hs], hr.phase);
    const char* halo = s.halo[hs];
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int st = br.stage, ky = tap / 3, kx = tap % 3;
      mbar_wait(&s.bfull[st], br.phase);
      const uint64_t da0 = desc_sw128(halo + ((2 * wg + ky) * kPitch + kx) * 128);
      const uint64_t da1 =
          desc_sw128(halo + ((2 * wg + 1 + ky) * kPitch + kx) * 128);
      const uint64_t db = desc_sw128(s.b[st]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // scale_d 0: the tile's first step
        const int sc = (kt == 0 && j == 0) ? 0 : 1;
        wgmma_ss_n128(acc0, da0 + 2 * j, db + 2 * j, sc);
        wgmma_ss_n128(acc1, da1 + 2 * j, db + 2 * j, sc);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the step before has retired: its stages are free
      if (kt > 0) release(&s.bempty[prev_b]);
      if (tap == 0 && cs > 0) release(&s.hempty[prev_h]);
      prev_b = st;
      br.advance();
      ++kt;
    }
    prev_h = hs;
    hr.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  release(&s.bempty[prev_b]);
  release(&s.hempty[prev_h]);
}

// conv1: + b1, bf16 NHWC stores of one output row's 64 pixels
__device__ __forceinline__ void store_conv1(const float (&acc)[64],
                                            const Smem<1>& s, const Args& a,
                                            int img, int y, int x0, int warp,
                                            int lane) {
  if (y >= a.h) return;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 16 * warp + g + 8 * half;
    if (x >= a.w) continue;
    bf16* dst = a.y1_out + (((long long)img * a.h + y) * a.w + x) * kCo;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * c;
      *reinterpret_cast<uint32_t*>(dst + col) =
          pack_bf16(acc[4 * j + 2 * half] + s.bias[col],
                    acc[4 * j + 2 * half + 1] + s.bias[col + 1]);
    }
  }
}

// conv2: + b2, ReLU, conv3 + b3 over the 128 channels of one output row's
// 64 pixels; lane c of each quad stores output channel c
__device__ __forceinline__ void store_head(const float (&acc)[64],
                                           const Smem<2>& s, const Args& a,
                                           int img, int y, int x0, int warp,
                                           int lane) {
  const int g = lane >> 2, c = lane & 3;
  float p[2][kC3];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int k = 0; k < kC3; ++k) p[half][k] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // the column group's b2 and w3 are read here, not hoisted above the
    // earlier groups: with both rows' accumulators live, hoisted they
    // spilled
    asm volatile("" ::: "memory");
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * c + e;
      const float b = s.bias[col];
      const float4 w = *reinterpret_cast<const float4*>(&s.w3[col * kC3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float h = fmaxf(acc[4 * j + 2 * half + e] + b, 0.f);
        p[half][0] = fmaf(h, w.x, p[half][0]);
        p[half][1] = fmaf(h, w.y, p[half][1]);
        p[half][2] = fmaf(h, w.z, p[half][2]);
        p[half][3] = fmaf(h, w.w, p[half][3]);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int k = 0; k < kC3; ++k) {
      p[half][k] += __shfl_xor_sync(0xffffffffu, p[half][k], 1);
      p[half][k] += __shfl_xor_sync(0xffffffffu, p[half][k], 2);
    }
  if (y >= a.h) return;
  const long long hw = (long long)a.h * a.w;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 16 * warp + g + 8 * half;
    if (x >= a.w) continue;
    const float v = c == 0 ? p[half][0] : c == 1 ? p[half][1]
                  : c == 2 ? p[half][2] : p[half][3];
    a.out[((long long)img * kC3 + c) * hw + (long long)y * a.w + x] =
        __float2bfloat16(v + s.b3[c]);
  }
}

template <int kMode>  // 1: conv1, 2: conv2 (+ resize, ReLU, conv3)
__global__ void __launch_bounds__(kThreadsW<kMode>, 1)
trunk_conv_kernel(const __grid_constant__ Maps mp, const Args a) {
  constexpr int kThreads = kThreadsW<kMode>;
  Smem<kMode>& s = smem<kMode>();
  if (threadIdx.x == 0) {
    mbar_init(&s.cfull, 1);
    for (int i = 0; i < kBStages<kMode>; ++i) {
      mbar_init(&s.bfull[i], 1);
      mbar_init(&s.bempty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.hfull[i], kMode == 1 ? 1 : kXform);
      mbar_init(&s.hempty[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < kCo; i += kThreads) s.bias[i] = a.bias[i];
  if constexpr (kMode == 2) {
    for (int i = threadIdx.x; i < kCo * kC3; i += kThreads) s.w3[i] = a.w3[i];
    if (threadIdx.x < kC3) s.b3[threadIdx.x] = a.b3[threadIdx.x];
  }
  __syncthreads();

  const int tx = (a.w + kCols - 1) / kCols, ty = (a.h + kRows - 1) / kRows;
  const int T = a.n * ty * tx;
  if (threadIdx.x < 128 || threadIdx.x >= 384) {  // warpgroups 0 and 3
    regs_dec<kLowRegs<kMode>>();
    if (threadIdx.x == 0) {
      produce<kMode>(s, mp, a, ty, tx, T);
    } else if constexpr (kMode == 2) {
      if (threadIdx.x >= 32) build_halos(s, mp, a, ty, tx, T);
    }
  } else {  // consumer warpgroups
    regs_inc<kHighRegs<kMode>>();
    const int wg = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    Ring<kBStages<kMode>> br;
    Ring<2> hr;
    float acc0[64], acc1[64];
    for (int t = blockIdx.x; t < T; t += gridDim.x) {
      const Tile q = tile_of(t, ty, tx);
      mainloop(acc0, acc1, s, br, hr, a.slices, wg);
      const int y = q.y0 + 2 * wg;
      if constexpr (kMode == 1) {
        store_conv1(acc0, s, a, q.img, y, q.x0, warp, lane);
        store_conv1(acc1, s, a, q.img, y + 1, q.x0, warp, lane);
      } else {
        store_head(acc0, s, a, q.img, y, q.x0, warp, lane);
        store_head(acc1, s, a, q.img, y + 1, q.x0, warp, lane);
      }
    }
  }
}

template <int kMode>
cudaError_t launch(const Maps& mp, const Args& a, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        trunk_conv_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes<kMode>);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long T = (long long)a.n * ((a.h + kRows - 1) / kRows) *
                      ((a.w + kCols - 1) / kCols);
  if (T == 0) return cudaSuccess;
  if (T >= (1LL << 31)) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  trunk_conv_kernel<kMode>
      <<<(int)(T < sms ? T : sms), kThreadsW<kMode>, kSmemBytes<kMode>, st>>>(
          mp, a);
  return cudaGetLastError();
}

}  // namespace hop

}  // namespace

extern "C" {

// the dynamic shared memory of a trunk_conv_kernel<mode> CTA
int fast3r_trunk_smem_bytes(int mode) {
  return mode == 1 ? hop::kSmemBytes<1> : hop::kSmemBytes<2>;
}

// dtype 0 (float32): x, out fp32; w1 (9, cin, 128), w2 (9, 128, 128) fp32,
//   tap-major, input channel, output channel; cin % 8 == 0; y1 an fp32
//   (n, hh, wc, 128) scratch; tap_i, tap_f, windowed unused.
// dtype 1 (bfloat16): x, out bf16; w1 (9, 128, cin), w2 (9, 128, 128) bf16,
//   tap-major, output channel, input channel; cin % 16 == 0; y1 a bf16
//   (n, hh, wc, 128) scratch; tap_i the int32 tap tables lo_y[H], hi_y[H],
//   lo_x[W], hi_x[W] and tap_f the fp32 fracs frac_y[H], frac_x[W] of
//   ops/resize._interp_taps; windowed 1 when every tile's coarse window
//   columns fit its kWinCols (ops/trunk_kernel.trunk_plan).
// b1, b2 (128,), w3 (128, 4), b3 (4,) fp32.  Returns cudaGetLastError().
int fast3r_trunk_head_fwd(int dtype, const void* x, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* w3, const void* b3, void* y1, void* out,
                          const void* tap_i, const void* tap_f, int windowed,
                          int n, int hh, int wc, int cin, int H, int W,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (n <= 0) return cudaSuccess;
  if (dtype == 0) {
    float* y1f = static_cast<float*>(y1);
    if (cin % kCiF) return cudaErrorInvalidValue;
    const dim3 g1((wc + kTW - 1) / kTW, (hh + kTH - 1) / kTH, n);
    conv3x3_f32_kernel<<<g1, kThreads, 0, st>>>(
        DirectLoadF32{f(x), hh, wc, cin}, StoreConv1F32{y1f, f(b1)}, f(w1),
        cin, hh, wc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 g2((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, n);
    conv3x3_f32_kernel<<<g2, kThreads, 0, st>>>(
        ResizeLoadF32{y1f, hh, wc, H, W},
        HeadOutF32{static_cast<float*>(out), f(b2), f(w3), f(b3)}, f(w2), kCo,
        H, W);
    return cudaGetLastError();
  }
  if (dtype != 1 || cin % 16 || cin <= 0) return cudaErrorInvalidValue;
  hop::Maps m1, m2;
  const long long dims[4] = {cin, wc, hh, n};
  const long long strides[3] = {cin, (long long)wc * cin,
                                (long long)hh * wc * cin};
  const int box[4] = {64, hop::kPitch, hop::kHaloRows, 1};
  cudaError_t err;
  using fast3r_hopper::make_tmap;
  if ((err = fast3r_hopper::make_tmap_box(&m1.x, x, 4, dims, strides, box)) !=
          cudaSuccess ||
      (err = make_tmap(&m1.w, w1, 9 * kCo, cin, cin, kCo)) != cudaSuccess ||
      (err = make_tmap(&m2.w, w2, 9 * kCo, kCo, kCo, kCo)) != cudaSuccess)
    return err;
  const long long ydims[4] = {kCo, wc, hh, n};
  const long long ystrides[3] = {kCo, (long long)wc * kCo,
                                 (long long)hh * wc * kCo};
  const int ybox[4] = {64, hop::kWinCols, hop::kWinRows, 1};
  if ((err = fast3r_hopper::make_tmap_box(&m2.x, y1, 4, ydims, ystrides,
                                          ybox)) != cudaSuccess)
    return err;
  hop::Args a{};
  a.y1_out = static_cast<bf16*>(y1);
  a.bias = f(b1);
  a.n = n;
  a.h = hh;
  a.w = wc;
  a.slices = (cin + 63) / 64;
  if ((err = hop::launch<1>(m1, a, st)) != cudaSuccess) return err;
  a.y1 = static_cast<const bf16*>(y1);
  a.y1_out = nullptr;
  a.out = static_cast<bf16*>(out);
  a.bias = f(b2);
  a.w3 = f(w3);
  a.b3 = f(b3);
  a.tap_i = static_cast<const int*>(tap_i);
  a.tap_f = f(tap_f);
  a.h = H;
  a.w = W;
  a.hh = hh;
  a.wc = wc;
  a.slices = 2;
  a.windowed = windowed;
  return hop::launch<2>(m2, a, st);
}

}  // extern "C"
