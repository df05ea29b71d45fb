// DPT regression-head trunk for the port:
//   conv1 3x3 pad 1 (Cin -> 128, + b1) on the half-resolution grid
//   -> align-corners bilinear resize to the (H, W) image grid
//   -> conv2 3x3 pad 1 (128 -> 128, + b2) -> ReLU -> 1x1 conv3 (128 -> 4, + b3)
// input NHWC (n, hh, wc, Cin); output channel-major (n, 4, H * W), the layout
// ops/postprocess.postprocess_transposed consumes.
//
// Replaces the TPU kernel fast3r_tpu/ops/trunk_kernel.py (_trunk_kern, as
// called by fused_regression_head_t).
//
// What bounds it on an H100: FLOPs.  conv2 on the full-resolution grid is
// 9 * 128 * 128 * 2 FLOPs per pixel (29 GFLOP per 384x512 image), ten times
// conv1, while the bytes are a few tens of MB per image.  Design: a short
// chain of two launches of one implicit-GEMM conv (M = pixels, N = 128
// output channels, K = 9 taps x input channels):
//   * one block = an 8 x 16 tile of output pixels x all 128 output channels;
//   * input channels stream through shared memory a chunk at a time: the
//     (8 + 2) x (16 + 2) halo tile and the matching 3 x 3 x chunk x 128
//     weights;
//   * launch 1 writes conv1 (+ b1) to an fp32 scratch in device memory;
//   * launch 2 builds each conv2 input tile on the fly from that scratch with
//     the align-corners taps (the resized 128-channel map is never stored),
//     zero outside the fine grid (conv2's padding), and folds bias, ReLU and
//     the 1x1 conv3 into its epilogue, reducing the channel partial sums
//     across lanes with shuffles.
// bf16 (the served type) runs on the tensor cores: 8 warps, each a 32-pixel
// x 64-channel tile of mma.sync m16n8k16 products with fp32 accumulators,
// operands fetched with ldmatrix from 16-channel chunks (the conv2 input is
// rounded to bf16 when staged, as the plain version rounds the resize).
// fp32 (used to check the kernel tightly) runs scalar FMAs: 256 threads,
// each an 8-pixel x 8-channel register tile, 8-channel chunks.  Accumulation
// is fp32 throughout; the final (n, 4, H * W) map is rounded to the input
// dtype.  Not yet: wgmma, TMA, pipelined staging, conv1 kept on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: tensor cores
// ===========================================================================

constexpr int kKc = 16;   // input channels per staged chunk: one k16 per tap
constexpr int kLdc = 24;  // padded smem row (bf16): 48 B, ldmatrix conflict-free
constexpr int kMmaSmem =
    (9 * kCo + kHalo) * kLdc * (int)sizeof(bf16) + 2 * kTH * kTW * kC3 * 4;

// halo position of staged pixel `pix` and whether it lies inside the grid
__device__ inline bool halo_pixel(int pix, int y0, int x0, int H, int W,
                                  int& y, int& x) {
  y = y0 - 1 + pix / (kTW + 2);
  x = x0 - 1 + pix % (kTW + 2);
  return y >= 0 && y < H && x >= 0 && x < W;
}

struct DirectStage {  // conv1 input: bf16 NHWC feature map, 16 channels
  const bf16* x;
  int H, W, C;
  __device__ void operator()(bf16* halo, int n, int y0, int x0, int ci0) const {
    for (int e = threadIdx.x; e < kHalo * 2; e += kThreads) {
      const int pix = e >> 1, half = e & 1;
      int y, xx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (halo_pixel(pix, y0, x0, H, W, y, xx))
        v = *reinterpret_cast<const uint4*>(
            x + (((long long)n * H + y) * W + xx) * C + ci0 + half * 8);
      *reinterpret_cast<uint4*>(halo + pix * kLdc + half * 8) = v;
    }
  }
};

struct ResizeStage {  // conv2 input: conv1 scratch resized, rounded to bf16
  const float* y1;
  int hh, wc, H, W;
  __device__ void operator()(bf16* halo, int n, int y0, int x0, int ci0) const {
    for (int e = threadIdx.x; e < kHalo * 4; e += kThreads) {
      const int pix = e >> 2, c4 = (e & 3) * 4;
      int y, xx;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (halo_pixel(pix, y0, x0, H, W, y, xx))
        r = resized4(y1, n, hh, wc, H, W, y, xx, ci0 + c4);
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(halo + pix * kLdc + c4);
      dst[0] = __floats2bfloat162_rn(r.x, r.y);
      dst[1] = __floats2bfloat162_rn(r.z, r.w);
    }
  }
};

// mma accumulators of one thread: acc[mt][nt][e] is output pixel
// (tile row wm*2 + mt, tile column g + 8*(e/2)) and output channel
// wn*64 + nt*8 + 2c + e%2
struct MmaPos {
  int wm, wn, g, c;
};

struct StoreConv1Mma {  // conv1 epilogue: + b1 -> fp32 NHWC scratch
  float* y1;
  const float* b1;
  __device__ void operator()(int n, int y0, int x0, const float (&acc)[2][8][4],
                             MmaPos q, float*, int H, int W) const {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int y = y0 + q.wm * 2 + mt, x = x0 + q.g + half * 8;
        if (y >= H || x >= W) continue;
        float* dst = y1 + (((long long)n * H + y) * W + x) * kCo;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int co = q.wn * 64 + nt * 8 + 2 * q.c;
          *reinterpret_cast<float2*>(dst + co) =
              make_float2(acc[mt][nt][half * 2] + b1[co],
                          acc[mt][nt][half * 2 + 1] + b1[co + 1]);
        }
      }
    }
  }
};

struct HeadOutMma {  // conv2 epilogue: + b2, ReLU, conv3 + b3 -> (n, 4, H*W)
  bf16* out;
  const float* b2;
  const float* w3;  // (128, 4)
  const float* b3;
  __device__ void operator()(int n, int y0, int x0, const float (&acc)[2][8][4],
                             MmaPos q, float* red, int H, int W) const {
    float part[2][2][kC3];  // [mt][half][c3]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c3 = 0; c3 < kC3; ++c3) part[mt][half][c3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = q.wn * 64 + nt * 8 + 2 * q.c + e;
        const float bias = b2[co];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float hv = fmaxf(acc[mt][nt][half * 2 + e] + bias, 0.f);
#pragma unroll
            for (int c3 = 0; c3 < kC3; ++c3)
              part[mt][half][c3] = fmaf(hv, w3[co * kC3 + c3], part[mt][half][c3]);
          }
      }
    }
    // the quad (c = 0..3) shares the pixels; the two wn warps meet in smem
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c3 = 0; c3 < kC3; ++c3) {
          float v = part[mt][half][c3];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          part[mt][half][c3] = v;
        }
    if (q.c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = (q.wm * 2 + mt) * kTW + q.g + half * 8;
#pragma unroll
          for (int c3 = 0; c3 < kC3; ++c3)
            red[(q.wn * kTH * kTW + pix) * kC3 + c3] = part[mt][half][c3];
        }
    }
    __syncthreads();
    const int pix = threadIdx.x;
    if (pix < kTH * kTW) {
      const int y = y0 + pix / kTW, x = x0 + pix % kTW;
      if (y < H && x < W) {
        const long long hw = (long long)H * W;
#pragma unroll
        for (int c3 = 0; c3 < kC3; ++c3)
          out[((long long)n * kC3 + c3) * hw + (long long)y * W + x] =
              __float2bfloat16(red[pix * kC3 + c3] +
                               red[(kTH * kTW + pix) * kC3 + c3] + b3[c3]);
      }
    }
  }
};

// weights (9, 128, Cin) bf16 (tap, out channel, in channel); Cin % 16 == 0
template <typename Stage, typename Epi>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(Stage stage, Epi epi, const bf16* __restrict__ w, int Cin,
                   int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [9 * 128][kLdc]
  bf16* halo = w_s + 9 * kCo * kLdc;           // [kHalo][kLdc]
  float* red = reinterpret_cast<float*>(halo + kHalo * kLdc);

  const int n = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const MmaPos q{warp & 3, warp >> 2, lane >> 2, lane & 3};

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kKc) {
    stage(halo, n, y0, x0, ci0);
    for (int e = threadIdx.x; e < 9 * kCo * 2; e += kThreads) {
      const int row = e >> 1, half = e & 1;  // row = tap * 128 + co
      *reinterpret_cast<uint4*>(w_s + row * kLdc + half * 8) =
          *reinterpret_cast<const uint4*>(w + (long long)row * Cin + ci0 + half * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t af[2][4];  // A: 16 pixels of one tile row x 16 channels
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int col = (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[mt], halo + ((q.wm * 2 + mt + ky) * (kTW + 2) + col + kx) * kLdc +
                                (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bfr[4];  // B: b0, b1 of n-tiles nt and nt + 1
        const int co = q.wn * 64 + nt * 8 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bfr, w_s + (tap * kCo + co) * kLdc + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][nt], af[mt], bfr[0], bfr[1]);
          mma16816(acc[mt][nt + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
  epi(n, y0, x0, acc, q, red, H, W);
}

template <typename Stage, typename Epi>
cudaError_t launch_mma(Stage stage, Epi epi, const bf16* w, int cin, int n,
                       int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_mma_kernel<Stage, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, n);
  conv3x3_mma_kernel<<<grid, kThreads, kMmaSmem, stream>>>(stage, epi, w, cin,
                                                          H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 (float32): x, out fp32; w1 (9, cin, 128), w2 (9, 128, 128) fp32,
//   tap-major, input channel, output channel; cin % 8 == 0.
// dtype 1 (bfloat16): x, out bf16; w1 (9, 128, cin), w2 (9, 128, 128) bf16,
//   tap-major, output channel, input channel; cin % 16 == 0.
// b1, b2 (128,), w3 (128, 4), b3 (4,) fp32; y1 an fp32 (n, hh, wc, 128)
// scratch.  Returns cudaGetLastError().
int fast3r_trunk_head_fwd(int dtype, const void* x, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* w3, const void* b3, void* y1, void* out,
                          int n, int hh, int wc, int cin, int H, int W,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* y1f = static_cast<float*>(y1);
  if (dtype == 0) {
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
  if (dtype == 1) {
    if (cin % kKc) return cudaErrorInvalidValue;
    auto b = [](const void* p) { return static_cast<const bf16*>(p); };
    cudaError_t err = launch_mma(DirectStage{b(x), hh, wc, cin},
                                 StoreConv1Mma{y1f, f(b1)}, b(w1), cin, n, hh,
                                 wc, st);
    if (err != cudaSuccess) return err;
    return launch_mma(ResizeStage{y1f, hh, wc, H, W},
                      HeadOutMma{static_cast<bf16*>(out), f(b2), f(w3), f(b3)},
                      b(w2), kCo, n, H, W, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
