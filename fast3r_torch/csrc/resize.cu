// Align-corners bilinear resize for the port (K12): bf16 NCHW
// (B, C, h, w) -> (B, C, H, W), the regression trunk's full-resolution
// upsample on the DPT head's unfused road.
//
// Replaces the TPU kernel fast3r_tpu/ops/resize_kernel.py (_resize_kern, as
// called by resize_bilinear_kernel).  The TPU kernel streams row windows of
// an NHWC image through a VMEM ring and runs the H pass as an MXU matmul;
// here the layout is the port's NCHW (the head's convolutions are NCHW) and
// every output pixel is computed from its four inputs directly.
//
// What bounds it on an H100: bytes.  Each output reads four inputs (two rows
// of the H pass times two columns of the W pass) and does four multiply-adds,
// so the input read once and the output written once, over 3.35 TB/s, is the
// least time: 84 MB, about 25 us, for (1, 128, 256, 256) -> (512, 512).
// Design: one thread per group of 8 output columns of one output row; the
// input taps are re-read through L1 / L2 (a 2x upscale touches each input
// pixel from about four threads of a warp), and the 8 outputs leave as one
// 16-byte store.
//
// Rounding points, those of ops/resize.resize_matmul (two products with the
// interpolation matrices rounded to bf16):
//   * the tap weights are rounded to bf16 (resize_kernel.py:208, :264);
//   * the H pass sums its two taps in fp32 and rounds once to bf16
//     (resize_kernel.py:189-193);
//   * the W pass sums its two taps in fp32 and rounds once.  The TPU kernel's
//     W pass is a bf16 lerp that rounds after each operation
//     (resize_kernel.py:201-209); one bf16 step bounds the difference.
// The taps come from ops/resize._interp_taps, built on the host as int32
// lo / hi and fp32 frac tables (the TPU kernel's row plan rides in SMEM the
// same way); no floor is recomputed on the device.  Not yet: staging a
// row band in shared memory, wider groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCols = 8;  // output columns per thread: one 16-byte store
constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the two weights of one output index, as ops/resize._interp_matrix holds
// them before the bf16 cast: (1 - frac, frac), or their sum on one tap
__device__ __forceinline__ void tap_weights(int lo, int hi, float fr,
                                            float& w_lo, float& w_hi) {
  if (lo == hi) {
    w_lo = round_bf16((1.f - fr) + fr);
    w_hi = 0.f;
  } else {
    w_lo = round_bf16(1.f - fr);
    w_hi = round_bf16(fr);
  }
}

__global__ void __launch_bounds__(kThreads)
resize_bilinear_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                       const int* __restrict__ lo_h,
                       const int* __restrict__ hi_h,
                       const float* __restrict__ fr_h,
                       const int* __restrict__ lo_w,
                       const int* __restrict__ hi_w,
                       const float* __restrict__ fr_w, long long planes,
                       int h, int w, int H, int W) {
  const int groups = (W + kCols - 1) / kCols;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= planes * H * groups) return;
  const int g = static_cast<int>(t % groups);
  const long long row = t / groups;  // plane * H + output row
  const int i = static_cast<int>(row % H);
  const long long plane = row / H;

  float a_h, b_h;
  tap_weights(lo_h[i], hi_h[i], fr_h[i], a_h, b_h);
  const bf16* r0 = x + (plane * h + lo_h[i]) * w;
  const bf16* r1 = x + (plane * h + hi_h[i]) * w;

  const int j0 = g * kCols;
  __align__(16) bf16 v[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = min(j0 + k, W - 1);
    const int c0 = lo_w[j], c1 = hi_w[j];
    float a_w, b_w;
    tap_weights(c0, c1, fr_w[j], a_w, b_w);
    const float y0 = round_bf16(a_h * __bfloat162float(r0[c0]) +
                                b_h * __bfloat162float(r1[c0]));
    const float y1 = round_bf16(a_h * __bfloat162float(r0[c1]) +
                                b_h * __bfloat162float(r1[c1]));
    v[k] = __float2bfloat16_rn(a_w * y0 + b_w * y1);
  }
  bf16* o = out + row * W + j0;
  if (W % kCols == 0) {
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
  } else {
    for (int k = 0; k < kCols && j0 + k < W; ++k) o[k] = v[k];
  }
}

}  // namespace

extern "C" {

// x (planes, h, w) and out (planes, H, W) bf16, contiguous; lo_h, hi_h
// (H,) int32 and fr_h (H,) fp32 the H-pass taps, lo_w, hi_w, fr_w (W,) the
// W-pass taps (ops/resize._interp_taps).  Returns cudaGetLastError().
int fast3r_resize_bilinear(const void* x, void* out, const void* lo_h,
                           const void* hi_h, const void* fr_h,
                           const void* lo_w, const void* hi_w,
                           const void* fr_w, long long planes, int h, int w,
                           int H, int W, void* stream) {
  const long long threads = planes * H * ((W + kCols - 1) / kCols);
  if (threads == 0) return cudaSuccess;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  resize_bilinear_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const int*>(lo_h), static_cast<const int*>(hi_h),
      static_cast<const float*>(fr_h), static_cast<const int*>(lo_w),
      static_cast<const int*>(hi_w), static_cast<const float*>(fr_w), planes,
      h, w, H, W);
  return cudaGetLastError();
}

}  // extern "C"
