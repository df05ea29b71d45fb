// Align-corners bilinear resize for the port (K12): bf16 NCHW
// (B, C, h, w) -> (B, C, H, W), the regression trunk's full-resolution
// upsample on the DPT head's unfused road.
//
// Replaces the TPU kernel fast3r_tpu/ops/resize_kernel.py (_resize_kern, as
// called by resize_bilinear_kernel).  The TPU kernel streams row windows of
// an NHWC image through a VMEM ring and runs the H pass as an MXU matmul;
// here the layout is the port's NCHW (the head's convolutions are NCHW).
//
// What bounds it on an H100: bytes.  Each output is two 2-tap lerps, so the
// input read once and the output written once, over 3.35 TB/s, is the least
// time: on the 512x512 request's head, (20, 128, 256, 256) -> (512, 512),
// 0.336 GB read and 1.342 GB written, 0.501 ms; four fifths of it the
// writes.  The kernel this one replaced took 5.4x that: per 8 outputs a
// thread made 32 scalar 2-byte gathers and 27 reads of the tap tables,
// computed each H-pass value twice and ran 64-bit divisions.
//
// Design: persistent CTAs walk items, an item being a band of output rows
// (and, where the rows are too wide for shared memory, of output columns) of
// one plane; the plan (the bands, the rows staged per item, the shared
// memory) is made on the host by ops/resize_kernel.band_plan.
//   * Staged input: an item's input rows, lo_h[first] .. hi_h[last], arrive
//     in a ring of shared-memory stages by 1-D bulk copies (cp.async.bulk,
//     one per row, on an mbarrier), issued by one thread as soon as the
//     stage is free, so the next items' rows load while this one computes.
//     Rows whose bytes are not a multiple of 16 are copied by all threads,
//     2 bytes at a time, into a single stage before the item.
//   * H pass: each (output row, input column) value once, from shared
//     memory, a warp on two output rows at a time, 8 columns a lane with
//     16-byte reads and writes, into a double-buffered H buffer in shared
//     memory.
//   * W pass: 8 outputs a thread from the H buffer through the column taps,
//     which sit in shared memory for the CTA's life (and, where a thread
//     keeps its 8 columns from task to task, in its registers); one 16-byte
//     store.
//   * One __syncthreads an item (after the H pass); 32-bit index math
//     inside an item.
//
// Rounding points, those of ops/resize.resize_matmul (two products with the
// interpolation matrices rounded to bf16), and the expressions of the
// kernel this one replaced, so its outputs are bitwise that kernel's:
//   * the tap weights are rounded to bf16 (resize_kernel.py:208, :264);
//   * the H pass sums its two taps in fp32 and rounds once to bf16
//     (resize_kernel.py:189-193);
//   * the W pass sums its two taps in fp32 and rounds once.  The TPU kernel's
//     W pass is a bf16 lerp that rounds after each operation
//     (resize_kernel.py:201-209); one bf16 step bounds the difference.
// The taps come from ops/resize._interp_taps, built on the host as int32
// lo / hi and fp32 frac tables (the TPU kernel's row plan rides in SMEM the
// same way); no floor is recomputed on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = fast3r_hopper;

constexpr int kCols = 8;  // columns per thread and task: 16 bytes
constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 64;  // the stages' mbarriers, ahead of the taps

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

// a column tap in shared memory: lo, hi - lo (0 or 1) in bit 31, and the
// two bf16 weights
struct Tap {
  uint32_t lo_d;
  __nv_bfloat162 w;
};

struct Plan {
  int planes, h, w, H, W;
  int rows;        // output rows per band (R)
  int cols;        // output columns per column band (a multiple of 8, or W)
  int row_bands, col_bands;
  int stage_rows;  // input rows a stage holds
  int pitch;       // elements per staged input row and per H-buffer row
  int stages;
  int items;
};

// 8 bf16 values of a 16-byte word, as fp32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                       const int* __restrict__ lo_h,
                       const int* __restrict__ hi_h,
                       const float* __restrict__ fr_h,
                       const int* __restrict__ lo_w,
                       const int* __restrict__ hi_w,
                       const float* __restrict__ fr_w, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int cols8 = (p.cols + kCols - 1) / kCols * kCols;
  Tap* taps = reinterpret_cast<Tap*>(smem + kBarBytes);
  bf16* stage0 = reinterpret_cast<bf16*>(smem + kBarBytes + cols8 * sizeof(Tap));
  const int stage_elems = p.stage_rows * p.pitch;
  bf16* hbuf0 = stage0 + p.stages * stage_elems;
  const int hbuf_elems = p.rows * p.pitch;
  const int tid = threadIdx.x;

  // the item's geometry: plane, output rows [i0, i1), output columns
  // [j0, j1), staged input rows from r0, staged input columns [c0, c0 + span)
  struct Item {
    int plane, i0, i1, j0, j1, r0, nrows, c0, span;
  };
  auto item_at = [&](int it) {
    Item m;
    const int cb = it % p.col_bands;
    const int t = it / p.col_bands;
    const int rb = t % p.row_bands;
    m.plane = t / p.row_bands;
    m.i0 = rb * p.rows;
    m.i1 = min(m.i0 + p.rows, p.H);
    m.j0 = cb * p.cols;
    m.j1 = min(m.j0 + p.cols, p.W);
    m.r0 = lo_h[m.i0];
    m.nrows = hi_h[m.i1 - 1] - m.r0 + 1;
    const int c_lo = lo_w[m.j0], c_hi = hi_w[m.j1 - 1];
    if (kBulk) {  // 16-byte aligned copies: w is a multiple of 8
      m.c0 = c_lo & ~(kCols - 1);
      m.span = min(p.w, (c_hi + kCols) & ~(kCols - 1)) - m.c0;
    } else {
      m.c0 = c_lo;
      m.span = c_hi - c_lo + 1;
    }
    return m;
  };
  auto plane_in = [&](const Item& m) {
    return x + static_cast<size_t>(m.plane) * p.h * p.w;
  };
  // bulk road: thread 0 starts item `it`'s copies into stage s
  auto issue = [&](int it, int s) {
    const Item m = item_at(it);
    const bf16* src = plane_in(m) + static_cast<size_t>(m.r0) * p.w + m.c0;
    bf16* dst = stage0 + s * stage_elems;
    const unsigned row_bytes = m.span * sizeof(bf16);
    hp::mbar_arrive_expect_tx(&full[s], row_bytes * m.nrows);
    for (int r = 0; r < m.nrows; ++r)
      hp::bulk_load(dst + r * p.pitch, src + static_cast<size_t>(r) * p.w,
                    row_bytes, &full[s]);
  };

  int k = 0;  // this CTA's items so far
  int it = blockIdx.x;
  if (kBulk && tid == 0) {
    for (int s = 0; s < p.stages; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_init_fence();
    for (int s = 0; s < p.stages && it + s * gridDim.x < p.items; ++s)
      issue(it + s * gridDim.x, s);
  }
  int tap_band = -1;  // the column band whose taps are in shared memory
  int cached_col = -1;  // the first output column of this thread's taps
  uint32_t t_lo[kCols];
  float t_a[kCols], t_b[kCols];

  for (; it < p.items; it += gridDim.x, ++k) {
    const Item m = item_at(it);
    const int cb = it % p.col_bands;
    const int s = kBulk ? k % p.stages : 0;
    const bf16* st = stage0 + s * stage_elems;
    bf16* hb = hbuf0 + (k & 1) * hbuf_elems;

    if (cb != tap_band) {  // uniform: the column band's taps, once a band
      __syncthreads();  // every thread done with the last taps (W pass)
      for (int jj = tid; jj < cols8; jj += kThreads) {
        const int j = min(m.j0 + jj, m.j1 - 1);
        float a, b;
        tap_weights(lo_w[j], hi_w[j], fr_w[j], a, b);
        taps[jj].lo_d = static_cast<uint32_t>(lo_w[j]) |
                        (static_cast<uint32_t>(hi_w[j] - lo_w[j]) << 31);
        taps[jj].w = __floats2bfloat162_rn(a, b);
      }
      tap_band = cb;
    }
    if (kBulk) {
      hp::mbar_wait(&full[s], (k / p.stages) & 1);
    } else {  // narrow rows: all threads copy the item's rows, 2 bytes each
      const bf16* src = plane_in(m) + static_cast<size_t>(m.r0) * p.w + m.c0;
      bf16* dst = stage0;
      const int n = m.nrows * m.span;
      for (int e = tid; e < n; e += kThreads) {
        const int r = e / m.span, c = e - r * m.span;
        dst[r * p.pitch + c] = src[static_cast<size_t>(r) * p.w + c];
      }
      __syncthreads();
    }

    // H pass: a warp per output row, two rows at a time, its lanes over
    // the row's chunks of 8 columns
    {
      constexpr int kWarps = kThreads / 32;
      const int warp = tid >> 5, lane = tid & 31;
      const int nrow = m.i1 - m.i0;
      const int nck = (m.span + kCols - 1) / kCols;
      for (int rr = warp; rr < nrow; rr += 2 * kWarps) {
        const bool two = rr + kWarps < nrow;
        const int i = m.i0 + rr, i2 = two ? i + kWarps : i;
        float a[2], b[2];
        tap_weights(lo_h[i], hi_h[i], fr_h[i], a[0], b[0]);
        tap_weights(lo_h[i2], hi_h[i2], fr_h[i2], a[1], b[1]);
        const bf16* src[2][2] = {
            {st + (lo_h[i] - m.r0) * p.pitch, st + (hi_h[i] - m.r0) * p.pitch},
            {st + (lo_h[i2] - m.r0) * p.pitch, st + (hi_h[i2] - m.r0) * p.pitch}};
        bf16* dst[2] = {hb + rr * p.pitch, hb + (rr + kWarps) * p.pitch};
        for (int ch = lane; ch < nck; ch += 32) {
          uint4 u[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              u[r][t] = *reinterpret_cast<const uint4*>(src[r][t] + ch * kCols);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r == 1 && !two) break;
            float f0[8], f1[8];
            unpack8(u[r][0], f0);
            unpack8(u[r][1], f1);
            __align__(16) bf16 v[kCols];
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              v[q] = __float2bfloat16_rn(a[r] * f0[q] + b[r] * f1[q]);
            *reinterpret_cast<uint4*>(dst[r] + ch * kCols) =
                *reinterpret_cast<const uint4*>(v);
          }
        }
      }
    }
    __syncthreads();  // the H buffer is whole; the stage is free
    if (kBulk && tid == 0) {
      const int next = it + p.stages * gridDim.x;
      if (next < p.items) issue(next, s);
    }

    // W pass: rows x ceil(cols / 8) tasks of 8 outputs
    {
      const int nrow = m.i1 - m.i0;
      const int ng = cols8 / kCols;
      int rr = tid / ng, g = tid - rr * ng;
      const int drr = kThreads / ng, dg = kThreads - drr * ng;
      bf16* orow0 = out + (static_cast<size_t>(m.plane) * p.H + m.i0) * p.W;
      const bool vec_store = (p.W % kCols) == 0;
      while (rr < nrow) {
        const int j = m.j0 + g * kCols;
        if (j < m.j1) {
          if (j != cached_col) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              const Tap t = taps[g * kCols + q];
              t_lo[q] = t.lo_d;
              const float2 wf = __bfloat1622float2(t.w);
              t_a[q] = wf.x;
              t_b[q] = wf.y;
            }
            cached_col = j;
          }
          const bf16* hrow = hb + rr * p.pitch - m.c0;
          __align__(16) bf16 v[kCols];
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const int c0 = static_cast<int>(t_lo[q] & 0x7fffffffu);
            const int c1 = c0 + static_cast<int>(t_lo[q] >> 31);
            const float y0 = __bfloat162float(hrow[c0]);
            const float y1 = __bfloat162float(hrow[c1]);
            v[q] = __float2bfloat16_rn(t_a[q] * y0 + t_b[q] * y1);
          }
          bf16* o = orow0 + static_cast<size_t>(rr) * p.W + j;
          if (vec_store) {
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
          } else {
            for (int q = 0; q < kCols && j + q < m.j1; ++q) o[q] = v[q];
          }
        }
        rr += drr;
        g += dg;
        if (g >= ng) {
          g -= ng;
          ++rr;
        }
      }
    }
  }
}

// dynamic shared memory of a plan
size_t smem_bytes(const Plan& p) {
  const int cols8 = (p.cols + kCols - 1) / kCols * kCols;
  return kBarBytes + cols8 * sizeof(Tap) +
         (static_cast<size_t>(p.stages) * p.stage_rows + 2 * p.rows) *
             p.pitch * sizeof(bf16);
}

template <bool kBulk>
cudaError_t launch(const bf16* x, bf16* out, const int* lo_h, const int* hi_h,
                   const float* fr_h, const int* lo_w, const int* hi_w,
                   const float* fr_w, const Plan& p, int ctas,
                   cudaStream_t stream) {
  // the attribute and the occupancy at the last size asked, kept
  static size_t max_smem = 0, last_smem = 0;
  static int per_sm = 0;
  const size_t smem = smem_bytes(p);
  cudaError_t err;
  if (smem > max_smem) {
    err = cudaFuncSetAttribute(resize_bilinear_kernel<kBulk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    max_smem = smem;
  }
  if (smem != last_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resize_bilinear_kernel<kBulk>, kThreads, smem);
    if (err != cudaSuccess) return err;
    last_smem = smem;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (ctas <= 0) ctas = hp::sm_count() * per_sm;
  if (ctas > p.items) ctas = p.items;
  resize_bilinear_kernel<kBulk><<<ctas, kThreads, smem, stream>>>(
      x, out, lo_h, hi_h, fr_h, lo_w, hi_w, fr_w, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (planes, h, w) and out (planes, H, W) bf16, contiguous; lo_h, hi_h
// (H,) int32 and fr_h (H,) fp32 the H-pass taps, lo_w, hi_w, fr_w (W,) the
// W-pass taps (ops/resize._interp_taps).  The band plan (ops/resize_kernel
// .band_plan): `rows` output rows and `cols` output columns an item,
// `stage_rows` x `pitch` elements a stage, `stages` stages, bulk copies if
// `bulk` (then w % 8 == 0 and x 16-byte aligned); `ctas` persistent CTAs
// (0: as many as fit on the SMs).  Returns cudaGetLastError().
int fast3r_resize_bilinear(const void* x, void* out, const void* lo_h,
                           const void* hi_h, const void* fr_h,
                           const void* lo_w, const void* hi_w,
                           const void* fr_w, int planes, int h, int w, int H,
                           int W, int rows, int cols, int stage_rows,
                           int pitch, int stages, int bulk, int ctas,
                           void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  Plan p{planes, h, w, H, W, rows, cols, (H + rows - 1) / rows,
         (W + cols - 1) / cols, stage_rows, pitch, bulk ? stages : 1, 0};
  const long long items = 1LL * planes * p.row_bands * p.col_bands;
  if (rows <= 0 || cols <= 0 || pitch % kCols || p.stages < 1 ||
      p.stages > kMaxStages || items > 0x7fffffffLL ||
      (bulk && (w % kCols ||
                reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return cudaErrorInvalidValue;
  p.items = static_cast<int>(items);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  const int* lh = static_cast<const int*>(lo_h);
  const int* hh = static_cast<const int*>(hi_h);
  const float* fh = static_cast<const float*>(fr_h);
  const int* lw = static_cast<const int*>(lo_w);
  const int* hw = static_cast<const int*>(hi_w);
  const float* fw = static_cast<const float*>(fr_w);
  return bulk ? launch<true>(xb, ob, lh, hh, fh, lw, hw, fw, p, ctas, s)
              : launch<false>(xb, ob, lh, hh, fh, lw, hw, fw, p, ctas, s);
}

// the dynamic shared memory (bytes) the kernel asks for under a plan
int fast3r_resize_smem_bytes(int rows, int cols, int stage_rows, int pitch,
                             int stages) {
  Plan p{};
  p.rows = rows;
  p.cols = cols;
  p.stage_rows = stage_rows;
  p.pitch = pitch;
  p.stages = stages;
  return static_cast<int>(smem_bytes(p));
}

}  // extern "C"
