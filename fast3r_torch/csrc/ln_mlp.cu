// The whole pre-LN MLP sublayer in one kernel:
//   y = x + GELU(LN(x) W1^T + b1) W2^T + b2
// bf16 in and out, fp32 accumulation, W1 (hidden, C) and W2 (C, hidden) in
// the nn.Linear layout, C = 1024 (the flagship width).
//
// Replaces the TPU kernel fast3r_tpu/nn/fused_block.py _ln_mlp_kernel
// (through ln_mlp -> _ln_mlp_call).  Like it, the (M, hidden) GELU
// activation never reaches device memory: h is rounded to bf16 (the TPU
// kernel's rounding point) and kept in shared memory between the two
// products, and the residual is added in fp32 and rounded once.
//
// What bounds it on an H100: the TPU kernel keeps both weights resident and
// holds a (bm, hidden) fp32 pre-activation per row tile; a block here cannot
// (a (64, 1024) fp32 fc2 accumulator alone is 256 KB, the whole register
// file).  So the tiling is different:
//   * one block = 32 rows, 8 warps; the normalised row tile (32 x 1024
//     bf16, 64 KB) stays in shared memory for the whole kernel;
//   * the fc2 accumulator lives in registers, 32 rows x 128 columns per warp
//     (128 fp32 a thread), so the block owns all 1024 output columns;
//   * the hidden dimension is walked in chunks of 32: fc1 for a chunk
//     (32 x 32, one m16 x n8 tile per warp over K = 1024, four accumulator
//     chains) -> bias, exact-erf GELU -> bf16 h in shared memory -> fc2
//     accumulates h (32 x 32) times the chunk's W2 columns (1024 x 32);
//   * each chunk's W1 rows (64 KB) and W2 columns (64 KB) arrive by cp.async
//     into single buffers, each load issued as soon as the previous chunk
//     has finished reading its buffer, so the W2 load overlaps fc1 and the
//     next W1 load overlaps fc2 (217 KB of shared memory, one block an SM).
// Every block reads both weights (16.8 MB) from L2 once: about 8 GB for the
// flagship's 480 row tiles.  Measured on the H100, though, the work inside a
// block bounds it before that traffic does: fc1 on a 32-wide hidden chunk
// is a thin product that reads 1.5 ldmatrix tiles per mma and runs as a
// dependent chain, and three block barriers a chunk keep the warps in step
// (a variant that shared each weight slice between two blocks of a cluster,
// halving the L2 traffic, ran no faster).  Constraints (the wrapper checks
// them): C == 1024, hidden % 32 == 0; M may be ragged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;

using bf16 = __nv_bfloat16;

constexpr int kC = 1024;       // model width
constexpr int kBM = 32;        // rows per block
constexpr int kHC = 32;        // hidden chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWN = kC / 8;    // fc2 output columns per warp
constexpr int kLdU = kC + 8;   // 2064-byte rows: ldmatrix conflict-free
constexpr int kLdW2 = kHC + 8; // 80-byte rows
constexpr int kSmemBytes =
    (2 * kBM * kLdU + kC * kLdW2 + kBM * kLdW2) * 2;  // U, W1, W2, H

__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out, int M,
              int hidden, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* U = reinterpret_cast<bf16*>(smem_raw);  // LN(x) rows, [32][kLdU]
  bf16* W1s = U + kBM * kLdU;                   // chunk of W1 rows, [32][kLdU]
  bf16* W2s = W1s + kBM * kLdU;                 // chunk of W2 cols, [1024][kLdW2]
  bf16* Hs = W2s + kC * kLdW2;                  // GELU(h) chunk, [32][kLdW2]

  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int nchunks = hidden / kHC;

  auto load_w1 = [&](int h) {  // W1 rows [h*32, h*32 + 32), all of K
    const bf16* src = w1 + (long long)h * kHC * kC;
    for (int i = tid; i < kHC * (kC / 8); i += kThreads) {
      const int r = i / (kC / 8), ch = (i % (kC / 8)) * 8;
      cp_async16(W1s + r * kLdU + ch, src + (long long)r * kC + ch);
    }
  };
  auto load_w2 = [&](int h) {  // W2 columns [h*32, h*32 + 32), all rows
    const bf16* src = w2 + h * kHC;
    for (int i = tid; i < kC * (kHC / 8); i += kThreads) {
      const int r = i / (kHC / 8), ch = (i % (kHC / 8)) * 8;
      cp_async16(W2s + r * kLdW2 + ch, src + (long long)r * hidden + ch);
    }
  };

  load_w1(0);
  cp_async_commit();
  load_w2(0);
  cp_async_commit();

  // LN: 4 rows per warp, each lane holding 32 of a row's 1024 values
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int r = warp * (kBM / 8) + rr;
    const int row = m0 + r;
    float xv[32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M)
        v = *reinterpret_cast<const uint4*>(x + (long long)row * kC + j * 256 +
                                            lane * 8);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(u[e]);
        xv[j * 8 + 2 * e] = f.x;
        xv[j * 8 + 2 * e + 1] = f.y;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s += xv[i];
    const float mean = warp_sum(s) / kC;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) ss += (xv[i] - mean) * (xv[i] - mean);
    const float rstd = rsqrtf(warp_sum(ss) / kC + eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = j * 256 + lane * 8;
      uint4 v;
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u[e] = pack_bf16(
            (xv[j * 8 + 2 * e] - mean) * rstd * gamma[k + 2 * e] + beta[k + 2 * e],
            (xv[j * 8 + 2 * e + 1] - mean) * rstd * gamma[k + 2 * e + 1] +
                beta[k + 2 * e + 1]);
      *reinterpret_cast<uint4*>(U + r * kLdU + k) = v;
    }
  }

  float acc[2][kWN / 8][4];  // fc2: rows 0-31 x this warp's 128 columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nj = 0; nj < kWN / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0.f;

  const int fm = warp & 1, fn = warp >> 1;  // this warp's fc1 tile: m16, n8
  for (int h = 0; h < nchunks; ++h) {
    cp_async_wait<1>();  // W1 chunk h has landed (W2 chunk h may not)
    __syncthreads();

    // fc1: z = U[fm*16 .. +16] . W1s[fn*8 .. +8]^T over K, four chains
    float z[4][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 64) {
      uint32_t bf0[4], bf1[4], a0[4], a1[4], a2[4], a3[4];
      ldmatrix_x4(bf0, W1s + (fn * 8 + (lane & 7)) * kLdU + k0 + (lane >> 3) * 8);
      ldmatrix_x4(bf1, W1s + (fn * 8 + (lane & 7)) * kLdU + k0 + 32 +
                           (lane >> 3) * 8);
      const bf16* ua = U + (fm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdU +
                       k0 + (lane >> 4) * 8;
      ldmatrix_x4(a0, ua);
      ldmatrix_x4(a1, ua + 16);
      ldmatrix_x4(a2, ua + 32);
      ldmatrix_x4(a3, ua + 48);
      mma16816(z[0], a0, bf0[0], bf0[1]);
      mma16816(z[1], a1, bf0[2], bf0[3]);
      mma16816(z[2], a2, bf1[0], bf1[1]);
      mma16816(z[3], a3, bf1[2], bf1[3]);
    }
    {
      const int col = fn * 8 + 2 * c;
      const float bb0 = b1[h * kHC + col], bb1 = b1[h * kHC + col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(Hs + (fm * 16 + g + 8 * hh) * kLdW2 + col) =
            pack_bf16(gelu_erf(z[0][2 * hh] + z[1][2 * hh] + z[2][2 * hh] +
                               z[3][2 * hh] + bb0),
                      gelu_erf(z[0][2 * hh + 1] + z[1][2 * hh + 1] +
                               z[2][2 * hh + 1] + z[3][2 * hh + 1] + bb1));
    }
    __syncthreads();  // H complete; W1s free
    if (h + 1 < nchunks) load_w1(h + 1);
    cp_async_commit();
    cp_async_wait<1>();  // W2 chunk h has landed
    __syncthreads();

    // fc2: acc += H (32 x 32) . W2s[warp*128 .. +128]^T
    uint32_t af[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4(af[mt][kk], Hs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         kLdW2 + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < kWN / 8; ++nj) {
      uint32_t bf[4];
      ldmatrix_x4(bf, W2s + (warp * kWN + nj * 8 + (lane & 7)) * kLdW2 +
                          (lane >> 3) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][nj], af[mt][0], bf[0], bf[1]);
        mma16816(acc[mt][nj], af[mt][1], bf[2], bf[3]);
      }
    }
    __syncthreads();  // W2s and H free
    if (h + 1 < nchunks) load_w2(h + 1);
    cp_async_commit();
  }

  // epilogue: out = x + acc + b2, rounded once
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + mt * 16 + g + hh * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < kWN / 8; ++nj) {
        const int col = warp * kWN + nj * 8 + 2 * c;
        const long long off = (long long)row * kC + col;
        const float2 r = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + off));
        *reinterpret_cast<uint32_t*>(out + off) =
            pack_bf16(r.x + (acc[mt][nj][2 * hh] + b2[col]),
                      r.y + (acc[mt][nj][2 * hh + 1] + b2[col + 1]));
      }
    }
  }
}

}  // namespace

extern "C" {

// x, w1, w2, out bf16; gamma, beta, b1, b2 fp32.  C is fixed at 1024;
// hidden % 32 == 0.  Returns cudaGetLastError() after the launch.
int fast3r_ln_mlp(const void* x, const void* gamma, const void* beta,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int M, int hidden, float eps,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM);
  ln_mlp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, hidden, eps);
  return cudaGetLastError();
}

}  // extern "C"
