// The attention kernels' tile math on 64 x 64 bf16 tiles in shared memory
// of row stride kTileLd, 4 warps of 16 rows (csrc/attention_bwd.cu, and the
// backward rings of csrc/ring_attention_bwd.cu): A fragments, the q k^T and
// p v products on mma.sync m16n8k16, bf16 packing of accumulators and their
// strided stores; and the fp32 variants' 64-row loader.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace fast3r_tiles {

using fast3r_ptx::ldmatrix_x4;
using fast3r_ptx::ldmatrix_x4_trans;
using fast3r_ptx::mma16816;
using fast3r_ptx::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTileLd = 72;   // bf16 row stride: 144 B, ldmatrix conflict-free
constexpr int kTileLdF = 68;  // fp32 row stride

// this warp's 16 rows of a 64-row tile as 4 k-steps of A fragments
static __device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const bf16* t,
                                             int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], t + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kTileLd +
                           kk * 16 + (lane >> 4) * 8);
}

// acc (16 x 64) = A (16 x 64 d) . T^T, T a 64-row tile whose rows are the
// product's columns (the forward's q k^T)
static __device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* t, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t f[4];
      ldmatrix_x4(f, t + (j * 8 + (lane & 7)) * kTileLd + kk * 16 + (lane >> 3) * 8);
      mma16816(acc[j], a[kk], f[0], f[1]);
      mma16816(acc[j], a[kk + 1], f[2], f[3]);
    }
  }
}

// acc (16 x 64 d) += P (16 x 64 rows of t, as A fragments) . T, T a 64-row
// tile read transposed (the forward's p v)
static __device__ __forceinline__ void mma_pt(float (&acc)[8][4], const uint32_t (&p)[4][4],
                                       const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kTileLd +
                               n * 8 + (lane >> 4) * 8);
      mma16816(acc[n], p[kk], f[0], f[1]);
      mma16816(acc[n + 1], p[kk], f[2], f[3]);
    }
  }
}

// accumulator tiles (16 x 64) -> A fragments (4 k-steps of 16), bf16
static __device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
  }
}

// rows g and g + 8 of a warp's 16 x 64 accumulator -> bf16 rows through
// strides, times mul
static __device__ __forceinline__ void store_rows(bf16* base, long long s_row, int r0,
                                           int n_valid, const float (&acc)[8][4],
                                           float mul, int c) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    if (r0 < n_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)r0 * s_row + col) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + 8 < n_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)(r0 + 8) * s_row + col) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// rows [row0, row0 + 64) x 64 fp32 of a strided source -> smem rows of
// stride kTileLdF, through L2; rows at or past n_valid zero-filled
static __device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                                     long long s_row, int row0,
                                                     int n_valid) {
  for (int i = threadIdx.x; i < 64 * 16; i += blockDim.x) {
    const int rr = i / 16, col = (i % 16) * 4;
    const int n = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid) val = __ldcg(reinterpret_cast<const float4*>(src + n * s_row + col));
    *reinterpret_cast<float4*>(dst + rr * kTileLdF + col) = val;
  }
}

}  // namespace fast3r_tiles
