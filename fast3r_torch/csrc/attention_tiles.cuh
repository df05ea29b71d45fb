// The fp32 ring kernels' 64-row tile loader (csrc/ring_attention.cu and the
// fp32 variants of csrc/ring_attention_bwd.cu): rows of a strided source
// into shared memory of row stride kTileLdF.  The bf16 backward tiles are
// attention_bwd_tile.cuh's.
#pragma once

#include <stdint.h>

namespace fast3r_tiles {

constexpr int kTileLdF = 68;  // fp32 row stride

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
