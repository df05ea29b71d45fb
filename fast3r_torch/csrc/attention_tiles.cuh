// The fp32 ring kernels' 64-row tile loader (the fp32 variants of
// csrc/ring_attention.cu and csrc/ring_attention_bwd.cu): rows of D
// columns (64 or 80) of a strided source into shared memory of row stride
// D + 4.  The bf16 tiles are attention_fwd_tile.cuh's and
// attention_bwd_tile.cuh's.
#pragma once

#include <stdint.h>

namespace fast3r_tiles {

// fp32 row stride of a tile of D columns
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }

// rows [row0, row0 + 64) x D fp32 of a strided source -> smem rows of
// stride tile_ld<D>(), through L2; rows at or past n_valid zero-filled
template <int D = 64>
static __device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                                     long long s_row, int row0,
                                                     int n_valid) {
  constexpr int kChunks = D / 4;  // float4s a row
  for (int i = threadIdx.x; i < 64 * kChunks; i += blockDim.x) {
    const int rr = i / kChunks, col = (i % kChunks) * 4;
    const int n = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid) val = __ldcg(reinterpret_cast<const float4*>(src + n * s_row + col));
    *reinterpret_cast<float4*>(dst + rr * tile_ld<D>() + col) = val;
  }
}

}  // namespace fast3r_tiles
