// Device helpers shared by the port's kernels: ldmatrix loads, bf16
// packing, a warp sum, the exact-erf GELU and SiLU.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fast3r_ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x * Phi(x) with the exact erf (torch's nn.GELU default)
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
}

// x * sigmoid(x) with an exact division (torch's nn.SiLU)
__device__ __forceinline__ float silu(float v) {
  return v * (1.f / (1.f + expf(-v)));
}

}  // namespace fast3r_ptx
