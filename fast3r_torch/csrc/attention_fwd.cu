// Attention forward for the port: softmax(scale * q k^T) v, non-causal, no
// mask, head_dim 64, over (B, N, H, 64) q/k/v read through strides.
//
// Replaces the TPU kernels fast3r_tpu/ops/flash_attention.py
// (_fwd_kernel_packed, _fwd_kernel, _fwd_single_kernel) and
// fast3r_tpu/ops/batched_attention.py (_packed_kernel, _batched_kernel): one
// kernel serves the encoder's many short heads (20 views x 16 heads, N = 768)
// and the decoder's few long ones (16 heads, N = 15360).
//
// What bounds it on an H100: at head_dim 64 attention does 4 * 64 FLOPs per
// (query, key) pair against 2 * 64 * 2 bytes of K/V per key, reused by every
// query of a block, so it is bound by the tensor cores and by the softmax's
// exp2 / max work between the two products.  Design (bf16, the served
// type), in the manner of FlashAttention-2:
//   * one block = 64 queries of one (batch, head); 4 warps, 16 rows each;
//   * K and V stream through shared memory in 64-key tiles, double-buffered
//     with cp.async (zero-filled past the sequence end: the ragged tail is
//     masked in the kernel);
//   * q k^T and p v are mma.sync m16n8k16 bf16 products with fp32
//     accumulators, operands fetched with ldmatrix (V transposed on load);
//   * scores never leave registers: the online softmax (fp32 running max
//     and sum, exp2 with the scale folded into log2 e) works on the mma
//     accumulators, and the accumulator layout of two 8-key tiles is the A
//     operand layout of the p v product, so p is packed to bf16 in place.
//     The row sum adds the unrounded fp32 p.
// q, k and v are read through their (batch, token, head) strides, so the
// three views of the qkv projection's (B, N, 3, H, 64) output need no copy;
// the output is contiguous (B, N, H, 64).  For training each kernel also
// writes the rows' fp32 logsumexp (lse, natural log), which the backward
// (attention_bwd.cu) reads; inference passes no lse buffer.  The fp32
// kernel (used to check the algorithm tightly on the card) is a scalar
// version of the same tiling.
// Not yet: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block, 16 per warp
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kLd = kD + 8;   // bf16 smem row stride: 144 B, ldmatrix conflict-free
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 kernel (tensor cores)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int H, int Nq, int Nk, long long qsb, long long qsn,
                          long long qsh, long long ksb, long long ksn,
                          long long ksh, long long vsb, long long vsn,
                          long long vsh, float scale_log2,
                          float* __restrict__ lse, int ldl) {
  __shared__ __align__(128) bf16 Qs[kBQ * kLd];
  __shared__ __align__(128) bf16 Ks[2][kBK * kLd];
  __shared__ __align__(128) bf16 Vs[2][kBK * kLd];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;  // mma fragment row / column pair

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  cp_async_rows64<kLd>(Qs, qb, qsn, q0, Nq);
  cp_async_rows64<kLd>(Ks[0], kb, ksn, 0, Nk);
  cp_async_rows64<kLd>(Vs[0], vb, vsn, 0, Nk);
  cp_async_commit();

  uint32_t qf[4][4];  // this warp's 16 query rows as A fragments, 4 k-steps
  float acc[8][4];    // O: 16 rows x 64 d as 8 n-tiles of 8
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max / partial row sum for rows g and g + 8 of the warp's tile
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  const int ntiles = (Nk + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      cp_async_rows64<kLd>(Ks[st ^ 1], kb, ksn, (t + 1) * kBK, Nk);
      cp_async_rows64<kLd>(Vs[st ^ 1], vb, vsn, (t + 1) * kBK, Nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks[st];
    const bf16* Vt = Vs[st];

    // S = Q K^T: 16 rows x 64 keys as 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {
        uint32_t kf[4];  // b0, b1 of k-steps kk and kk + 1
        ldmatrix_x4(kf, Kt + (j * 8 + (lane & 7)) * kLd + kk * 16 + (lane >> 3) * 8);
        mma16816(s[j], qf[kk], kf[0], kf[1]);
        mma16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // online softmax; this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int kbase = t * kBK + 2 * c;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + j * 8 + e < Nk;
        s[j][e] = ok ? s[j][e] * scale_log2 : -CUDART_INF_F;
        s[j][e + 2] = ok ? s[j][e + 2] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][e + 2]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[4][4];  // P as A fragments of the p v product, 4 k-steps
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // O += P V: V^T fragments via ldmatrix.trans, two d-tiles per load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                  n * 8 + (lane >> 4) * 8);
        mma16816(acc[n], pf[kk], vf[0], vf[1]);
        mma16816(acc[n + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && c == 0) {  // natural-log logsumexp of the scaled scores
    float* lrow = lse + ((long long)b * H + h) * ldl;
    if (r0 < Nq) lrow[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < Nq) lrow[r1] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    if (r0 < Nq)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * Nq + r0) * H + h) * kD + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Nq)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * Nq + r1) * H + h) * kD + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel (scalar FMAs, same tiling; two lanes per query row)
// ---------------------------------------------------------------------------

constexpr int kLdF = kD + 4;   // 272-byte rows
constexpr int kLdS = kBK + 4;  // fp32 score / probability rows

__device__ inline void load_tile_f32(float* dst, const float* src,
                                     long long s_tok, int row0, int n_valid) {
  for (int c = threadIdx.x; c < 64 * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), col = (c % (kD / 4)) * 4;
    const int n = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid)
      val = *reinterpret_cast<const float4*>(src + (long long)n * s_tok + col);
    *reinterpret_cast<float4*>(dst + r * kLdF + col) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int H, int Nq, int Nk, long long qsb, long long qsn,
                         long long qsh, long long ksb, long long ksn,
                         long long ksh, long long vsb, long long vsn,
                         long long vsh, float scale_log2,
                         float* __restrict__ lse, int ldl) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * kLdF;
  float* Vs = Ks + kBK * kLdF;
  float* Ps = Vs + kBK * kLdF;  // scores, then probabilities

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;  // this lane's query row in the tile
  const int c0 = (lane & 1) * 32;      // its half of the keys, and of D

  load_tile_f32(Qs, q + b * qsb + h * qsh, qsn, q0, Nq);
  __syncthreads();
  float qreg[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qreg[d] = Qs[r * kLdF + d];

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();
    load_tile_f32(Ks, k + b * ksb + h * ksh, ksn, k0, Nk);
    load_tile_f32(Vs, v + b * vsb + h * vsh, vsn, k0, Nk);
    __syncthreads();

    float s[32];
    float tmax = -CUDART_INF_F;
    for (int i = 0; i < 32; ++i) {
      const float* krow = Ks + (c0 + i) * kLdF;
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) x = fmaf(qreg[d], krow[d], x);
      s[i] = (k0 + c0 + i < Nk) ? x * scale_log2 : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m_new);
      psum += p;
      Ps[r * kLdS + c0 + i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * kLdS + j];
      const float* vrow = Vs + j * kLdF + c0;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(p, vrow[i], acc[i]);
    }
    __syncwarp();
  }

  const int n = q0 + r;
  if (lse != nullptr && c0 == 0 && n < Nq)
    lse[((long long)b * H + h) * ldl + n] = (m + log2f(l)) * kLn2;
  if (n < Nq) {
    const float inv = 1.f / l;
    float* dst = o + (((long long)b * Nq + n) * H + h) * kD + c0;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = acc[i] * inv;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the wrapper
// checks the 16-byte alignment of every row.  lse (may be null): fp32
// natural-log logsumexp per query row, at lse[(b * H + h) * ldl + n].
// Returns cudaGetLastError().
int fast3r_attention_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Nq, int Nk,
                         long long qsb, long long qsn, long long qsh,
                         long long ksb, long long ksn, long long ksh,
                         long long vsb, long long vsn, long long vsh,
                         float scale, void* lse, int ldl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Nq + kBQ - 1) / kBQ, H, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dtype == 1) {
    attention_fwd_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Nq, Nk, qsb,
        qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, scale_log2,
        static_cast<float*>(lse), ldl);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const int smem = (3 * 64 * kLdF + kBQ * kLdS) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attention_fwd_f32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Nq, Nk, qsb,
        qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, scale_log2,
        static_cast<float*>(lse), ldl);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

const char* fast3r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
