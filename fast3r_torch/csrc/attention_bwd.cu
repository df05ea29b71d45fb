// Attention backward for the port: dq, dk, dv of o = softmax(scale q k^T) v,
// non-causal, no mask, head_dim 64, bf16, over (B, N, H, 64) q / k / v / do
// read through strides by TMA and dq / dk / dv written through strides.
//
// Replaces the TPU kernels fast3r_tpu/ops/flash_attention.py
// (_flash_backward_packed -> _bwd_dq_kernel_packed, _bwd_dkv_kernel_packed;
// _flash_backward -> _bwd_dq_kernel, _bwd_dkv_kernel), the decoder's
// backward, and fast3r_tpu/ops/batched_attention.py packed_qkv_attention_bwd
// (_fusedqkv_bwd_kernel), the encoder's, whose q, k, v and dq, dk, dv are
// the slices of one packed (3, B, N, C) buffer: the strides reach them in
// place, so neither layout is copied.
//
// What bounds it on an H100: the five products per (query, key) pair
// (s = q k^T, dp = do v^T, dv += p^T do, dq += ds k, dk += ds^T q), 2.5x
// the forward's FLOPs, on the tensor cores; the scores never leave
// registers.  Design: two launches, as the TPU kernels (no float atomics,
// so the result is deterministic run to run), each on attention_bwd_tile.cuh
// (wgmma products, TMA loads, a producer warp and two consumer warpgroups
// taking turns; its note has the per-tile math):
//   * dq kernel: one CTA = 128 queries of one (batch, head); K and V stream
//     in 64-key tiles; s, dp and ds are recomputed per tile (three products);
//   * dk / dv kernel: one CTA = 128 keys; Q, dO and the rows' lse and delta
//     stream in 64-query tiles; the transposed scores (keys as rows) make
//     p^T and ds^T the A operands of dv += p^T do and dk += ds^T q (four
//     products: the two passes run seven where the algorithm needs five,
//     the price of no atomics).
// The inputs come through rank-4 tensor maps, (64, token, head, batch) with
// the strides in elements, so the token dimension is its own and TMA's
// zero fill stops at Nq / Nk, not at the next batch; the outputs go out as
// plain 4-byte stores from the accumulator layout: they are written once
// per CTA, after Nk / 64 (or Nq / 64) tiles of loads and products, so a
// staging box and TMA stores were not tried.
// Rounding points: attention_bwd_tile.cuh's, those of attention_bwd_ref.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"

namespace {

using namespace fast3r_attn_bwd;

struct BwdArgs {
  CUtensorMap mq, mk, mv, mo;  // (64, N, H, B), 64-row boxes
  const float *lse, *delta;    // [(b * H + h) * ldl + n], ldl % 64 == 0
  bf16 *dq, *dk, *dv;
  int H, Nq, Nk, ldl;
  long long dqsb, dqsn, dqsh, dksb, dksn, dksh, dvsb, dvsn, dvsh;
  float scale, scale_log2;
};

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_kernel(const __grid_constant__ BwdArgs a) {
  Smem& s = smem();
  if (threadIdx.x == 0) init_barriers(s);
  __syncthreads();
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n = (a.Nk + kTile - 1) / kTile;
  OwnRing own;
  StageRing ring;
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    if (threadIdx.x == kConsumers) {
      load_own(s, own, &a.mq, &a.mo, q0, h, b);
      load_tiles(s, ring, &a.mk, &a.mv, h, b, n, nullptr, nullptr);
    }
    return;
  }
  const Consumer t;
  const int r0 = q0 + t.row();
  const long long lrow = ((long long)b * a.H + h) * a.ldl;
  float l[2], dl[2];  // the thread's rows' lse (log2 domain) and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    l[i] = r < a.Nq ? a.lse[lrow + r] * kLog2e : 0.f;
    dl[i] = r < a.Nq ? a.delta[lrow + r] : 0.f;
  }
  float dq[32];
  zero(dq);
  turns_open(t);
  dq_item(dq, s, own, ring, t, n, a.Nk, a.scale_log2, l, dl);
  turns_close(t);
  store_rows(a.dq + b * a.dqsb + h * a.dqsh, a.dqsn, r0, a.Nq, dq, a.scale, t.c());
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkv_kernel(const __grid_constant__ BwdArgs a) {
  Smem& s = smem();
  if (threadIdx.x == 0) init_barriers(s);
  __syncthreads();
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int n = (a.Nq + kTile - 1) / kTile;
  OwnRing own;
  StageRing ring;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const long long lrow = ((long long)b * a.H + h) * a.ldl;
      load_own(s, own, &a.mk, &a.mv, k0, h, b);
      load_tiles(s, ring, &a.mq, &a.mo, h, b, n, a.lse + lrow, a.delta + lrow);
    }
    return;
  }
  const Consumer t;
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  turns_open(t);
  dkv_item(dk, dv, s, own, ring, t, n, a.Nq, a.scale_log2);
  turns_close(t);
  const int r0 = k0 + t.row();
  store_rows(a.dk + b * a.dksb + h * a.dksh, a.dksn, r0, a.Nk, dk, a.scale, t.c());
  store_rows(a.dv + b * a.dvsb + h * a.dvsh, a.dvsn, r0, a.Nk, dv, 1.f, t.c());
}

// the rank-4 map (64, N, H, B) of a (B, N, H, 64) tensor through its
// (batch, token, head) strides in elements
cudaError_t map4(CUtensorMap* m, const void* base, int B, int N, int H, long long sb,
                 long long sn, long long sh) {
  const long long dims[4] = {kD, N, H, B};
  const long long strides[3] = {sn, sh, sb};
  return fast3r_hopper::make_tmap(m, base, 4, dims, strides, kTile);
}

}  // namespace

extern "C" {

// Dynamic shared memory of each backward kernel on attention_bwd_tile.cuh
// (both of K9's and the bf16 rings of csrc/ring_attention_bwd.cu).
int fast3r_attention_bwd_smem_bytes() { return kSmemBytes; }

// bf16 q, k, v, dout (B, Nq|Nk, H, 64) and dq, dk, dv of the same shapes,
// all through (batch, token, head) strides in elements (head dim
// contiguous; q, k, v, dout with 16-byte aligned bases and strides, as TMA
// takes them); fp32 lse (natural log, the forward's) and delta =
// rowsum(dout * o) at [(b * H + h) * ldl + n] with ldl % 64 == 0 and
// ldl >= Nq (rows padded to whole 64-query tiles), 16-byte aligned.
// Runs the dq kernel, then the dk / dv kernel, on the stream.  Returns
// cudaGetLastError().
int fast3r_attention_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, int B, int H, int Nq,
                         int Nk, int ldl, long long qsb, long long qsn,
                         long long qsh, long long ksb, long long ksn,
                         long long ksh, long long vsb, long long vsn,
                         long long vsh, long long osb, long long osn,
                         long long osh, long long dqsb, long long dqsn,
                         long long dqsh, long long dksb, long long dksn,
                         long long dksh, long long dvsb, long long dvsn,
                         long long dvsh, float scale, void* stream) {
  if (ldl % kTile || ldl < Nq || Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0 ||
      (reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) & 15)
    return cudaErrorInvalidValue;
  BwdArgs a;
  cudaError_t err;
  if ((err = map4(&a.mq, q, B, Nq, H, qsb, qsn, qsh)) != cudaSuccess ||
      (err = map4(&a.mk, k, B, Nk, H, ksb, ksn, ksh)) != cudaSuccess ||
      (err = map4(&a.mv, v, B, Nk, H, vsb, vsn, vsh)) != cudaSuccess ||
      (err = map4(&a.mo, dout, B, Nq, H, osb, osn, osh)) != cudaSuccess)
    return err;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.ldl = ldl;
  a.dqsb = dqsb; a.dqsn = dqsn; a.dqsh = dqsh;
  a.dksb = dksb; a.dksn = dksn; a.dksh = dksh;
  a.dvsb = dvsb; a.dvsn = dvsn; a.dvsh = dvsh;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<<<dim3((Nq + kRows - 1) / kRows, H, B), kThreads, kSmemBytes,
                            st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<<<dim3((Nk + kRows - 1) / kRows, H, B), kThreads, kSmemBytes,
                             st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
