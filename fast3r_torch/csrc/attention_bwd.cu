// Attention backward for the port: dq, dk, dv of o = softmax(scale q k^T) v,
// non-causal, no mask, head_dim 64, bf16, over (B, N, H, 64) q / k / v / do
// read through strides and dq / dk / dv written through strides.
//
// Replaces the TPU kernels fast3r_tpu/ops/flash_attention.py
// (_flash_backward_packed -> _bwd_dq_kernel_packed, _bwd_dkv_kernel_packed;
// _flash_backward -> _bwd_dq_kernel, _bwd_dkv_kernel), the decoder's
// backward, and fast3r_tpu/ops/batched_attention.py packed_qkv_attention_bwd
// (_fusedqkv_bwd_kernel), the encoder's, whose q, k, v and dq, dk, dv are
// the slices of one packed (3, B, N, C) buffer: the strides reach them in
// place, so neither layout is copied.
//
// What bounds it on an H100: the five products per (query, key) tile
// (s = q k^T, dp = do v^T, dv += p^T do, dq += ds k, dk += ds^T q), 2.5x
// the forward's FLOPs, on the tensor cores; the scores never leave
// registers.  Design, FlashAttention-2 style, two launches as the TPU
// kernels (no float atomics, so the result is deterministic):
//   * dq kernel: one block = 64 queries of one (batch, head), 4 warps of 16
//     rows; K and V stream through shared memory in 64-key tiles, double
//     buffered with cp.async; per tile it recomputes s and p = exp2(s c -
//     lse log2 e) from the forward's fp32 lse, dp = do v^T, ds = p (dp -
//     delta) and accumulates ds k in fp32 registers;
//   * dk / dv kernel: one block = 64 keys, 4 warps of 16 keys, Q, dO and
//     the rows' lse and delta streaming in 64-query tiles; it works on the
//     transposed scores (keys as rows), so p^T and ds^T are the A operands
//     of dv += p^T do and dk += ds^T q straight from the accumulators.
//   Each warp's fragments of its own 16 rows (q and do, or k and v) are
//   loaded once and stay in registers; the other operands are ldmatrix'd
//   per tile, transposed on load where the product needs it.
// Rounding points (those of the TPU kernels): lse and delta = rowsum(do o)
// in fp32 (delta from the bf16 o, computed by the caller); scores, p, dp
// and ds in fp32; p and ds rounded to bf16 before their products; fp32
// accumulation; dq and dk scaled in fp32 and rounded once.  The scale stays
// in fp32 (the TPU kernels round q * scale * log2 e to bf16 first).
// Ragged N is masked: keys past Nk and queries past Nq contribute nothing.
// Not yet: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;
using namespace fast3r_tiles;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head dim
constexpr int kB = 64;        // rows of a tile (queries or keys)
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kLd = kD + 8;   // bf16 smem row stride: 144 B, ldmatrix conflict-free
constexpr int kTile = kB * kLd;
static_assert(kLd == kTileLd, "attention_tiles.cuh's row stride");
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;  // [(b * H + h) * ldl + n], ldl % 64 == 0
  bf16 *dq, *dk, *dv;
  int H, Nq, Nk, ldl;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, osb, osn, osh;
  long long dqsb, dqsn, dqsh, dksb, dksn, dksh, dvsb, dvsn, dvsh;
  float scale, scale_log2;
};

__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + kTile;  // dO
  bf16* Ks = Os + kTile;  // two buffers each
  bf16* Vs = Ks + 2 * kTile;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const bf16* kb = a.k + b * a.ksb + h * a.ksh;
  const bf16* vb = a.v + b * a.vsb + h * a.vsh;

  cp_async_rows64<kLd>(Qs, a.q + b * a.qsb + h * a.qsh, a.qsn, q0, a.Nq);
  cp_async_rows64<kLd>(Os, a.dout + b * a.osb + h * a.osh, a.osn, q0, a.Nq);
  cp_async_rows64<kLd>(Ks, kb, a.ksn, 0, a.Nk);
  cp_async_rows64<kLd>(Vs, vb, a.vsn, 0, a.Nk);
  cp_async_commit();

  // lse (log2 domain) and delta of this thread's rows g and g + 8
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long lrow = ((long long)b * a.H + h) * a.ldl;
  const float l0 = r0 < a.Nq ? a.lse[lrow + r0] * kLog2e : 0.f;
  const float l1 = r1 < a.Nq ? a.lse[lrow + r1] * kLog2e : 0.f;
  const float d0 = r0 < a.Nq ? a.delta[lrow + r0] : 0.f;
  const float d1 = r1 < a.Nq ? a.delta[lrow + r1] : 0.f;

  uint32_t qf[4][4], of[4][4];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (a.Nk + kB - 1) / kB;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      cp_async_rows64<kLd>(Ks + (st ^ 1) * kTile, kb, a.ksn, (t + 1) * kB, a.Nk);
      cp_async_rows64<kLd>(Vs + (st ^ 1) * kTile, vb, a.vsn, (t + 1) * kB, a.Nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a_frags(qf, Qs, warp, lane);
      load_a_frags(of, Os, warp, lane);
    }
    const bf16* Kt = Ks + st * kTile;
    const bf16* Vt = Vs + st * kTile;

    float s[8][4], dp[8][4];
    mma_abt(s, qf, Kt, lane);   // q k^T
    mma_abt(dp, of, Vt, lane);  // do v^T
    const int kbase = t * kB + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + j * 8 + e < a.Nk;
        const float p0 = ok ? exp2f(s[j][e] * a.scale_log2 - l0) : 0.f;
        const float p1 = ok ? exp2f(s[j][e + 2] * a.scale_log2 - l1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - d0);  // ds, in place
        s[j][e + 2] = p1 * (dp[j][e + 2] - d1);
      }
    }
    uint32_t dsf[4][4];
    pack_a(dsf, s);
    mma_pt(acc, dsf, Kt, lane);  // ds k
    __syncthreads();  // every warp is done with this buffer before refill
  }
  store_rows(a.dq + b * a.dqsb + h * a.dqsh, a.dqsn, r0, a.Nq, acc, a.scale, c);
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile;
  bf16* Qs = Vs + kTile;      // two buffers each
  bf16* Os = Qs + 2 * kTile;  // dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * kTile);  // [2][kB] lse
  float* Ds = Ls + 2 * kB;                                // [2][kB] delta

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = a.q + b * a.qsb + h * a.qsh;
  const bf16* ob = a.dout + b * a.osb + h * a.osh;
  const long long lrow = ((long long)b * a.H + h) * a.ldl;

  // a 64-query tile's lse and delta rows (ldl is a multiple of 64, so the
  // 16-byte chunks stay inside the row; entries past Nq are masked below)
  auto load_rows = [&](int buf, int q0) {
    if (threadIdx.x < 32) {
      const int i = (threadIdx.x & 15) * 4;
      const float* src = (threadIdx.x < 16 ? a.lse : a.delta) + lrow + q0 + i;
      float* dst = (threadIdx.x < 16 ? Ls : Ds) + buf * kB + i;
      cp_async16(dst, src, true);
    }
  };

  cp_async_rows64<kLd>(Ks, a.k + b * a.ksb + h * a.ksh, a.ksn, k0, a.Nk);
  cp_async_rows64<kLd>(Vs, a.v + b * a.vsb + h * a.vsh, a.vsn, k0, a.Nk);
  cp_async_rows64<kLd>(Qs, qb, a.qsn, 0, a.Nq);
  cp_async_rows64<kLd>(Os, ob, a.osn, 0, a.Nq);
  load_rows(0, 0);
  cp_async_commit();

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int ntiles = (a.Nq + kB - 1) / kB;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      cp_async_rows64<kLd>(Qs + (st ^ 1) * kTile, qb, a.qsn, (t + 1) * kB, a.Nq);
      cp_async_rows64<kLd>(Os + (st ^ 1) * kTile, ob, a.osn, (t + 1) * kB, a.Nq);
      load_rows(st ^ 1, (t + 1) * kB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a_frags(kf, Ks, warp, lane);
      load_a_frags(vf, Vs, warp, lane);
    }
    const bf16* Qt = Qs + st * kTile;
    const bf16* Ot = Os + st * kTile;
    const float* Lt = Ls + st * kB;
    const float* Dt = Ds + st * kB;

    // transposed scores: rows = this warp's 16 keys, columns = 64 queries
    float s[8][4], dp[8][4];
    mma_abt(s, kf, Qt, lane);  // k q^T
    const int qbase = t * kB + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = qbase + j * 8 + e < a.Nq;
        const float l = Lt[j * 8 + 2 * c + e] * kLog2e;
        s[j][e] = ok ? exp2f(s[j][e] * a.scale_log2 - l) : 0.f;  // p^T
        s[j][e + 2] = ok ? exp2f(s[j][e + 2] * a.scale_log2 - l) : 0.f;
      }
    }
    uint32_t pf[4][4];
    pack_a(pf, s);
    mma_pt(dv, pf, Ot, lane);  // dv += p^T do
    mma_abt(dp, vf, Ot, lane);  // v do^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = qbase + j * 8 + e < a.Nq;
        const float d = Dt[j * 8 + 2 * c + e];
        s[j][e] = ok ? s[j][e] * (dp[j][e] - d) : 0.f;  // ds^T
        s[j][e + 2] = ok ? s[j][e + 2] * (dp[j][e + 2] - d) : 0.f;
      }
    }
    pack_a(pf, s);
    mma_pt(dk, pf, Qt, lane);  // dk += ds^T q
    __syncthreads();
  }
  const int r0 = k0 + warp * 16 + g;
  store_rows(a.dk + b * a.dksb + h * a.dksh, a.dksn, r0, a.Nk, dk, a.scale, c);
  store_rows(a.dv + b * a.dvsb + h * a.dvsh, a.dvsn, r0, a.Nk, dv, 1.f, c);
}

constexpr int kSmemDq = 6 * kTile * 2;
constexpr int kSmemDkv = 6 * kTile * 2 + 4 * kB * 4;

}  // namespace

extern "C" {

// bf16 q, k, v, dout (B, Nq|Nk, H, 64) and dq, dk, dv of the same shapes,
// all through (batch, token, head) strides in elements (head dim
// contiguous, 16-byte rows); fp32 lse (natural log, the forward's) and
// delta = rowsum(dout * o) at [(b * H + h) * ldl + n] with ldl % 64 == 0
// and ldl >= Nq (rows padded to whole 64-query tiles).
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
  if (ldl % kB || ldl < Nq || Nq <= 0 || Nk <= 0) return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.ldl = ldl;
  a.qsb = qsb; a.qsn = qsn; a.qsh = qsh;
  a.ksb = ksb; a.ksn = ksn; a.ksh = ksh;
  a.vsb = vsb; a.vsn = vsn; a.vsh = vsh;
  a.osb = osb; a.osn = osn; a.osh = osh;
  a.dqsb = dqsb; a.dqsn = dqsn; a.dqsh = dqsh;
  a.dksb = dksb; a.dksn = dksn; a.dksh = dksh;
  a.dvsb = dvsb; a.dvsn = dvsn; a.dvsh = dvsh;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<<<dim3((Nq + kB - 1) / kB, H, B), kThreads, kSmemDq, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<<<dim3((Nk + kB - 1) / kB, H, B), kThreads, kSmemDkv, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
