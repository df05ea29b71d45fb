// Attention forward for the port: softmax(scale * q k^T) v, non-causal, no
// mask, head_dim 64 or 80, over (B, N, H, D) q/k/v read through strides.
//
// Replaces the TPU kernels fast3r_tpu/ops/flash_attention.py
// (_fwd_kernel_packed, _fwd_kernel, _fwd_single_kernel) and
// fast3r_tpu/ops/batched_attention.py (_packed_kernel, _batched_kernel,
// _fusedqkv_kernel): one kernel serves the encoder's many short heads (20
// views x 16 heads, N = 768, read in place from the packed (3, V, N, C) qkv
// buffer) and the decoder's few long ones (16 heads, N = 15360).
//
// What bounds it on an H100: at head_dim 64 attention does 4 * 64 FLOPs per
// (query, key) pair against 2 * 64 * 2 bytes of K/V per key, reused by every
// query of a block, so it is bound by the tensor cores (4 N^2 H D FLOPs at
// 989 TFLOP/s) and, nearly as much, by the softmax's exponentials: N^2 H of
// them on MUFU's 16 a clock per SM.  Design (bf16, the served and trained
// type): the tiles of attention_fwd_tile.cuh (wgmma m64n128 scores and
// m64n64 P V with P kept in registers, fed by TMA from a producer warp; two
// consumer warpgroups taking turns, so one's exponentials run while the
// other's products do; its note has the per-tile schedule), walked by a
// persistent grid: CTA c takes items c, c + G, ... of (batch * head, 128-
// query block), head-major so the CTAs in flight share K and V in L2, and
// an item's epilogue (o through a staging box and TMA stores) overlaps the
// next item's loads.  G = the SM count by default; G = the item count
// gives one CTA per item.
// q, k and v are read through rank-4 tensor maps (64, N, H, B) built from
// their (batch, token, head) strides, so the decoder's (B, N, 3, H, 64)
// views and the encoder's packed slices need no copy (the wrapper copies a
// layout TMA cannot take, and counts it); TMA's zero fill stops at N, not
// at the next batch.  The output is contiguous (B, N, H, D).  Head_dim 80
// (model_scaling_huge's decoder) is the same kernel instantiated at D = 80:
// each row also comes in as a 16-column, 32-byte-swizzled tail box
// (attention_fwd_tile.cuh's note), and the head_dim-64 instantiation is
// the code it was.  For training
// the kernel also writes the rows' fp32 logsumexp (lse, natural log), which
// the backward (attention_bwd.cu) reads; inference passes no lse buffer.
// The fp32 kernel (used to check the algorithm tightly on the card) is a
// scalar version of a 64-query tiling, for either head_dim.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_fwd_tile.cuh"

namespace {

using namespace fast3r_attn_fwd;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 kernel (attention_fwd_tile.cuh)
// ---------------------------------------------------------------------------

struct FwdArgs {
  CUtensorMap mq, mk, mv, mo;  // (D, N, H, B); q, k, v: 128-row boxes, o: 64-row
  CUtensorMap mqt, mkt, mvt;   // D = 80: the 16-column tail boxes of q, k, v
  float* lse;                  // [(b * H + h) * ldl + n], or null
  bf16* o;                     // contiguous (B, Nq, H, D): D = 80's tail stores
  int H, Nq, Nk, ldl, items;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ FwdArgs a) {
  Smem& s = smem();
  if (threadIdx.x == 0) init_barriers(s);
  __syncthreads();
  const int nblk = (a.Nq + kRows - 1) / kRows, n = (a.Nk + kKeys - 1) / kKeys;
  OwnRing own;
  StageRing ring;
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread loads
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers)
      for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
        const int bh = it / nblk, b = bh / a.H, h = bh % a.H;
        load_item<D>(s, own, ring, &a.mq, (it % nblk) * kRows, h, b, &a.mk, &a.mv, h, b, n,
                     TailMaps{&a.mqt, &a.mkt, &a.mvt});
      }
    return;
  }
  regs_inc<kConsumerRegs>();
  const Consumer t;
  ab::turns_open(t);
  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const int bh = it / nblk, b = bh / a.H, h = bh % a.H, row0 = (it % nblk) * kRows;
    State x;
    x.zero();
    float ot[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    fwd_item<D>(x, ot, s, own, ring, t, n, a.Nk, a.scale_log2);
    store_item<D>(x, s, t, &a.mo, row0, h, b,
                  a.lse == nullptr ? nullptr : a.lse + (long long)bh * a.ldl, a.Nq,
                  a.scale_log2, ot, a.o + ((long long)b * a.Nq * a.H + h) * D + 64,
                  (long long)a.H * D);
  }
  ab::turns_close(t);
  drain_stores();
}

// the rank-4 map (D, N, H, B) of a (B, N, H, D) tensor through its
// (batch, token, head) strides in elements, in boxes of `rows` rows of 64
// columns (tail: of 16 columns, 32-byte swizzled)
cudaError_t map4(CUtensorMap* m, const void* base, int D, int B, int N, int H,
                 long long sb, long long sn, long long sh, int rows, bool tail = false) {
  const long long dims[4] = {D, N, H, B};
  const long long strides[3] = {sn, sh, sb};
  return tail ? make_tmap_sw32(m, base, 4, dims, strides, rows)
              : make_tmap(m, base, 4, dims, strides, rows);
}

template <int D>
cudaError_t launch_bf16(FwdArgs& a, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Nq, int Nk, long long qsb, long long qsn,
                        long long qsh, long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh, int ctas,
                        cudaStream_t st) {
  cudaError_t err;
  const long long os = (long long)H * D;  // o's token stride
  if ((err = map4(&a.mq, q, D, B, Nq, H, qsb, qsn, qsh, kRows)) != cudaSuccess ||
      (err = map4(&a.mk, k, D, B, Nk, H, ksb, ksn, ksh, kKeys)) != cudaSuccess ||
      (err = map4(&a.mv, v, D, B, Nk, H, vsb, vsn, vsh, kKeys)) != cudaSuccess ||
      (err = map4(&a.mo, o, D, B, Nq, H, Nq * os, os, D, 64)) != cudaSuccess)
    return err;
  if (D > 64) {
    if ((err = map4(&a.mqt, q, D, B, Nq, H, qsb, qsn, qsh, kRows, true)) != cudaSuccess ||
        (err = map4(&a.mkt, k, D, B, Nk, H, ksb, ksn, ksh, kKeys, true)) != cudaSuccess ||
        (err = map4(&a.mvt, v, D, B, Nk, H, vsb, vsn, vsh, kKeys, true)) != cudaSuccess)
      return err;
  } else {
    a.mqt = a.mkt = a.mvt = a.mq;  // unused
  }
  a.o = static_cast<bf16*>(o);
  const int sms = sm_count();
  if (sms == 0) return cudaErrorNoDevice;
  const int grid = ctas > 0 ? ctas : (a.items < sms ? a.items : sms);
  static unsigned attr_set = 0;  // a bit per device whose attribute is set
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (!(attr_set >> dev & 1u)) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (err != cudaSuccess) return err;
    attr_set |= 1u << dev;
  }
  attention_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 kernel (scalar FMAs, same tiling; two lanes per query row)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // fp32: query rows per block, 16 per warp
constexpr int kBK = 64;       // fp32: keys per tile
constexpr int kThreadsF = 128;
constexpr int kLdS = kBK + 4;  // fp32 score / probability rows
template <int D>
__host__ __device__ constexpr int ld_f32() { return D + 4; }  // 272- or 336-byte rows
template <int D>
constexpr int smem_f32() { return (3 * 64 * ld_f32<D>() + kBQ * kLdS) * (int)sizeof(float); }

template <int D>
__device__ inline void load_tile_f32(float* dst, const float* src,
                                     long long s_tok, int row0, int n_valid) {
  for (int c = threadIdx.x; c < 64 * (D / 4); c += kThreadsF) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const int n = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid)
      val = *reinterpret_cast<const float4*>(src + (long long)n * s_tok + col);
    *reinterpret_cast<float4*>(dst + r * ld_f32<D>() + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int H, int Nq, int Nk, long long qsb, long long qsn,
                         long long qsh, long long ksb, long long ksn,
                         long long ksh, long long vsb, long long vsn,
                         long long vsh, float scale_log2,
                         float* __restrict__ lse, int ldl) {
  constexpr int kLdF = ld_f32<D>(), kHalfD = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * kLdF;
  float* Vs = Ks + kBK * kLdF;
  float* Ps = Vs + kBK * kLdF;  // scores, then probabilities

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;  // this lane's query row in the tile
  const int c0 = (lane & 1) * 32;      // its half of the keys
  const int d0 = (lane & 1) * kHalfD;  // and of D

  load_tile_f32<D>(Qs, q + b * qsb + h * qsh, qsn, q0, Nq);
  __syncthreads();
  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = Qs[r * kLdF + d];

  float acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();
    load_tile_f32<D>(Ks, k + b * ksb + h * ksh, ksn, k0, Nk);
    load_tile_f32<D>(Vs, v + b * vsb + h * vsh, vsn, k0, Nk);
    __syncthreads();

    float s[32];
    float tmax = -CUDART_INF_F;
    for (int i = 0; i < 32; ++i) {
      const float* krow = Ks + (c0 + i) * kLdF;
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qreg[d], krow[d], x);
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
    for (int i = 0; i < kHalfD; ++i) acc[i] *= alpha;
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * kLdS + j];
      const float* vrow = Vs + j * kLdF + d0;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(p, vrow[i], acc[i]);
    }
    __syncwarp();
  }

  const int n = q0 + r;
  if (lse != nullptr && c0 == 0 && n < Nq)
    lse[((long long)b * H + h) * ldl + n] = (m + log2f(l)) * kLn2;
  if (n < Nq) {
    const float inv = 1.f / l;
    float* dst = o + (((long long)b * Nq + n) * H + h) * D + d0;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) dst[i] = acc[i] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Nq, int Nk, long long qsb, long long qsn, long long qsh,
                       long long ksb, long long ksn, long long ksh, long long vsb,
                       long long vsn, long long vsh, float scale_log2, void* lse, int ldl,
                       cudaStream_t st) {
  const dim3 grid((Nq + kBQ - 1) / kBQ, H, B);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f32<D>());
  if (err != cudaSuccess) return err;
  attention_fwd_f32_kernel<D><<<grid, kThreadsF, smem_f32<D>(), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Nq, Nk, qsb,
      qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, scale_log2,
      static_cast<float*>(lse), ldl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the bf16 forward kernels on
// attention_fwd_tile.cuh at head_dim 64 (K1's and the bf16 ring of
// csrc/ring_attention.cu); K1 at head_dim 80 takes
// fast3r_attention_fwd_smem_bytes_d80().
int fast3r_attention_fwd_smem_bytes() { return kSmemBytes; }
int fast3r_attention_fwd_smem_bytes_d80() { return smem_bytes<80>(); }

// dtype: 0 = float32, 1 = bfloat16; D: the head_dim, 64 or 80.  Strides are
// in elements (bf16: 16-byte aligned bases and strides, as TMA takes them;
// fp32: 16-byte rows; the wrapper checks both).  o: contiguous
// (B, Nq, H, D).  lse (may be null): fp32 natural-log logsumexp per query
// row, at lse[(b * H + h) * ldl + n].  ctas (bf16): CTAs of the persistent
// walk, 0 for one per SM.  Returns cudaGetLastError().
int fast3r_attention_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Nq, int Nk,
                         long long qsb, long long qsn, long long qsh,
                         long long ksb, long long ksn, long long ksh,
                         long long vsb, long long vsn, long long vsh,
                         float scale, void* lse, int ldl, int ctas, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || ctas < 0 || (D != 64 && D != 80))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dtype == 1) {
    FwdArgs a;
    a.lse = static_cast<float*>(lse);
    a.H = H;
    a.Nq = Nq;
    a.Nk = Nk;
    a.ldl = ldl;
    a.items = B * H * ((Nq + kRows - 1) / kRows);
    a.scale_log2 = scale_log2;
    return D == 64 ? launch_bf16<64>(a, q, k, v, o, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn,
                                     ksh, vsb, vsn, vsh, ctas, st)
                   : launch_bf16<80>(a, q, k, v, o, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn,
                                     ksh, vsb, vsn, vsh, ctas, st);
  }
  if (dtype == 0)
    return D == 64 ? launch_f32<64>(q, k, v, o, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn, ksh,
                                    vsb, vsn, vsh, scale_log2, lse, ldl, st)
                   : launch_f32<80>(q, k, v, o, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn, ksh,
                                    vsb, vsn, vsh, scale_log2, lse, ldl, st);
  return cudaErrorInvalidValue;
}

const char* fast3r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
