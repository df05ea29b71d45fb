// Fused-GEMM kernels of the ViT and llama blocks:
// y = epilogue(prologue(x) @ W^T + b), bf16 in and out, fp32 accumulation,
// W in the nn.Linear (N, K) layout.
//
// Replaces the TPU kernels of fast3r_tpu/nn/fused_block.py:
//   _ln_matmul_kernel   (LN prologue; bias, or bias then exact-erf GELU)
//   _ln_qkv_kernel      (LN prologue; bias, q | k | v split into (3, M, C))
//   _ln_qkv_rope_kernel (LN prologue; bias, RoPE2D on q and k, packed
//                        (3, M, C) store)
//   _matmul_res_kernel  (no prologue; bias + residual, rounded once)
//   _rms_matmul_kernel  (RMS prologue; no bias, or SiLU)
//   _rms_qkv3_kernel    (RMS prologue; no bias, the plain (M, N) store over
//                        the concatenated [wq | wk | wv]: q, k and v are
//                        column views of it, since with GQA k and v are
//                        narrower than q)
// and, for the training backward, _ln_matmul_replay_kernel and
// _rms_matmul_replay_kernel (the replays): with a norm prologue the same
// launch also writes the backward's residuals, u = the normalised x in bf16
// (the product's A operand) and the rows' fp32 rstd (LN: and mean), and
// with GELU or SiLU the bf16 pre-activation z.  One template covers all of
// them: the prologue (none, LN or RMS) and the epilogue are compile-time
// modes; the replay outputs are optional pointers.  The RMS products are
// bias-free: their launches pass a null bias and read none.
//
// What bounds it on an H100: at the flagship's 15360 rows the products do
// 2 M K N FLOPs against (M K + K N + M N) 2 bytes, 300-700 FLOPs a byte, so
// the tensor cores bound them (qkv 0.098 ms, proj 0.033 ms at the published
// 989 TFLOP/s).  Only wgmma reaches that rate, fed by TMA.
//
// Design (csrc/gemm_tile.cuh holds the tile, csrc/hopper.cuh the Hopper
// primitives):
//   * a persistent grid of one CTA per SM (384 threads: a TMA producer
//     warpgroup and two wgmma consumer warpgroups of 64 rows each,
//     setmaxnreg 40 / 232); CTA i takes the contiguous run
//     [T i / G, T (i + 1) / G) of the T output tiles, band-major, so it
//     walks consecutive column tiles of a row band and takes the band's
//     statistics once, and its producer loads the next tile while the
//     consumers run an epilogue;
//   * 128 x 256 tiles, K in 64-wide slices through a 4-stage TMA ring
//     (128-byte swizzle, full / empty mbarriers, no block barrier), wgmma
//     m64n256k16 with fp32 accumulators in registers; TMA zero-fills the
//     ragged M, N and K edges on load and clips them on store;
//   * LN prologue (K <= 1280, the model width: 768, 1024 or 1280): the
//     band's fp32 two-pass mean and rstd; each consumer warpgroup
//     normalises its rows of the raw swizzled x box in place, (x - mean)
//     rstd gamma + beta in fp32, rounded to bf16 (the TPU kernel's point),
//     and feeds wgmma from shared memory;
//   * RMS prologue (llama): rstd = rsqrt(mean(x^2) + eps), then the two
//     roundings of the JAX package's _rms_f32: bf16(x rstd), then bf16(that
//     gamma).  The wrapper passes gamma already rounded to bf16 for the
//     forward (a product of two bf16 values is exact in fp32, so one
//     rounding of it is JAX's bf16 multiply) and as given for the replay,
//     which multiplies by the fp32 gamma as _rms_matmul_replay_kernel does;
//   * replay: the tiles of column tile 0 write u from the normalised slices
//     as they are made and the rows' mean and rstd (each row once), and z
//     is the GELU / SiLU epilogue's pre-activation, stored first;
//   * epilogues work on the accumulators in registers (a thread holds rows
//     16 w + g and 16 w + g + 8 of its warp's strip, columns 8 j + 2 c +
//     {0, 1}) and go out box by box through shared memory by TMA stores
//     (the packed q | k | v buffer through a (C, M, 3) map): bias, GELU,
//     SiLU (exact division, on the fp32 accumulators, rounded once), the
//     residual loaded by TMA and added in fp32 with a single rounding, or
//     RoPE: q and k are rounded to bf16 first, then rotated in fp32 with
//     the bf16 lane tables; a head's 64 columns are 8 column groups, two
//     32-lane rotate-half halves, so each value's partner (16 columns
//     away) is group j ^ 2 in the same thread's registers.
// What it did about the mma.sync kernel's limits: wgmma instead of 16
// ldmatrix per 64 mma, TMA and mbarriers instead of cp.async and a block
// barrier per slice, the statistics once per band instead of once per
// column tile, no normalised copy of A, a persistent grid.  Measured at
// the flagship's shapes (python -m fast3r_torch.profile_request; NVIDIA
// H100 80GB HBM3, 700 W): ln_qkv 0.2625 ms a call, 368 TFLOP/s (the
// mma.sync kernel's 0.8846 ms, host time included: 109); ln_qkv_rope 0.4830 ms, 200 TFLOP/s; the
// fc1 GELU replay 0.5728 ms, 225; proj + residual 0.0756 ms, 426.  The
// epilogues (GELU, the RoPE tables) leave the tensor cores idle: see
// "Not yet".
// Constraints (the wrapper checks them): K % 32 == 0 (LN and RMS:
// K % 256 == 0 and K <= 1024; LN with bias, GELU or the q|k|v split also
// K <= 1280, in the wide instantiations), N % 128 == 0, rows and base 16 bytes aligned;
// q|k|v modes need C = N / 3 with C % 128 == 0, RoPE a head_dim of 64.  M
// may be ragged.
// Not yet: an epilogue that overlaps the next tile's products (the
// consumers' tensor cores idle during it: GELU and the RoPE tables cost
// most), 2-CTA clusters with TMA multicast of W, an fp8 road.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "ptx.cuh"

namespace {

using namespace fast3r_gemm;
using fast3r_ptx::gelu_erf;
using fast3r_ptx::silu;

enum Epilogue {
  kBias = 0, kGelu = 1, kQkv = 2, kRope = 3, kResidual = 4, kSilu = 5
};

struct GemmArgs {
  const bf16* x;       // (M, K)
  const float* gamma;  // (K,) LN / RMS scale (prologue only)
  const float* beta;   // (K,) LN shift
  const float* bias;   // (N,); null with the RMS prologue
  const bf16* res;     // (M, N) residual (kResidual)
  const bf16* ct;      // (M, N / 3) RoPE cos lanes (kRope)
  const bf16* st;      // (M, N / 3) RoPE sin lanes
  bf16* out;           // (M, N), or (3, M, N / 3) for kQkv / kRope
  bf16* u;             // replay (optional, norm prologues): (M, K) norm output
  float* mean;         // (M,) row mean (LN replay only)
  float* rstd;         // (M,) row 1 / sqrt(var + eps), or RMS's
  bf16* z;             // (M, N) pre-activation (kGelu, kSilu)
  int M, N, K;
  float eps;
};

// the tensor maps of a launch: A and B loads, the output's stores (2-D, or
// the (C, M, 3) map of the packed q | k | v buffer), the residual's loads,
// z's stores
struct Maps {
  CUtensorMap x, w, out, res, z;
};

// a consumer warpgroup's epilogue of the tile at (m0, n0), box by box
// through its staging: bias, activation, residual (loaded by TMA into the
// slot), RoPE (tables from device memory); each box's z first, where the
// replay asks for it
template <int kPro, int kEpi>
__device__ __forceinline__ void epilogue(const float (&acc)[kAcc],
                                         const GemmArgs& a, Smem& s,
                                         const Consumer& t, const Maps& mp,
                                         int m0, int n0,
                                         unsigned& res_phase) {
  const int M = a.M, N = a.N, C = N / 3;
  const int rw = m0 + t.wg * 64, r0 = t.warp * 16 + t.g();
  // the RMS products are bias-free
  if constexpr (kPro != kRMS) out_bias(s, t, a.bias, n0, N);
  auto bias = [&](int j) {
    return kPro != kRMS ? tile_bias(s, t, 8 * j + 2 * t.c())
                        : make_float2(0.f, 0.f);
  };
#pragma unroll
  for (int bx = 0; bx < kBN / 64; ++bx) {
    const int cb = n0 + 64 * bx;  // the box's first column
    if constexpr (kEpi == kGelu || kEpi == kSilu) {
      if (a.z != nullptr) {  // the pre-activation, for the backward
        char* box = out_begin(s, t);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * bx + jj;
          const float2 b = bias(j);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out_put(box, r0 + 8 * h, 8 * jj + 2 * t.c(),
                    pack_bf16(acc[4 * j + 2 * h] + b.x,
                              acc[4 * j + 2 * h + 1] + b.y));
        }
        out_store(t, box, &mp.z, cb, rw, N);
      }
    }
    char* box = out_begin(s, t);
    if constexpr (kEpi == kResidual)
      out_load(s, t, box, &mp.res, cb, rw, res_phase);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * bx + jj, cl = 8 * jj + 2 * t.c(), col = cb + cl;
      const float2 b = bias(j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, row = rw + r;
        const float v0 = acc[4 * j + 2 * h] + b.x;
        const float v1 = acc[4 * j + 2 * h + 1] + b.y;
        float o0 = v0, o1 = v1;
        if constexpr (kEpi == kGelu) {
          o0 = gelu_erf(v0);
          o1 = gelu_erf(v1);
        } else if constexpr (kEpi == kSilu) {
          o0 = silu(v0);
          o1 = silu(v1);
        } else if constexpr (kEpi == kResidual) {
          const float2 rr = out_get(box, r, cl);
          o0 = rr.x + v0;
          o1 = rr.y + v1;
        } else if constexpr (kEpi == kRope) {
          const int which = col / C, cc = col - which * C;
          if (which < 2 && row < M) {
            // the rotate-half partner, 16 columns away in the same 32-lane
            // half of the head: column group j ^ 2
            const float2 pb = bias(j ^ 2);
            const float p0 = round_bf16(acc[4 * (j ^ 2) + 2 * h] + pb.x);
            const float p1 = round_bf16(acc[4 * (j ^ 2) + 2 * h + 1] + pb.y);
            const float sgn = ((j & 3) < 2) ? -1.f : 1.f;
            const long long tt = (long long)row * C + cc;
            const float2 ctv = unpack_bf16(
                __ldg(reinterpret_cast<const unsigned*>(a.ct + tt)));
            const float2 stv = unpack_bf16(
                __ldg(reinterpret_cast<const unsigned*>(a.st + tt)));
            o0 = round_bf16(v0) * ctv.x + sgn * p0 * stv.x;
            o1 = round_bf16(v1) * ctv.y + sgn * p1 * stv.y;
          }
        }
        out_put(box, r, cl, pack_bf16(o0, o1));
      }
    }
    out_store(t, box, &mp.out, cb, rw, N,
              (kEpi == kQkv || kEpi == kRope) ? C : 0);
  }
}

template <int kPro, int kEpi, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
fused_gemm_kernel(const __grid_constant__ Maps mp, const GemmArgs a) {
  Smem& s = smem();
  if (threadIdx.x == 0) init_barriers(s);
  load_norm_params<kPro>(s, a.gamma, a.beta, a.K);
  __syncthreads();

  const int M = a.M, K = a.K;
  const int nN = (a.N + kBN - 1) / kBN, T = ((M + kBM - 1) / kBM) * nN;
  const int lo = (int)((long long)T * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)T * (blockIdx.x + 1) / gridDim.x);
  const int KT = (K + kBK - 1) / kBK;

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring<kStages> ring;
      for (int t = lo; t < hi; ++t)
        load_tile(s, ring, &mp.x, &mp.w, (t / nN) * kBM, (t % nN) * kBN, KT);
    }
  } else {  // consumer warpgroups
    regs_inc<kConsumerRegs>();
    const Consumer th;
    Ring<kStages> ring;
    RowStats rstat;
    int band = -1;
    unsigned res_phase = 0;
    float acc[kAcc];
    for (int t = lo; t < hi; ++t) {
      const int mt = t / nN, nt = t % nN, m0 = mt * kBM;
      // the replay's residuals come from the tiles of column tile 0
      const bool rep = a.u != nullptr && nt == 0;
      if (kPro != kNoNorm && mt != band) {
        band = mt;
        rstat = row_stats<kPro, kWide>(a.x, M, K, a.eps, m0 + th.row0(),
                                rep ? a.mean : nullptr, rep ? a.rstd : nullptr);
      }
      mainloop<kPro>(acc, s, ring, KT, th, rstat, rep ? a.u : nullptr, m0, M,
                     K);
      epilogue<kPro, kEpi>(acc, a, s, th, mp, m0, nt * kBN, res_phase);
    }
    if (th.leader) bulk_wait<0>();  // the last stores written
  }
}

template <int kPro, int kEpi, bool kWide = false>
cudaError_t launch(const GemmArgs& a, const void* w, cudaStream_t st) {
  static bool configured = false;
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(fused_gemm_kernel<kPro, kEpi, kWide>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long M = a.M, N = a.N, K = a.K, C = N / 3;
  Maps mp;
  if ((err = make_tmap(&mp.x, a.x, M, K, K, kBM)) != cudaSuccess ||
      (err = make_tmap(&mp.w, w, N, K, K, kBN)) != cudaSuccess)
    return err;
  if (kEpi == kQkv || kEpi == kRope) {  // (3, M, C) as (C, M, 3)
    const long long dims[3] = {C, M, 3}, strides[2] = {C, M * C};
    err = make_tmap(&mp.out, a.out, 3, dims, strides, 64);
  } else {
    err = make_tmap(&mp.out, a.out, M, N, N, 64);
  }
  if (err != cudaSuccess) return err;
  mp.res = mp.z = mp.out;  // unused unless set below
  if (a.res != nullptr &&
      (err = make_tmap(&mp.res, a.res, M, N, N, 64)) != cudaSuccess)
    return err;
  if (a.z != nullptr && (err = make_tmap(&mp.z, a.z, M, N, N, 64)) != cudaSuccess)
    return err;
  const int tiles = ((a.M + kBM - 1) / kBM) * ((a.N + kBN - 1) / kBN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  fused_gemm_kernel<kPro, kEpi, kWide>
      <<<tiles < sms ? tiles : sms, kThreads, kSmemBytes, st>>>(mp, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the dynamic shared memory of a fused_gemm_kernel or ln_mlp_kernel CTA
int fast3r_gemm_smem_bytes() { return kSmemBytes; }

// pro: 0 none, 1 LN, 2 RMS.  epi: 0 bias, 1 bias + GELU, 2 q|k|v split,
// 3 RoPE packed (these with the LN prologue), 4 bias + residual (no
// prologue), and 0 without a prologue (a tensor-parallel rank's partial
// row-parallel product, the residual added on another rank); with the RMS
// prologue 0 (no bias) and 5 SiLU (no bias).
// bf16 tensors, fp32 gamma / beta / bias; bias null with RMS.  u, rstd
// (and with LN mean: all or none; norm prologues only) and z (GELU / SiLU
// only) may be null: given, the launch is the replay and also writes them.
// Returns cudaGetLastError() after the launch.
int fast3r_fused_gemm(int pro, int epi, const void* x, const void* gamma,
                      const void* beta, const void* w, const void* bias,
                      const void* res, const void* ct, const void* st,
                      void* out, void* u, void* mean, void* rstd, void* z,
                      int M, int N, int K, float eps, void* stream) {
  GemmArgs a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.ct = static_cast<const bf16*>(ct);
  a.st = static_cast<const bf16*>(st);
  a.out = static_cast<bf16*>(out);
  a.u = static_cast<bf16*>(u);
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.z = static_cast<bf16*>(z);
  const bool rep = u != nullptr;
  if (rep != (rstd != nullptr) || (rep && pro == kNoNorm) ||
      (mean != nullptr) != (rep && pro == kLN) ||
      (z != nullptr && epi != kGelu && epi != kSilu) ||
      (pro == kRMS) != (bias == nullptr) ||
      (pro != kNoNorm && (K % 256 || K > kMaxNormK)))
    return cudaErrorInvalidValue;
  if ((epi == kResidual) != (res != nullptr) || (epi == kRope) != (ct != nullptr))
    return cudaErrorInvalidValue;
  a.M = M;
  a.N = N;
  a.K = K;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pro == kLN && K > kNarrowK) {  // the model_scaling_huge decoder's 1280
    switch (epi) {
      case kBias: return launch<kLN, kBias, true>(a, w, s);
      case kGelu: return launch<kLN, kGelu, true>(a, w, s);
      case kQkv: return launch<kLN, kQkv, true>(a, w, s);
    }
    return cudaErrorInvalidValue;  // RoPE: the encoder's width only
  }
  if (pro == kRMS && K > kNarrowK) return cudaErrorInvalidValue;
  if (pro == kLN) {
    switch (epi) {
      case kBias: return launch<kLN, kBias>(a, w, s);
      case kGelu: return launch<kLN, kGelu>(a, w, s);
      case kQkv: return launch<kLN, kQkv>(a, w, s);
      case kRope: return launch<kLN, kRope>(a, w, s);
    }
  } else if (pro == kRMS) {
    switch (epi) {
      case kBias: return launch<kRMS, kBias>(a, w, s);
      case kSilu: return launch<kRMS, kSilu>(a, w, s);
    }
  } else if (pro == kNoNorm && epi == kResidual) {
    return launch<kNoNorm, kResidual>(a, w, s);
  } else if (pro == kNoNorm && epi == kBias) {
    return launch<kNoNorm, kBias>(a, w, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
