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
//                        narrower than q; the attention kernel reads
//                        strided views and the rotary step makes new
//                        tensors anyway)
// and, for the training backward, _ln_matmul_replay_kernel and
// _rms_matmul_replay_kernel (the replays): with a norm prologue the same
// launch also writes the backward's residuals, u = the normalised x in
// bf16 (the product's A operand) and the rows' fp32 rstd (LN: and mean),
// and with GELU or SiLU the bf16 pre-activation z.  One template covers all
// of them: the prologue (none, LN or RMS) and the epilogue are compile-time
// modes; the replay outputs are optional pointers.  The RMS products are
// bias-free: their launches pass a null bias and read none.
//
// What bounds it on an H100: at the flagship's 15360 rows the products do
// 2 * M * K * N FLOPs against (M K + K N + M N) * 2 bytes, 300-700 FLOPs a
// byte, so the tensor cores bound them (qkv 0.098 ms, proj 0.033 ms at the
// published 989 TFLOP/s).  The design is a plain mma.sync GEMM that keeps
// the elementwise work of the block out of device memory:
//   * one block = a 128 x 128 output tile, 4 warps of 64 x 64 (16 ldmatrix
//     per 64 mma); K streams through shared memory in 32-wide slices, four
//     stages deep, with cp.async; m16n8k16 bf16 mma with fp32 accumulators;
//   * LN prologue (K <= 1024, the model width): each block first takes its
//     128 rows' fp32 two-pass mean and rstd from registers (four rows'
//     loads in flight per warp), while the first slices are in flight.  The
//     whole normalised 128-row tile (256 KB) would not fit a block's 227 KB,
//     so raw A slices land in their own ring and each thread normalises the
//     chunks its own cp.async brought (no barrier needed for that) into a
//     double-buffered tile one slice ahead of the products: fp32 affine,
//     rounded to bf16 (the TPU kernel's rounding point), one barrier a
//     slice as without the prologue;
//   * RMS prologue (llama; same shared-memory layout and launch shape as
//     LN, beta's space unused): one fp32 pass for the rows' sum of squares,
//     rstd = rsqrt(mean(x^2) + eps), then the two roundings of the JAX
//     package's _rms_f32: bf16(x * rstd), then bf16(that * gamma).  The
//     wrapper passes gamma already rounded to bf16 for the forward (a
//     product of two bf16 values is exact in fp32, so one rounding of it is
//     JAX's bf16 multiply) and as given for the replay, which multiplies by
//     the fp32 gamma as _rms_matmul_replay_kernel does;
//   * replay: every column-tile block of a row tile computes the same
//     statistics and normalised slices, so only the blocks of column tile
//     0 write u, mean and rstd (each row once); u is written from the
//     double-buffered normalised slice as it is made, one 16-byte chunk per
//     thread, and z from the GELU / SiLU epilogue's registers;
//   * epilogues work on the accumulators in registers: bias, GELU, SiLU
//     (exact division, on the fp32 accumulators, rounded once), the
//     residual tile read straight from device memory and added in fp32 with
//     a single rounding, or RoPE: q and k are rounded to bf16 first, then
//     rotated in fp32 with the bf16 lane tables.  A warp's 64 columns are
//     one head, two 32-lane rotate-half groups, so each value's partner
//     (16 lanes away) sits in the same thread's registers.
// Constraints (the wrapper checks them): K % 32 == 0 (LN and RMS:
// K % 256 == 0 and K <= 1024), N % 128 == 0, rows 16 bytes aligned; q|k|v
// modes need
// C = N / 3 with C % 128 == 0, RoPE a head_dim of 64.  M may be ragged.
// Not yet: wgmma, TMA, warp specialisation, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kThreads = 128;             // 2 x 2 warps of 64 x 64
constexpr int kLd = kBK + 8;              // 80-byte smem rows: ldmatrix conflict-free
constexpr int kTile = kBM * kLd;          // one padded 128 x 32 tile (A or B)
constexpr int kRaw = kBM * kBK;           // one raw 128 x 32 A tile
constexpr int kMaxLnK = 1024;  // LN / RMS prologue: K <= 1024, K % 256 == 0
constexpr int kSmemLN = (kStages * kTile + 2 * kTile + kStages * kRaw) * 2 +
                        (2 * kMaxLnK + 2 * kBM) * 4;
constexpr int kSmemPlain = 2 * kStages * kTile * 2;

enum Prologue { kNoNorm = 0, kLN = 1, kRMS = 2 };
enum Epilogue {
  kBias = 0, kGelu = 1, kQkv = 2, kRope = 3, kResidual = 4, kSilu = 5
};

struct GemmArgs {
  const bf16* x;       // (M, K)
  const float* gamma;  // (K,) LN / RMS scale (prologue only)
  const float* beta;   // (K,) LN shift
  const bf16* w;       // (N, K)
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

template <int kPro, int kEpi>
__global__ void __launch_bounds__(kThreads)
fused_gemm_kernel(const GemmArgs a) {
  constexpr bool kNorm = kPro != kNoNorm;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // B ring | A: the ring (no prologue) or two normalised tiles (LN, RMS) |
  // norm prologues only: the raw A ring, gamma, beta (LN), row mean (LN),
  // row rstd
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);
  bf16* sA = sB + kStages * kTile;
  bf16* sRaw = sA + 2 * kTile;
  float* sGamma = reinterpret_cast<float*>(sRaw + kStages * kRaw);
  float* sBeta = sGamma + kMaxLnK;
  float* sMean = sBeta + kMaxLnK;
  float* sRstd = sMean + kBM;

  const int M = a.M, N = a.N, K = a.K;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, c = lane & 3;    // mma fragment row / column pair
  // this thread copies (and, with LN, normalises) the 16-byte chunks at
  // rows lrow + 32 j, columns lch .. lch + 7 of every 128 x 32 slice
  const int lrow = tid >> 2, lch = (tid & 3) * 8;
  const bool replay = a.u != nullptr && blockIdx.x == 0;

  auto issue = [&](int kt) {
    const int slot = kt % kStages, k0 = kt * kBK;
    bf16* dA = kNorm ? sRaw + slot * kRaw : sA + slot * kTile;
    const int ldA = kNorm ? kBK : kLd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = lrow + 32 * j, row = m0 + r;
      const bool ok = row < M;
      cp_async16(dA + r * ldA + lch,
                 ok ? a.x + (long long)row * K + k0 + lch : a.x, ok);
      cp_async16(sB + slot * kTile + r * kLd + lch,
                 a.w + (long long)(n0 + r) * K + k0 + lch, true);
    }
  };

  // own chunks of raw slice kt -> normalised tile kt & 1 (LN: fp32 affine,
  // rounded to bf16; RMS: bf16(bf16(x * rstd) * gamma)); reads only what
  // this thread's cp.async wrote
  auto normalize = [&](int kt) {
    const bf16* src = sRaw + (kt % kStages) * kRaw;
    bf16* dst = sA + (kt & 1) * kTile;
    const int k = kt * kBK + lch;
    const float4 g0 = *reinterpret_cast<const float4*>(sGamma + k);
    const float4 g1 = *reinterpret_cast<const float4*>(sGamma + k + 4);
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    float bb[8] = {};
    if constexpr (kPro == kLN) {
      const float4 b0 = *reinterpret_cast<const float4*>(sBeta + k);
      const float4 b1 = *reinterpret_cast<const float4*>(sBeta + k + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) bb[e] = bv[e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = lrow + 32 * j;
      const float rs = sRstd[r];
      uint4 v = *reinterpret_cast<const uint4*>(src + r * kBK + lch);
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
      if constexpr (kPro == kLN) {
        const float mu = sMean[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(u[e]);
          u[e] = pack_bf16((f.x - mu) * rs * gg[2 * e] + bb[2 * e],
                           (f.y - mu) * rs * gg[2 * e + 1] + bb[2 * e + 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(u[e]);
          u[e] = pack_bf16(round_bf16(f.x * rs) * gg[2 * e],
                           round_bf16(f.y * rs) * gg[2 * e + 1]);
        }
      }
      *reinterpret_cast<uint4*>(dst + r * kLd + lch) = v;
      if (replay && m0 + r < M)
        *reinterpret_cast<uint4*>(a.u + (long long)(m0 + r) * K + k) = v;
    }
  };

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) issue(s);
    cp_async_commit();
  }

  if constexpr (kNorm) {
    for (int i = tid; i < K; i += kThreads) {
      sGamma[i] = a.gamma[i];
      if constexpr (kPro == kLN) sBeta[i] = a.beta[i];
    }
    // fp32 row statistics from registers (LN: two passes, mean then
    // variance; RMS: the sum of squares): 32 rows per warp, four rows'
    // loads in flight at a time, each lane holding K / 32 values
    const int nv = K / 256;
    for (int r0 = warp * 32; r0 < warp * 32 + 32; r0 += 4) {
      uint4 v[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + r0 + q;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[q][j] = (row < M && j < nv)
                        ? *reinterpret_cast<const uint4*>(
                              a.x + (long long)row * K + j * 256 + lane * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float mean = 0.f;  // RMS: no centring
        if constexpr (kPro == kLN) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t* u = reinterpret_cast<const uint32_t*>(&v[q][j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(u[e]);
              s += f.x + f.y;
            }
          }
          mean = warp_sum(s) / K;
        }
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nv) continue;
          const uint32_t* u = reinterpret_cast<const uint32_t*>(&v[q][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(u[e]);
            ss += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
          }
        }
        const float rstd = rsqrtf(warp_sum(ss) / K + a.eps);
        if (lane == 0) {
          sMean[r0 + q] = mean;
          sRstd[r0 + q] = rstd;
          if (replay && m0 + r0 + q < M) {
            if constexpr (kPro == kLN) a.mean[m0 + r0 + q] = mean;
            a.rstd[m0 + r0 + q] = rstd;
          }
        }
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of slice 0
    __syncthreads();               // statistics, gamma and beta
    normalize(0);
  }

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    // norm prologues: raw slice kt + 1 must have landed too, to normalise
    // it below
    cp_async_wait<kNorm ? kStages - 3 : kStages - 2>();
    __syncthreads();  // normalised / staged slice kt visible; kt - 1 done
    if constexpr (kNorm) {
      if (kt + 1 < KT) normalize(kt + 1);
    }
    if (kt + kStages - 1 < KT) issue(kt + kStages - 1);
    cp_async_commit();

    const bf16* At = sA + (kNorm ? (kt & 1) : (kt % kStages)) * kTile;
    const bf16* Bt = sB + (kt % kStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], At + (wm * 64 + mi * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * kLd +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n8 tiles 2 np and 2 np + 1
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Bt + (wn * 64 + np * 16 + (lane & 7) +
                               ((lane >> 4) << 3)) * kLd +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma16816(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma16816(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }

  // epilogue; this thread holds rows g, g + 8 and columns 2c, 2c + 1 of
  // every 16 x 8 tile of its warp's 64 x 64
  const int C = N / 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int col = n0 + wn * 64 + nj * 8 + 2 * c;
        float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if constexpr (kPro != kRMS) {  // the RMS products are bias-free
          v0 += a.bias[col];
          v1 += a.bias[col + 1];
        }
        if constexpr (kEpi == kBias || kEpi == kGelu || kEpi == kSilu ||
                      kEpi == kResidual) {
          const long long off = (long long)row * N + col;
          float o0 = v0, o1 = v1;
          if constexpr (kEpi == kGelu || kEpi == kSilu) {
            if (a.z != nullptr)
              *reinterpret_cast<uint32_t*>(a.z + off) = pack_bf16(v0, v1);
            o0 = kEpi == kGelu ? gelu_erf(v0) : silu(v0);
            o1 = kEpi == kGelu ? gelu_erf(v1) : silu(v1);
          }
          if constexpr (kEpi == kResidual) {
            const float2 r =
                unpack_bf16(*reinterpret_cast<const uint32_t*>(a.res + off));
            o0 = r.x + v0;
            o1 = r.y + v1;
          }
          *reinterpret_cast<uint32_t*>(a.out + off) = pack_bf16(o0, o1);
        } else {
          const int which = col / C, cc = col - which * C;
          const long long off = ((long long)which * M + row) * C + cc;
          float o0 = v0, o1 = v1;
          if (kEpi == kRope && which < 2) {
            // the rotate-half partner, 16 lanes away in the same 32-lane
            // group, is n8 tile nj ^ 2 of this warp's 64 columns
            const int pc = col ^ 16;
            const float p0 = round_bf16(acc[mi][nj ^ 2][2 * h] + a.bias[pc]);
            const float p1 =
                round_bf16(acc[mi][nj ^ 2][2 * h + 1] + a.bias[pc + 1]);
            const float sgn = ((nj & 3) < 2) ? -1.f : 1.f;
            const long long t = (long long)row * C + cc;
            const float2 ctv =
                unpack_bf16(*reinterpret_cast<const uint32_t*>(a.ct + t));
            const float2 stv =
                unpack_bf16(*reinterpret_cast<const uint32_t*>(a.st + t));
            o0 = round_bf16(v0) * ctv.x + sgn * p0 * stv.x;
            o1 = round_bf16(v1) * ctv.y + sgn * p1 * stv.y;
          }
          *reinterpret_cast<uint32_t*>(a.out + off) = pack_bf16(o0, o1);
        }
      }
    }
  }
}

template <int kPro, int kEpi>
cudaError_t launch(const GemmArgs& a, cudaStream_t st) {
  constexpr int smem = kPro != kNoNorm ? kSmemLN : kSmemPlain;
  cudaError_t err = cudaFuncSetAttribute(
      fused_gemm_kernel<kPro, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N / kBN, (a.M + kBM - 1) / kBM);
  fused_gemm_kernel<kPro, kEpi><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pro: 0 none, 1 LN, 2 RMS.  epi: 0 bias, 1 bias + GELU, 2 q|k|v split,
// 3 RoPE packed (these with the LN prologue), 4 bias + residual (no
// prologue); with the RMS prologue 0 (no bias) and 5 SiLU (no bias).
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
  a.w = static_cast<const bf16*>(w);
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
      (pro == kRMS) != (bias == nullptr))
    return cudaErrorInvalidValue;
  a.M = M;
  a.N = N;
  a.K = K;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pro == kLN) {
    switch (epi) {
      case kBias: return launch<kLN, kBias>(a, s);
      case kGelu: return launch<kLN, kGelu>(a, s);
      case kQkv: return launch<kLN, kQkv>(a, s);
      case kRope: return launch<kLN, kRope>(a, s);
    }
  } else if (pro == kRMS) {
    switch (epi) {
      case kBias: return launch<kRMS, kBias>(a, s);
      case kSilu: return launch<kRMS, kSilu>(a, s);
    }
  } else if (pro == kNoNorm && epi == kResidual) {
    return launch<kNoNorm, kResidual>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
