// The output tile of the port's Hopper GEMM kernels (csrc/fused_gemm.cu and
// csrc/ln_mlp.cu): 128 x 256 of prologue(A) B^T, bf16 in, fp32 accumulators,
// B in the nn.Linear (N, K) layout, over K in 64-wide slices.
//
// A CTA is 3 warpgroups.  Warpgroup 0 is the producer: one thread issues the
// TMA loads of each slice (the raw 128 x 64 A box and the 256 x 64 B box,
// 128-byte swizzled) into a ring of 4 shared-memory stages, each with a full
// and an empty mbarrier; the others idle.  Warpgroups 1 and 2 are the
// consumers: each owns 64 rows of the tile and issues one wgmma m64n256k16
// per 16-deep step, A and B from shared memory (SS), 128 fp32 accumulators a
// thread.  With a norm prologue (LN, RMS) each consumer warpgroup first
// normalises its 64 rows of the raw swizzled A box in place, in fp32 with
// the rows' statistics and the fp32 gamma (and beta) in shared memory,
// rounded to bf16 at the TPU kernel's point: no second, normalised tile in
// shared memory and no block barrier (a proxy fence and the warpgroup's
// named barrier).  Two slices are in flight per consumer (wait_group 1); a
// stage goes back to the producer when the wgmma that read it has retired
// (one arrival per consumer warp).
//
// The rows' statistics (LN: fp32 two-pass mean and rstd; RMS: rstd of the
// mean square) come from device memory, each consumer warp its 16 rows, four
// rows' loads in flight, K <= 1280: a lane holds K / 32 values of a row as
// K / 256 16-byte chunks (768, 1024 and 1280, the decoder widths of the
// flagship and the model_scaling variants, are 3, 4 and 5), the first four
// in registers; the wide instantiations (K > 1024) read a fifth again in
// each pass (row_stats).
//
// The epilogue goes through shared memory, one 64 x 64 box at a time: each
// consumer warpgroup writes the box's bf16 results into its staging box
// (128-byte swizzled) and its leader stores it with one TMA store; a
// residual box comes in the same way.  The tile's bias is copied to shared
// memory first, and each box's barriers keep the compiler from hoisting its
// loads above the last box's stores, so they never all sit in registers at
// once (that spilled kilobytes a thread).  Four ring stages and one staging box each
// fill the 227 KB: the fourth stage keeps enough slices in flight for the
// plain products, and a bigger staging would cost it.
//
// Tried and dropped on the H100 (slower there): A from registers (RS wgmma,
// each thread normalising its own fragment: ptxas serialised the wgmma,
// C7513); stores straight from the accumulator layout (4-byte pieces of 8
// rows per warp instruction); a ping-pong pair of consumers on 128 x 128
// tiles, with 4 or 6 stages (one consumer's m64n128 mainloop alone runs
// well below two consumers' m64n256 one); an epilogue warpgroup fed fp32
// chunks by the consumers (its 3 warps cannot keep up); gamma and beta
// read through L1 instead of shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace fast3r_gemm {

using namespace fast3r_hopper;
using fast3r_ptx::pack_bf16;
using fast3r_ptx::round_bf16;
using fast3r_ptx::unpack_bf16;
using fast3r_ptx::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBK = 64, kBN = 256;
constexpr int kStages = 4;
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kAcc = kBN / 2;    // fp32 accumulators a consumer thread
constexpr int kATile = kBM * kBK * 2, kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kMaxNormK = 1280;  // the norm prologues: K <= 1280, K % 256 == 0
constexpr int kNarrowK = 1024;   // past it, the wide instantiations (row_stats)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232

constexpr int kOutBox = 64 * 64 * 2;  // a 64 x 64 bf16 box of the output

enum Prologue { kNoNorm = 0, kLN = 1, kRMS = 2 };

struct Smem {
  char stage[kStages][kStageBytes];  // A box, then B box; 1024-byte aligned
  char out[2][kOutBox];  // each consumer warpgroup's staging box
  float gamma[kMaxNormK], beta[kMaxNormK];
  float bias[2][kBN];  // each consumer warpgroup's copy of the tile's bias
  uint64_t full[kStages], empty[kStages];
  uint64_t item_full[2], item_empty[2];  // a walk's claimed items (ln_mlp)
  uint64_t res_full[2];                  // each warpgroup's residual box
  int item[2];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t off = smem_u32(smem_raw);
  return *reinterpret_cast<Smem*>(smem_raw + ((1024u - (off & 1023u)) & 1023u));
}

// thread 0: the barriers of the stage ring and the item ring
__device__ __forceinline__ void init_barriers(Smem& s) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], kConsumerWarps);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&s.item_full[i], 1);
    mbar_init(&s.item_empty[i], kConsumerWarps);
    mbar_init(&s.res_full[i], 1);
  }
  mbar_init_fence();
}

// every thread of the CTA: gamma (and, LN, beta) into shared memory
template <int kPro>
__device__ __forceinline__ void load_norm_params(Smem& s, const float* gamma,
                                                 const float* beta, int K) {
  if constexpr (kPro != kNoNorm) {
    for (int i = threadIdx.x; i < K; i += kThreads) {
      s.gamma[i] = gamma[i];
      if constexpr (kPro == kLN) s.beta[i] = beta[i];
    }
  }
}

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

// the producer thread: the KT slices of one tile, A rows [a_row, a_row + 128)
// of map ma and B rows [b_row, b_row + kBN) of map mb
__device__ __forceinline__ void load_tile(Smem& s, Ring<kStages>& ring,
                                          const CUtensorMap* ma,
                                          const CUtensorMap* mb, int a_row,
                                          int b_row, int KT) {
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
    char* st = s.stage[ring.stage];
    uint64_t* bar = &s.full[ring.stage];
    mbar_arrive_expect_tx(bar, kStageBytes);
    tma_load(st, ma, bar, kt * kBK, a_row);
    tma_load(st + kATile, mb, bar, kt * kBK, b_row);
    ring.advance();
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// a consumer thread normalises one row of its warp's 16, row0 + lane / 2:
// its mean (LN; 0 for RMS) and rstd
struct RowStats {
  float mu = 0.f, rs = 0.f;
};

// a consumer warp: the statistics of rows [row0, row0 + 16) of x (M, K),
// rows past M as zeros; lane 0 writes them to mean / rstd where given (the
// replay; mean with LN only).  A lane holds chunks 0 .. 3 of four rows (64
// registers); kWide (K up to 1280) adds chunk 4, read again in each pass
// (an L1 / L2 hit) instead of being held, and compiles only into the wide
// instantiations, so K <= 1024 runs the code it ran before
template <int kPro, bool kWide = false>
__device__ __forceinline__ RowStats row_stats(const bf16* x, int M, int K,
                                              float eps, int row0,
                                              float* mean_out,
                                              float* rstd_out) {
  const int lane = threadIdx.x & 31, nv = K / 256;
  RowStats st;
#pragma unroll
  for (int r0 = 0; r0 < 16; r0 += 4) {
    uint4 v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + r0 + q;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[q][j] = (row < M && j < nv)
                      ? *reinterpret_cast<const uint4*>(
                            x + (long long)row * K + j * 256 + lane * 8)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // chunk 4 of the row (kWide), read where a pass needs it
      auto chunk4 = [&]() {
        const int row = row0 + r0 + q;
        return (row < M && nv > 4)
                   ? *reinterpret_cast<const uint4*>(
                         x + (long long)row * K + 4 * 256 + lane * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
      };
      float mean = 0.f;  // RMS: no centring
      if constexpr (kPro == kLN) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* u = reinterpret_cast<const uint32_t*>(&v[q][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(u[e]);
            sum += f.x + f.y;
          }
        }
        if constexpr (kWide) {
          const uint4 c = chunk4();
          const uint32_t* u = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(u[e]);
            sum += f.x + f.y;
          }
        }
        mean = warp_sum(sum) / K;
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
      if constexpr (kWide) {
        if (nv > 4) {
          const uint4 c = chunk4();
          const uint32_t* u = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(u[e]);
            ss += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(ss) / K + eps);
      const int i = r0 + q, row = row0 + i;
      if (i == (lane >> 1)) {
        st.mu = mean;
        st.rs = rstd;
      }
      if (lane == 0 && rstd_out != nullptr && row < M) {
        if constexpr (kPro == kLN) mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
  }
  return st;
}

// LN: (x - mean) rstd gamma + beta in fp32, rounded once; RMS:
// bf16(bf16(x rstd) gamma)
template <int kPro>
__device__ __forceinline__ uint32_t norm2(uint32_t v, float mu, float rs,
                                          float g0, float g1, float b0,
                                          float b1) {
  const float2 f = unpack_bf16(v);
  if constexpr (kPro == kLN)
    return pack_bf16((f.x - mu) * rs * g0 + b0, (f.y - mu) * rs * g1 + b1);
  else
    return pack_bf16(round_bf16(f.x * rs) * g0, round_bf16(f.y * rs) * g1);
}

// a consumer thread: where its tile rows start (warpgroup wg of the two);
// its warpgroup's leader issues the output's TMA stores
struct Consumer {
  int wg, warp, lane;
  bool leader;
  __device__ __forceinline__ Consumer()
      : wg((threadIdx.x >> 7) - 1), warp((threadIdx.x >> 5) & 3),
        lane(threadIdx.x & 31), leader((threadIdx.x & 127) == 0) {}
  __device__ __forceinline__ int row0() const { return wg * 64 + warp * 16; }
  __device__ __forceinline__ int g() const { return lane >> 2; }
  __device__ __forceinline__ int c() const { return lane & 3; }
  __device__ __forceinline__ void sync() const { named_sync(2 + wg, 128); }
};

// norm prologues: a consumer warpgroup normalises its 64 rows of the raw A
// box of slice kt in place (lane l of warp w: row 16 w + l / 2, 16-byte
// chunks 4 (l & 1) .. + 3, through the swizzle), writes them to u (the
// replay; rows < M), and makes them visible to its wgmma (proxy fence, then
// the warpgroup's named barrier)
template <int kPro>
__device__ __forceinline__ void normalize_slice(Smem& s, int st, int kt,
                                                const Consumer& t,
                                                const RowStats& rstat,
                                                bf16* u, int m0, int M,
                                                int K) {
  const int r = t.row0() + (t.lane >> 1);
  char* arow = s.stage[st] + r * 128;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ch = 4 * (t.lane & 1) + q, k = kt * kBK + ch * 8;
    uint4* p = reinterpret_cast<uint4*>(arow + ((ch ^ (r & 7)) << 4));
    uint4 v = *p;
    const float4 ga = *reinterpret_cast<const float4*>(s.gamma + k);
    const float4 gb = *reinterpret_cast<const float4*>(s.gamma + k + 4);
    float4 ba = make_float4(0.f, 0.f, 0.f, 0.f), bb = ba;
    if constexpr (kPro == kLN) {
      ba = *reinterpret_cast<const float4*>(s.beta + k);
      bb = *reinterpret_cast<const float4*>(s.beta + k + 4);
    }
    v.x = norm2<kPro>(v.x, rstat.mu, rstat.rs, ga.x, ga.y, ba.x, ba.y);
    v.y = norm2<kPro>(v.y, rstat.mu, rstat.rs, ga.z, ga.w, ba.z, ba.w);
    v.z = norm2<kPro>(v.z, rstat.mu, rstat.rs, gb.x, gb.y, bb.x, bb.y);
    v.w = norm2<kPro>(v.w, rstat.mu, rstat.rs, gb.z, gb.w, bb.z, bb.w);
    *p = v;
    if (u != nullptr && m0 + r < M)
      *reinterpret_cast<uint4*>(u + (long long)(m0 + r) * K + k) = v;
  }
  fence_proxy_async_smem();
  t.sync();
}

// this warpgroup's 4 wgmma of slice kt in stage st (A rows 64 wg .., B
// from the stage), committed as one group
__device__ __forceinline__ void mma_slice(float (&acc)[kAcc], Smem& s, int st,
                                          int kt, const Consumer& t) {
  const char* A = s.stage[st];
  const uint64_t da = desc_sw128(A + t.wg * 64 * 128), db = desc_sw128(A + kATile);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)  // scale_d 0: the tile's first step
    wgmma_ss_n256(acc, da + 2 * j, db + 2 * j, (kt == 0 && j == 0) ? 0 : 1);
  wgmma_commit();
}

// stage st back to the producer: one arrival per consumer warp
__device__ __forceinline__ void release_stage(Smem& s, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&s.empty[st]);
}

// a consumer thread: acc = prologue(A) B^T of one tile over KT slices (rows
// m0 .. of A; u, where given, receives the normalised A, rows < M)
template <int kPro>
__device__ __forceinline__ void mainloop(float (&acc)[kAcc], Smem& s,
                                         Ring<kStages>& ring, int KT,
                                         const Consumer& t,
                                         const RowStats& rstat, bf16* u,
                                         int m0, int M, int K) {
  // defined here, so the last tile's accumulators are dead before it
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = ring.stage;
    mbar_wait(&s.full[st], ring.phase);
    if constexpr (kPro != kNoNorm)
      normalize_slice<kPro>(s, st, kt, t, rstat, u, m0, M, K);
    mma_slice(acc, s, st, kt, t);
    wgmma_wait<1>();  // the slice before has retired: its stage is free
    if (kt > 0) release_stage(s, prev);
    prev = st;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_stage(s, prev);
}

// ---------------------------------------------------------------------------
// epilogue: through shared memory to TMA stores
// ---------------------------------------------------------------------------
// A consumer thread holds rows r = 16 w + g and r + 8 of its warpgroup's 64
// and columns 8 j + 2 c + {0, 1} of the tile in acc[4 j + {0, 1}] and
// acc[4 j + {2, 3}].  The warpgroup's epilogue is a stream of boxes of 64
// rows x 64 columns (column groups 8 b .. 8 b + 7 of box b): each is written
// as bf16 pairs into the warpgroup's staging box (128-byte swizzled:
// bank-conflict free, since the 8 rows of a store land in 8 different
// 16-byte chunks), then stored by the leader with one TMA store.  The box is
// reused once that store has read it; a residual box comes in through it by
// TMA.

// byte offset of (row r, column col) in a staging box
__device__ __forceinline__ int out_off(int r, int col) {
  return r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// the warpgroup's staging box, free to write: the leader's last store out
// of it has read it
__device__ __forceinline__ char* out_begin(Smem& s, const Consumer& t) {
  if (t.leader) bulk_wait_read<0>();
  t.sync();
  return s.out[t.wg];
}
__device__ __forceinline__ void out_put(char* box, int r, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(box + out_off(r, col)) = v;
}
__device__ __forceinline__ float2 out_get(const char* box, int r, int col) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(box + out_off(r, col)));
}

// the tile's bias (n0 .. n0 + 256 of a length-n vector; zeros past n) into
// the warpgroup's s.bias, before its first out_begin
__device__ __forceinline__ void out_bias(Smem& s, const Consumer& t,
                                         const float* bias, int n0, int n) {
  for (int i = threadIdx.x & 127; i < kBN; i += 128)
    s.bias[t.wg][i] = n0 + i < n ? bias[n0 + i] : 0.f;
}
// the bias pair of tile columns col, col + 1
__device__ __forceinline__ float2 tile_bias(const Smem& s, const Consumer& t,
                                            int col) {
  return *reinterpret_cast<const float2*>(&s.bias[t.wg][col]);
}
// the box at (col, row) of a 2-D map into the begun staging box (the
// residual); every thread of the warpgroup waits for it
__device__ __forceinline__ void out_load(Smem& s, const Consumer& t, char* box,
                                         const CUtensorMap* map, int col,
                                         int row, unsigned& phase) {
  uint64_t* bar = &s.res_full[t.wg];
  if (t.leader) {
    mbar_arrive_expect_tx(bar, kOutBox);
    tma_load(box, map, bar, col, row);
  }
  mbar_wait(bar, phase);
  phase ^= 1u;
}

// the staging box written: store it to (col, row) of a 2-D map, or, with
// C > 0, of the (C, M, 3) map of a packed q | k | v buffer (box column col
// of the (M, 3 C) product); nothing past ncols
__device__ __forceinline__ void out_store(const Consumer& t, const char* box,
                                          const CUtensorMap* map, int col,
                                          int row, int ncols, int C = 0) {
  fence_proxy_async_smem();
  t.sync();
  if (t.leader) {
    if (col < ncols) {
      if (C > 0)
        tma_store(map, box, col % C, row, col / C);
      else
        tma_store(map, box, col, row);
    }
    bulk_commit();
  }
}

}  // namespace fast3r_gemm
