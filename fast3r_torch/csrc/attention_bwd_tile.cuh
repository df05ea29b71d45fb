// The two backward passes of attention on wgmma, for head_dim 64 and bf16
// (csrc/attention_bwd.cu: K9, and K10 through strides; csrc/
// ring_attention_bwd.cu: the bf16 dq and dk/dv rings of K14's backward):
// the shared-memory plan, the producer's loads and the consumers' per-tile
// bodies, over tiles in the 128-byte-swizzled, K-major layout TMA writes
// (hopper.cuh's descriptors).
//
// A CTA owns 128 rows (queries in the dq pass, keys in the dk/dv pass) and
// is 288 threads: two consumer warpgroups of 64 rows each (threads 0-255)
// and one producer warp (256-287) whose lane 0 issues every load.  The
// producer loads:
//   * an item's own 128 rows (Q and dO, or K and V: four 64-row TMA boxes)
//     into one of two own slots, so the next item's rows arrive while the
//     last item computes;
//   * the streamed 64-row tiles (K and V, or Q and dO) into a ring of
//     kStages stages, each with a full and an empty mbarrier; in the dk/dv
//     pass each stage also takes the tile's 64 lse and 64 delta words by two
//     1-D bulk copies.
// Per tile, each consumer warpgroup runs on its 64 rows, in fp32 registers
// (wgmma m64n64k16, bf16 in):
//   dq pass:    S = Q K^T, dP = dO V^T (RS: Q and dO as A fragments, read
//               from the own slot once per item; K, V K-major);
//               P = exp2(S c - lse log2 e), dS = P (dP - delta), masked at Nk;
//               dQ += dS K (RS: dS packed to bf16 from the accumulator
//               layout, K read MN-major);
//   dk/dv pass: S^T = K Q^T, dP^T = V dO^T (SS: K and V from the own slot);
//               P^T (lse per column, from the stage), dS^T = P^T (dP^T -
//               delta), masked at Nq;
//               dV += P^T dO, dK += dS^T Q (RS, dO and Q MN-major).
// The two score products go out as two commit groups, so the exponentials
// of S run while dP is still in the tensor cores.  The warpgroups take
// turns to issue their score products (named barriers kTurnBar + wg), so
// one's exp2 runs beside the other's products.  A stage goes back to the producer when both
// warpgroups' products of it have retired (one arrival per consumer warp).
// Every product is waited for within its tile and the tile loops have no
// branch: the compiler does not know that an RS product reads its A
// registers after issue, and two variants of the dq loop gave wrong dq on
// the card (ds k left in flight into the next tile; an unmasked copy of
// the loop body for whole tiles).
// Registers: 168 a thread.  A 288-thread CTA gets the registers of 384
// (whole warpgroups): a build without the launch bound gave the dk/dv ring
// 217 registers, and the occupancy API then fitted no CTA on an SM.
// setmaxnreg (a producer warpgroup at 40, consumers at 232) did not let
// the consumers' code use more (the same spills) and ran slower (K9 8.2
// against 8.1 ms), so there is none.  The dk/dv pass's K and V as A
// fragments would need 32 registers more: ptxas then serialised the
// products (C7512), so they stay in shared memory.
// Rounding points (those of the TPU kernels and of attention_bwd_ref): lse
// and delta in fp32; P and dS rounded to bf16 before their products; fp32
// accumulation; dq and dk scaled in fp32 by the caller and rounded once;
// the scale kept in fp32; exp2 is MUFU's ex2.approx (about 2^-22
// relative, far below the bf16 rounding of P).  Rows past the end come in
// as TMA's zeros, but a zero key still scores 0 and so gets p = exp(-lse)
// != 0: the masks, not the fill, keep them out.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace fast3r_attn_bwd {

using namespace fast3r_hopper;
using fast3r_ptx::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim: one 128-byte swizzle span
constexpr int kRows = 128;     // a CTA's own rows
constexpr int kTile = 64;      // rows of a streamed tile
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBox = kTile * kD * 2;       // one 64-row bf16 box, 8 KB
constexpr int kTurnBar = 8;                // named barriers 8 and 9
constexpr float kLog2e = 1.4426950408889634f;

using StageRing = Ring<kStages>;  // a thread's place in the stage ring
using OwnRing = Ring<2>;          // and in the two own slots

struct Smem {
  char own_a[2][2][kBox];        // [own slot][warpgroup]: Q (dq) or K (dk/dv)
  char own_b[2][2][kBox];        // dO or V
  char tile_a[kStages][kBox];    // K or Q
  char tile_b[kStages][kBox];    // V or dO
  float rows[kStages][2][kTile];  // dk/dv: the tile's lse (natural log), delta
  uint64_t full[kStages], empty[kStages], own_full[2], own_empty[2];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t off = smem_u32(smem_raw);
  return *reinterpret_cast<Smem*>(smem_raw + ((1024u - (off & 1023u)) & 1023u));
}

// thread 0, then a __syncthreads before any use
__device__ __forceinline__ void init_barriers(Smem& s) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], kConsumerWarps);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&s.own_full[i], 1);
    mbar_init(&s.own_empty[i], kConsumerWarps);
  }
  mbar_init_fence();
}

// ---------------------------------------------------------------------------
// producer (lane 0 of the producer warp)
// ---------------------------------------------------------------------------

// an item's own rows row0 .. row0 + 127 of maps a and b, at (c2, c3) of
// their rank-4 (64, rows, c2, c3) shape, into own slot own.stage
__device__ __forceinline__ void load_own(Smem& s, OwnRing& own, const CUtensorMap* a,
                                         const CUtensorMap* b, int row0, int c2, int c3) {
  mbar_wait(&s.own_empty[own.stage], own.phase ^ 1u);
  uint64_t* bar = &s.own_full[own.stage];
  mbar_arrive_expect_tx(bar, 4 * kBox);
  for (int w = 0; w < 2; ++w) {
    tma_load(s.own_a[own.stage][w], a, bar, 0, row0 + kTile * w, c2, c3);
    tma_load(s.own_b[own.stage][w], b, bar, 0, row0 + kTile * w, c2, c3);
  }
  own.advance();
}

// n streamed tiles, rows 64 t .. of maps a and b at (c2, c3); with lse
// given, each tile's 64 lse and delta words from lse + 64 t and delta +
// 64 t (16-byte aligned, readable to the whole tile's end)
__device__ __forceinline__ void load_tiles(Smem& s, StageRing& ring,
                                           const CUtensorMap* a, const CUtensorMap* b,
                                           int c2, int c3, int n, const float* lse,
                                           const float* delta) {
  for (int t = 0; t < n; ++t) {
    mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
    uint64_t* bar = &s.full[ring.stage];
    mbar_arrive_expect_tx(bar, 2 * kBox + (lse != nullptr ? 2 * kTile * 4 : 0));
    tma_load(s.tile_a[ring.stage], a, bar, 0, t * kTile, c2, c3);
    tma_load(s.tile_b[ring.stage], b, bar, 0, t * kTile, c2, c3);
    if (lse != nullptr) {
      bulk_load(s.rows[ring.stage][0], lse + t * kTile, kTile * 4, bar);
      bulk_load(s.rows[ring.stage][1], delta + t * kTile, kTile * 4, bar);
    }
    ring.advance();
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// a consumer thread: warpgroup wg holds the CTA's rows 64 wg ..; warp w of
// it rows 16 w + g and 16 w + g + 8 of those (g = lane / 4), columns
// 8 j + 2 c + {0, 1} (c = lane % 4) in d[4 j + {0, 1}] and d[4 j + {2, 3}]
struct Consumer {
  int wg, warp, lane;
  __device__ __forceinline__ Consumer()
      : wg(threadIdx.x >> 7), warp((threadIdx.x >> 5) & 3), lane(threadIdx.x & 31) {}
  __device__ __forceinline__ int row() const { return wg * 64 + warp * 16 + (lane >> 2); }
  __device__ __forceinline__ int c() const { return lane & 3; }
};

// the turns: warpgroup wg issues its SS products between turn_begin and
// turn_end; turns_open before a thread's first tile, turns_close after its
// last (the last hand-over of warpgroup 1 is taken, so both barriers end
// balanced)
__device__ __forceinline__ void turn_begin(const Consumer& t) {
  named_sync(kTurnBar + t.wg, kConsumers);
}
__device__ __forceinline__ void turn_end(const Consumer& t) {
  named_arrive(kTurnBar + (t.wg ^ 1), kConsumers);
}
__device__ __forceinline__ void turns_open(const Consumer& t) {
  if (t.wg == 1) turn_end(t);
}
__device__ __forceinline__ void turns_close(const Consumer& t) {
  if (t.wg == 0) turn_begin(t);
}

// one arrival per consumer warp
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// accumulator columns 16 kk .. 16 kk + 15 as the k16 step kk of an RS A
// operand (mma.m16n8k16's fragment: rows g / g + 8, columns 2 c, 2 c + 8)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// the warpgroup's 64 own rows of a 64-row box (128-byte swizzled) as the 4
// k16 steps of an RS A operand (ldmatrix: lane l gives row l % 8 + 8 (l / 8
// % 2) of its warp's 16, 16-byte chunk 2 kk + l / 16, through the swizzle)
__device__ __forceinline__ void load_frags(uint32_t (&f)[4][4], const char* box,
                                           const Consumer& t) {
  const int row = t.warp * 16 + (t.lane & 7) + ((t.lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int ch = kk * 2 + (t.lane >> 4);
    fast3r_ptx::ldmatrix_x4(f[kk], box + row * 128 + ((ch ^ (row & 7)) << 4));
  }
}

// d = A B^T over 4 k16 steps: A (the warpgroup's 64 rows x 64 d) from
// registers, B (a 64-row tile x 64 d) K-major at db
__device__ __forceinline__ void mma_abt(float (&d)[32], const uint32_t (&a)[4][4],
                                        uint64_t db) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs_n64(d, a[j], db + 2 * j, j);
}
// d += A T: A (64 rows x the tile's 64 rows) from registers, T (the tile:
// 64 rows x 64 d) read MN-major at db
__device__ __forceinline__ void mma_at(float (&d)[32], const uint32_t (&a)[4][4],
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(d, a[kk], db + 128 * kk);
}


// 2^x in fp32 on the MUFU unit (ex2.approx.ftz: about 2^-22 relative; p
// is rounded to bf16 before any product)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the warpgroup's two score products of a tile, in its turn, committed as
// two groups, s's first; returns when s has retired (d runs on): RS, s =
// a b^T and d = c e^T with a, c from registers and the tiles b, e at db,
// de; SS, s = A B^T and d = C E^T, all four from their descriptors
__device__ __forceinline__ void scores_rs(float (&s)[32], const uint32_t (&a)[4][4],
                                          uint64_t db, float (&d)[32],
                                          const uint32_t (&c)[4][4], uint64_t de,
                                          const Consumer& t) {
  turn_begin(t);
  wgmma_fence();
  mma_abt(s, a, db);
  wgmma_commit();
  mma_abt(d, c, de);
  wgmma_commit();
  turn_end(t);
  wgmma_wait<1>();
  fence_regs(s);
}
__device__ __forceinline__ void scores_ss(float (&s)[32], uint64_t da, uint64_t db,
                                          float (&d)[32], uint64_t dc, uint64_t de,
                                          const Consumer& t) {
  turn_begin(t);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_n64(s, da + 2 * j, db + 2 * j, j);
  wgmma_commit();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_n64(d, dc + 2 * j, de + 2 * j, j);
  wgmma_commit();
  turn_end(t);
  wgmma_wait<1>();
  fence_regs(s);
}

// dq pass: p = exp2(s c - lse log2 e) in place, keys kb + 8 j + {0, 1}
// (kb = key0 + 2 c) at or past Nk masked
__device__ __forceinline__ void dq_p(float (&sc)[32], int kb, int Nk, float scale_log2,
                                     const float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kb + 8 * j + e < Nk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g, g + 8
        const int x = 4 * j + 2 * h + e;
        sc[x] = ok ? ex2(sc[x] * scale_log2 - l[h]) : 0.f;
      }
    }
}

// a consumer thread: one dq item, n tiles (K, V) against own slot
// own.stage (Q, dO); l and dl are its two rows' lse log2 e and delta
__device__ __forceinline__ void dq_item(float (&dq)[32], Smem& s, OwnRing& own,
                                        StageRing& ring, const Consumer& t, int n,
                                        int Nk, float scale_log2, const float (&l)[2],
                                        const float (&dl)[2]) {
  uint32_t qf[4][4], of[4][4];
  mbar_wait(&s.own_full[own.stage], own.phase);
  load_frags(qf, s.own_a[own.stage][t.wg], t);
  load_frags(of, s.own_b[own.stage][t.wg], t);
  release(&s.own_empty[own.stage]);
  own.advance();
  for (int i = 0; i < n; ++i) {
    const int st = ring.stage;
    mbar_wait(&s.full[st], ring.phase);
    const uint64_t dk = desc_sw128(s.tile_a[st]);
    float sc[32], dp[32];
    scores_rs(sc, qf, dk, dp, of, desc_sw128(s.tile_b[st]), t);  // q k^T, do v^T
    const int kb = i * kTile + 2 * t.c();
    dq_p(sc, kb, Nk, scale_log2, l);
    wgmma_wait<0>();  // dp
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= dp[x] - dl[(x >> 1) & 1];  // ds
    uint32_t a[4][4];
    pack_a(a, sc);
    wgmma_fence();
    mma_at(dq, a, dk);  // ds k
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    release(&s.empty[st]);
    ring.advance();
  }
}

// dk/dv pass: p^T = exp2(s^T c - lse log2 e) in place, queries q0 + col
// (lse per column, from L) at or past Nq masked
__device__ __forceinline__ void dkv_p(float (&sc)[32], const float* L, int q0, int c, int Nq,
                                      float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * c + e;
      const bool ok = q0 + col < Nq;
      const float lc = L[col] * kLog2e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h + e;
        sc[x] = ok ? ex2(sc[x] * scale_log2 - lc) : 0.f;
      }
    }
}

// a consumer thread: one dk/dv item, n tiles (Q, dO, the rows' lse and
// delta) against own slot own.stage (K, V, read from shared memory by
// each tile's score products: as registers they would not fit beside the
// dk and dv accumulators, and ptxas then serialises the products).  dV's
// product waits for dS^T, so P^T's fragments are not held while dS^T is
// computed (16 registers; issuing it early took K9 7.00 against 6.71 ms on
// the decoder's shape, 0.70 against 0.72 on the encoder's)
__device__ __forceinline__ void dkv_item(float (&dk)[32], float (&dv)[32], Smem& s,
                                         OwnRing& own, StageRing& ring,
                                         const Consumer& t, int n, int Nq,
                                         float scale_log2) {
  const int os = own.stage;
  mbar_wait(&s.own_full[os], own.phase);
  own.advance();
  const uint64_t dka = desc_sw128(s.own_a[os][t.wg]), dva = desc_sw128(s.own_b[os][t.wg]);
  for (int i = 0; i < n; ++i) {
    const int st = ring.stage;
    mbar_wait(&s.full[st], ring.phase);
    const uint64_t dq = desc_sw128(s.tile_a[st]), ddo = desc_sw128(s.tile_b[st]);
    float sc[32], dp[32];
    scores_ss(sc, dka, dq, dp, dva, ddo, t);  // k q^T, v do^T
    const float* L = s.rows[st][0];
    const float* Dl = s.rows[st][1];
    dkv_p(sc, L, i * kTile, t.c(), Nq, scale_log2);
    uint32_t pa[4][4], sa[4][4];
    pack_a(pa, sc);
    wgmma_wait<0>();  // dp^T
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t.c() + e;
        const bool ok = i * kTile + col < Nq;
        const float d = Dl[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * j + 2 * h + e;
          dp[x] = ok ? sc[x] * (dp[x] - d) : 0.f;  // ds^T
        }
      }
    pack_a(sa, dp);
    wgmma_fence();
    mma_at(dv, pa, ddo);  // p^T do
    mma_at(dk, sa, dq);   // ds^T q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    release(&s.empty[st]);
    ring.advance();
  }
  release(&s.own_empty[os]);
}

// the thread's rows r0 and r0 + 8 of its accumulator, times mul, rounded to
// bf16 -> base + row * s_row (plain 4-byte stores; rows at or past n_valid
// are not written)
__device__ __forceinline__ void store_rows(bf16* base, long long s_row, int r0, int n_valid,
                                           const float (&d)[32], float mul, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n_valid) continue;
    bf16* row = base + (long long)r * s_row + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// an accumulator <-> fp32 words w0 .. w0 + 31 of a consumer thread in an
// item's state (word i of thread x at i * kConsumers + x: coalesced)
__device__ __forceinline__ void load_state(float (&d)[32], const float* st, int w0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = st[(w0 + i) * kConsumers + threadIdx.x];
}
__device__ __forceinline__ void save_state(const float (&d)[32], float* st, int w0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) st[(w0 + i) * kConsumers + threadIdx.x] = d[i];
}

}  // namespace fast3r_attn_bwd
