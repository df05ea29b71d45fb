// The attention forward on wgmma, for head_dim 64 (and 80: the tail below)
// and bf16 (csrc/attention_fwd.cu: K1, and K2 and the batched encoder
// attention through strides; csrc/ring_attention.cu: the bf16 ring, K14's
// forward, at either head_dim): the
// shared-memory plan, the producer's loads, the consumers' per-item body
// and the epilogue, over tiles in the 128-byte-swizzled, K-major layout TMA
// writes (hopper.cuh's descriptors).  The consumer machinery (the thread's
// place, the turns, stage releases, ex2, the state words) is
// attention_bwd_tile.cuh's.
//
// An item is 128 queries of one (batch, head); a CTA walks items and is two
// consumer warpgroups of 64 query rows each (threads 0-255) and a producer
// warpgroup (256-383) whose first thread issues every load (the ring's CTA
// gives the other three warps the hop protocol):
//   * an item's 128 query rows (one 128-row TMA box) into one of two own
//     slots, so the next item's rows arrive while the last one computes;
//   * the K and V tiles of 128 keys (one box each) into a ring of kStages
//     stages with full and empty mbarriers.
// Per tile i, each consumer warpgroup on its 64 rows (fp32 registers):
//   S_i = Q K_i^T    wgmma m64n128k16 SS (Q and K K-major), 64 registers;
//   O += P_{i-1} V_{i-1}  wgmma m64n64k16 RS: P_{i-1} packed to bf16 in
//                    place from S_{i-1}'s accumulator layout (32
//                    registers), V read MN-major;
// issued together in the warpgroup's turn as two commit groups, S first.
// The softmax of S_i (running max in raw score units, p = ex2(s c - m c)
// as one FFMA and MUFU's ex2.approx.ftz, the row sum over the unrounded
// fp32 p) then runs while P_{i-1} V_{i-1} is still in the tensor cores, and
// while the other warpgroup's products are: the warpgroups take turns to
// issue (named barriers kTurnBar + wg).  After P_{i-1} V_{i-1} retires, O is
// rescaled by exp(m_{i-1} - m_i) (every tile: 32 FMULs, branch-free) and
// S_i packed into P_i.  Every product is waited for within the item, the
// loop has no unmasked copy of its body: only the last tile of a ragged Nk
// is masked, under a uniform predicate (keys past Nk arrive as TMA's zeros
// and a zero key still scores 0, so the mask, not the fill, keeps them
// out).  An RS product reads its registers after issue and the compiler
// does not know it: wgmma_fence before each issue, fence_regs on S and O
// after each wait, so P is not rewritten while its product runs.
// Registers: S 64 + P 32 + O 32, under the 168 a thread of a 384-thread
// CTA (a 288-thread one gets no more: attention_bwd_tile.cuh's note).
// setmaxnreg moves the producer warpgroup to 56 and the consumers to 224;
// ptxas still fits the consumers' code in 168, but the ring ran faster with
// it on the H100 (K1 level).  Q stays in shared memory: as RS fragments (16
// registers more) ptxas serialised the products (C7512) and spilled, and K1
// ran slower.
// Epilogue: o = O / l rounded to bf16, written by each warpgroup into a
// swizzled 64-row staging box and stored by TMA (rows past the tensor's
// edge are not stored); the natural-log lse of the rows by plain stores.
// Rounding points: those of attention_ref's kernel counterpart: fp32
// scores and statistics, P rounded to bf16 before P V, fp32 accumulation,
// o rounded once.
// Head_dim 80 (the model_scaling_huge decoder, 1280 / 16): a bf16 row is
// 160 bytes, past the 128-byte swizzle span, so each row of Q, K and V
// comes in as two TMA boxes: columns 0 .. 63 into the 128-byte-swizzled
// tiles above, columns 64 .. 79 (32 bytes a row) into 32-byte-swizzled
// tail tiles (TailSmem, after Smem; 40 KB more, 217 KB in all).  S = Q K^T
// takes a fifth k16 step (an m64n128k16 on the tails' descriptors); O's
// tail, 16 columns (8 registers), is P V_tail as eight m64n16k16 RS
// products beside P V's m64n64; no product is padded.  The tail of o is
// stored from registers (4-byte stores: 32 of a row's 160 bytes).  The
// head_dim 64 path compiles without any of it (D is a template argument).
#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "hopper.cuh"

namespace fast3r_attn_fwd {

using namespace fast3r_hopper;
namespace ab = fast3r_attn_bwd;
using ab::Consumer;
using fast3r_ptx::pack_bf16;

constexpr int kD = 64;       // a box row: one 128-byte swizzle span
constexpr int kRows = 128;   // queries of an item
constexpr int kKeys = 128;   // keys of a streamed tile
constexpr int kStages = 4;
constexpr int kConsumers = ab::kConsumers;          // 256
constexpr int kConsumerWarps = ab::kConsumerWarps;  // 8
constexpr int kThreads = kConsumers + 128;          // + the producer warpgroup
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // setmaxnreg: 384 x 168
constexpr int kBox = kRows * kD * 2;     // a 128-row bf16 box, 16 KB
constexpr int kHalf = 64 * kD * 2;       // a warpgroup's 64 rows of it, 8 KB
constexpr int kEpiBar = 10;              // named barriers 10, 11 (8, 9: turns)
constexpr int kStateWords = 36;          // O 32, m 2, l 2 per consumer thread
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kRows == kKeys, "one box size for the Q, K and V maps");
constexpr int kTailCols = 16;                  // head_dim 80: columns 64 .. 79
constexpr int kTailBox = kRows * kTailCols * 2;  // a 128-row tail box, 4 KB
constexpr int kTailHalf = 64 * kTailCols * 2;    // a warpgroup's 64 rows of it

using StageRing = Ring<kStages>;
using OwnRing = Ring<2>;

struct Smem {
  char q[2][kBox];          // own slots: an item's 128 query rows
  char k[kStages][kBox];    // the stage ring: 128 keys of K
  char v[kStages][kBox];    // and of V
  char out[2][kHalf];       // [warpgroup]: the staging box of o
  uint64_t full[kStages], empty[kStages], own_full[2], own_empty[2];
  uint64_t done[2];         // the ring: the consumers are done with slot t
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// head_dim 80: the tail tiles, 1024-byte aligned after Smem
struct TailSmem {
  char q[2][kTailBox];
  char k[kStages][kTailBox];
  char v[kStages][kTailBox];
};
constexpr int kMainBytes = (sizeof(Smem) + 1023) / 1024 * 1024;
template <int D>
constexpr int smem_bytes() {
  return D == 64 ? kSmemBytes : kMainBytes + (int)sizeof(TailSmem) + 1024;
}

__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t off = smem_u32(smem_raw);
  return *reinterpret_cast<Smem*>(smem_raw + ((1024u - (off & 1023u)) & 1023u));
}
__device__ __forceinline__ TailSmem& tail(Smem& s) {
  return *reinterpret_cast<TailSmem*>(reinterpret_cast<char*>(&s) + kMainBytes);
}

// the tail maps of a head_dim-80 launch (16-column, 32-byte-swizzled boxes
// of the same tensors; unused at head_dim 64)
struct TailMaps {
  const CUtensorMap *q, *k, *v;
};

// thread 0, then a __syncthreads before any use
__device__ __forceinline__ void init_barriers(Smem& s) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], kConsumerWarps);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&s.own_full[i], 1);
    mbar_init(&s.own_empty[i], kConsumerWarps);
    mbar_init(&s.done[i], kConsumerWarps);
  }
  mbar_init_fence();
}

// ---------------------------------------------------------------------------
// producer (lane 0 of the producer warp)
// ---------------------------------------------------------------------------

// an item's query rows row0 .. row0 + 127 of map q, at (c2, c3) of its
// rank-4 (D, rows, c2, c3) shape, into own slot own.stage; then its n
// tiles of K and V, keys 128 t .., at (k2, k3) of maps k and v; at head_dim
// 80 each with its tail box (columns 64 ..) from the maps of tm
template <int D = 64>
__device__ __forceinline__ void load_item(Smem& s, OwnRing& own, StageRing& ring,
                                          const CUtensorMap* q, int row0, int c2, int c3,
                                          const CUtensorMap* k, const CUtensorMap* v, int k2,
                                          int k3, int n, TailMaps tm = {}) {
  constexpr int kTail = D > 64 ? kTailBox : 0;
  mbar_wait(&s.own_empty[own.stage], own.phase ^ 1u);
  uint64_t* bar = &s.own_full[own.stage];
  mbar_arrive_expect_tx(bar, kBox + kTail);
  tma_load(s.q[own.stage], q, bar, 0, row0, c2, c3);
  if constexpr (D > 64) tma_load(tail(s).q[own.stage], tm.q, bar, 64, row0, c2, c3);
  own.advance();
  for (int t = 0; t < n; ++t) {
    mbar_wait(&s.empty[ring.stage], ring.phase ^ 1u);
    bar = &s.full[ring.stage];
    mbar_arrive_expect_tx(bar, 2 * (kBox + kTail));
    tma_load(s.k[ring.stage], k, bar, 0, t * kKeys, k2, k3);
    tma_load(s.v[ring.stage], v, bar, 0, t * kKeys, k2, k3);
    if constexpr (D > 64) {
      tma_load(tail(s).k[ring.stage], tm.k, bar, 64, t * kKeys, k2, k3);
      tma_load(tail(s).v[ring.stage], tm.v, bar, 64, t * kKeys, k2, k3);
    }
    ring.advance();
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// the online-softmax state of a consumer thread's two rows (g, g + 8 of its
// warp's 16): O, the running max in raw score units and the thread's part
// of the row sums (its quarter of the keys)
struct State {
  float o[32], m[2], l[2];
  __device__ __forceinline__ void zero() {
    ab::zero(o);
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }
  // merge with an earlier partial of the same rows over other keys, kept
  // as save() writes it (here a copy in shared memory): both O and row
  // sums scaled to the larger running max
  __device__ __forceinline__ void merge(const float* st, float scale_log2) {
    float a[2], b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = st[(32 + h) * kConsumers + threadIdx.x];
      const float mx = fmaxf(mo, m[h]);
      a[h] = ab::ex2((mo - mx) * scale_log2);
      b[h] = ab::ex2((m[h] - mx) * scale_log2);
      l[h] = st[(34 + h) * kConsumers + threadIdx.x] * a[h] + l[h] * b[h];
      m[h] = mx;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      o[i] = st[i * kConsumers + threadIdx.x] * a[(i >> 1) & 1] + o[i] * b[(i >> 1) & 1];
  }
  // -> fp32 words 0 .. kStateWords - 1 of an item's scratch (word i of
  // thread x at i * kConsumers + x: coalesced)
  __device__ __forceinline__ void save(float* st) const {
    ab::save_state(o, st, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st[(32 + h) * kConsumers + threadIdx.x] = m[h];
      st[(34 + h) * kConsumers + threadIdx.x] = l[h];
    }
  }
};

// the online softmax of a tile's scores in place: s (rows g, g + 8; keys
// 8 j + 2 c + {0, 1} of the tile in s[4 j + {0, 1}], s[4 j + {2, 3}]) ->
// p = exp2(s c - m c) with m the new running max; keys at or past lim
// masked (lim < kKeys on the last tile of a ragged Nk only); alpha the
// factor that takes O and l to the new max
__device__ __forceinline__ void softmax(float (&s)[64], State& x, float (&alpha)[2], int lim,
                                        int c, float scale_log2) {
  if (lim < kKeys) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * c + e >= lim) s[4 * j + e] = s[4 * j + 2 + e] = -CUDART_INF_F;
  }
  float mx[2] = {x.m[0], x.m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
  float ms[2], rs[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));  // finite
    alpha[h] = ab::ex2((x.m[h] - mx[h]) * scale_log2);            // 0 from -inf
    x.m[h] = mx[h];
    ms[h] = mx[h] * scale_log2;
    rs[h][0] = rs[h][1] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * h + e];
        v = ab::ex2(fmaf(v, scale_log2, -ms[h]));
        rs[h][e] += v;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) x.l[h] = x.l[h] * alpha[h] + (rs[h][0] + rs[h][1]);
}

// O *= alpha (per row; at head_dim 80 its tail ot too), and the tile's p
// packed to bf16 as the 8 k16 steps of an RS A operand (mma.m16n8k16's
// fragment: rows g / g + 8, keys 2 c, 2 c + 8 of the step)
template <int D = 64>
__device__ __forceinline__ void rescale_pack(State& x, float (&ot)[8], const float (&alpha)[2],
                                             uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x.o[i] *= alpha[(i >> 1) & 1];
  if constexpr (D > 64) {
#pragma unroll
    for (int i = 0; i < 8; ++i) ot[i] *= alpha[(i >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// S = Q K^T: A (the warpgroup's 64 query rows) at dq, B (128 keys) at dk;
// at head_dim 80 a fifth k16 step on the tails at dqt, dkt
template <int D = 64>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t dq, uint64_t dk,
                                        uint64_t dqt = 0, uint64_t dkt = 0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_n128(s, dq + 2 * j, dk + 2 * j, j);
  if constexpr (D > 64) wgmma_ss_n128(s, dqt, dkt, 1);
  wgmma_commit();
}
// O += P V: V (128 keys x 64 d) read MN-major at dv; at head_dim 80 also
// ot += P V_tail (128 keys x 16 d, MN-major at dvt)
template <int D = 64>
__device__ __forceinline__ void issue_pv(float (&o)[32], float (&ot)[8],
                                         const uint32_t (&p)[8][4], uint64_t dv,
                                         uint64_t dvt = 0) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_tb(o, p[kk], dv + 128 * kk);
  if constexpr (D > 64) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_n16_tb(ot, p[kk], dvt + 32 * kk);
  }
  wgmma_commit();
}

// a consumer thread: one item, n tiles of K and V against own slot
// own.stage (Q), from the state x (zero, or an earlier epoch's) and, at
// head_dim 80, O's tail ot (zero); keys at or past Nk masked
template <int D>
__device__ __forceinline__ void fwd_item(State& x, float (&ot)[8], Smem& s, OwnRing& own,
                                         StageRing& ring, const Consumer& t, int n, int Nk,
                                         float scale_log2) {
  const int os = own.stage;
  mbar_wait(&s.own_full[os], own.phase);
  own.advance();
  const uint64_t dq = desc_sw128(s.q[os] + t.wg * kHalf);
  uint64_t dqt = 0;
  if constexpr (D > 64) dqt = desc_sw32(tail(s).q[os] + t.wg * kTailHalf);
  auto dkt = [&](int st) { return D > 64 ? desc_sw32(tail(s).k[st]) : 0ull; };
  auto dvt = [&](int st) { return D > 64 ? desc_sw32(tail(s).v[st]) : 0ull; };
  float sc[64], alpha[2];
  uint32_t p[8][4];
  int st = ring.stage;
  mbar_wait(&s.full[st], ring.phase);
  ring.advance();
  ab::turn_begin(t);
  wgmma_fence();
  issue_s<D>(sc, dq, desc_sw128(s.k[st]), dqt, dkt(st));
  ab::turn_end(t);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(sc, x, alpha, Nk, t.c(), scale_log2);
  rescale_pack<D>(x, ot, alpha, p, sc);
  for (int i = 1; i < n; ++i) {
    const int prev = st;
    st = ring.stage;
    mbar_wait(&s.full[st], ring.phase);
    ring.advance();
    ab::turn_begin(t);
    wgmma_fence();
    issue_s<D>(sc, dq, desc_sw128(s.k[st]), dqt, dkt(st));  // S_i
    issue_pv<D>(x.o, ot, p, desc_sw128(s.v[prev]), dvt(prev));  // O += P_{i-1} V_{i-1}
    ab::turn_end(t);
    wgmma_wait<1>();  // S_i
    fence_regs(sc);
    softmax(sc, x, alpha, Nk - i * kKeys, t.c(), scale_log2);
    wgmma_wait<0>();  // P_{i-1} V_{i-1}: p and O free
    fence_regs(x.o);
    if constexpr (D > 64) fence_regs(ot);
    fence_regs(sc);
    ab::release(&s.empty[prev]);
    rescale_pack<D>(x, ot, alpha, p, sc);
  }
  ab::release(&s.own_empty[os]);  // Q's last product has retired
  ab::turn_begin(t);
  wgmma_fence();
  issue_pv<D>(x.o, ot, p, desc_sw128(s.v[st]), dvt(st));
  ab::turn_end(t);
  wgmma_wait<0>();
  fence_regs(x.o);
  if constexpr (D > 64) fence_regs(ot);
  ab::release(&s.empty[st]);
}

// the end of an item: o = O / l rounded to bf16 through the warpgroup's
// staging box into box (0, row0 + 64 wg, c2, c3) of map mo (rows past the
// map's edge are not stored); the natural-log lse of row r at lse[r] for
// r < n_valid (lse may be null).  The warpgroup's first thread issues the
// store and, before the box is written again, waits until it has been read.
// At head_dim 80 the tail ot goes out from registers: columns 64 .. 79 of
// row r at otail + r * ld (rows at or past n_valid are not written).
template <int D = 64>
__device__ __forceinline__ void store_item(State& x, Smem& s, const Consumer& t,
                                           const CUtensorMap* mo, int row0, int c2, int c3,
                                           float* lse, int n_valid, float scale_log2,
                                           const float (&ot)[8] = {}, __nv_bfloat16* otail = nullptr,
                                           long long ld = 0) {
  const bool leader = (threadIdx.x & 127) == 0;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x.l[h] += __shfl_xor_sync(0xffffffffu, x.l[h], 1);
    x.l[h] += __shfl_xor_sync(0xffffffffu, x.l[h], 2);
    inv[h] = 1.f / x.l[h];
    const int r = row0 + t.row() + 8 * h;
    if (lse != nullptr && t.c() == 0 && r < n_valid)
      lse[r] = (x.m[h] * scale_log2 + log2f(x.l[h])) * kLn2;
    if constexpr (D > 64) {
      if (r < n_valid) {
        __nv_bfloat16* row = otail + r * ld + 2 * t.c();
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint32_t*>(row + 8 * j) =
              pack_bf16(ot[4 * j + 2 * h] * inv[h], ot[4 * j + 2 * h + 1] * inv[h]);
      }
    }
  }
  if (leader) bulk_wait_read<0>();
  named_sync(kEpiBar + t.wg, 128);
  char* box = s.out[t.wg];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = t.warp * 16 + (t.lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(box + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t.c()) =
          pack_bf16(x.o[4 * j + 2 * h] * inv[h], x.o[4 * j + 2 * h + 1] * inv[h]);
  }
  fence_proxy_async_smem();
  named_sync(kEpiBar + t.wg, 128);
  if (leader) {
    tma_store(mo, box, 0, row0 + 64 * t.wg, c2, c3);
    bulk_commit();
  }
}

// a consumer thread after its last item: its warpgroup's stores complete
__device__ __forceinline__ void drain_stores() {
  if ((threadIdx.x & 127) == 0) bulk_wait<0>();
}

}  // namespace fast3r_attn_fwd
