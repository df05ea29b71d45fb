// Ring attention backward with in-kernel hops over two slots per rank: dq,
// dk and dv of o_r = softmax(scale * q_r [k_0 .. k_{R-1}]^T) [v_0 .. v_{R-1}]
// for each of R rank-stacked shards, in two launches, as the TPU kernels.
//
// Replaces the TPU kernels fast3r_tpu/parallel/ring_rdma.py (_ring_backward
// -> _ring_bwd_dq_kernel and _ring_bwd_dkv_kernel): the backward of the
// sequence-sharded decoder's global attention.  Both rings run the forward's
// hop protocol (ring_protocol.cuh: bootstrap, hop j from my slot (j-1)%2
// into the right neighbour's slot j%2 while epoch j-1 computes, capacity
// tokens, per-slot fill counters, R x G persistent CTAs launched
// cooperatively, a trap after the timeout):
//   * dq ring: items are (batch * head, 128-query block); K and V rotate
//     (the forward's payload); q, do and the rows' lse and delta stay local.
//     Epoch s adds ds k over the K/V of rank (r - s) mod R;
//   * dk / dv ring: items are (batch * head, 128-key block); q, do and the
//     rows' lse and delta rotate, the last two as a third payload, fp32
//     (lse rows | delta rows), each (B * H, Sp) with Sp = S rounded up to
//     whole 64-row tiles; K and V stay local, so dk and dv finish at the
//     shard's owner with no final permute.  Epoch s adds ds^T q and p^T do
//     over the q / do of rank (r - s) mod R.  A CTA copies its share of all
//     three payloads of a hop before it publishes, so a slot's counter
//     reaching fill * G means all three landed.
// The accumulators (dq, or dk and dv, fp32) go through fp32 scratch between
// epochs, as the TPU kernels' HBM state does: with two slots the epoch order
// is outermost and a CTA walks many items per epoch, more than its shared
// memory holds at n = 4.  dq, dk and dv are written at the last epoch.
//
// bf16 (the training path): the tile bodies of attention_bwd.cu, from
// attention_bwd_tile.cuh (wgmma products, a producer warp feeding two
// consumer warpgroups through TMA, 128-row items).  The cooperative launch
// still fits with 128-row items (one 288-thread CTA per SM, 131 KB of
// shared memory; the occupancy API sizes G), so the items are the kernel's
// 128-row CTAs and not 64-row ones.  Each launch reads through rank-4
// tensor maps:
//   * the rank's own rows (q and do, or k and v) through their (rank,
//     batch, token, head) strides, rank and batch merged into one dimension
//     (64, S, H, R * B), which the wrapper arranges (a copy where the
//     strides do not merge);
//   * every rank's slots of the rotating pair: each payload is one
//     allocation of R x 2 slots (B * H, S, D) on this card, so one map
//     (D, S, B * H, 2 R) covers them;
//   * the dk/dv ring's (lse, delta) rows by 1-D bulk copies from the slot.
// Hops fill the slots with generic stores published by a release add; the
// producer issues fence.proxy.async after the acquire (each epoch's start),
// so its TMA reads see the hop's bytes.  A slot is released to its next
// hop only after every consumer has waited for every tile read from it.
// Rounding points: attention_bwd_tile.cuh's (those of
// ring_attention_bwd_ref).  Ragged S is masked.
//
// What bounds it on an H100: the five products per (query, key) pair, 2.5x
// the forward's FLOPs, on the tensor cores (the two rings run seven: dq 3,
// dk/dv 4), plus the protocol's hops (2 bf16 payloads per hop for dq; 2
// bf16 and the fp32 rows for dk/dv) and the state traffic.
// The fp32 variants are scalar versions of the same tiling (two lanes per
// row, 64-row items), for tight checks.
// Head_dim D is 64 or 80 (the model_scaling_huge decoder), a template
// argument of every variant.  At D = 80 the bf16 rings take K9's tail tiles
// (attention_bwd_tile.cuh's note: a 16-column, 32-byte-swizzled tail box
// beside each 64-column box, 8 accumulator registers more per output, 32
// KB more shared memory), every map gets a tail map, the slots and hops are
// sized by D, and the state grows by the tails (dq 40 words a thread, dk /
// dv 80).  The fp32 lanes each hold D / 2 columns.
// Not yet: keeping the accumulators in shared memory, one rank per card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "attention_tiles.cuh"
#include "ptx.cuh"
#include "ring_protocol.cuh"

namespace {

namespace ab = fast3r_attn_bwd;
using namespace fast3r_ring;
using fast3r_tiles::load_rows_f32;
using fast3r_tiles::tile_ld;
using bf16 = __nv_bfloat16;

constexpr int kB = 64;           // fp32: rows of an item or tile
constexpr int kThreadsF = 128;   // fp32: 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
// fp32 state words per accumulating thread of one item: the dq accumulator,
// or the dk and dv accumulators (bf16: 32 a 64-column accumulator and 8 its
// tail; fp32: D / 2 each)
template <typename T, int D>
__host__ __device__ constexpr int state_dq() {
  return sizeof(T) == 2 ? 32 + (D > 64 ? 8 : 0) : D / 2;
}
template <typename T, int D>
__host__ __device__ constexpr int state_dkv() { return 2 * state_dq<T, D>(); }

// per element type: threads of a CTA, rows of an item, threads holding
// accumulators (the state's stride)
template <typename T>
struct Cfg {
  static constexpr int kThreads = kThreadsF, kRows = kB, kAccThreads = kThreadsF;
};
template <>
struct Cfg<bf16> {
  static constexpr int kThreads = ab::kThreads, kRows = ab::kRows,
                       kAccThreads = ab::kConsumers;
};

struct BwdParams {
  CUtensorMap own_a, own_b;    // bf16: own q, do (dq) or k, v (dk/dv): (D, S, H, R * B)
  CUtensorMap slot_a, slot_b;  // bf16: the rotating pair's slots: (D, S, B * H, 2 R)
  CUtensorMap own_at, own_bt, slot_at, slot_bt;  // D = 80: their tail boxes
  Ring ring;  // dq: K, V slots; dk / dv: q, do slots (2, B * H, S, D), (lse | delta)
  const void *q, *k, *v, *dout;
  long long qs[4], ks[4], vs[4], os[4];  // rank, batch, token, head strides (elements)
  const float* lse;    // dq: (R, B * H, S), natural log
  const float* delta;  // dq: (R, B * H, S)
  const float* meta;   // dk / dv: (R, meta_words), lse rows | delta rows, (B * H, Sp) each
  long long meta_words;
  int Sp;         // dk / dv: S rounded up to whole 64-row tiles
  void* out0;     // dq, or dk: (R, B, S, H, D) contiguous
  void* out1;     // dv
  float* state;   // (R, items, words, acc threads) fp32; null when E == 1
  int B, H, S;
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// bf16 rings: the tiles of attention_bwd_tile.cuh
// ---------------------------------------------------------------------------

// item it of rank r's bf16 walk: (batch * head, block of 128 rows)
struct Item {
  int bh, b, h, row0;
  __device__ __forceinline__ Item(const BwdParams& p, int it, int nblk)
      : bh(it / nblk), b(bh / p.H), h(bh % p.H), row0((it % nblk) * ab::kRows) {}
};

// a consumer thread's two rows r0, r0 + 8 of an accumulator (and at D = 80
// its tail) -> the contiguous (R, B, S, H, D) output of rank r, times mul
template <int D>
__device__ __forceinline__ void store_out(const BwdParams& p, void* out, int r, const Item& x,
                                          int r0, const float (&d)[32], const float (&dt)[8],
                                          float mul, const ab::Consumer& t) {
  bf16* base = static_cast<bf16*>(out) + ((long long)r * p.B + x.b) * p.S * p.H * D + x.h * D;
  ab::store_rows(base, (long long)p.H * D, r0, p.S, d, mul, t.c());
  if constexpr (D > 64) ab::store_rows_tail(base + 64, (long long)p.H * D, r0, p.S, dt, mul, t.c());
}

// a tail accumulator <-> fp32 words w0 .. w0 + 7 of a consumer thread's state
__device__ __forceinline__ void load_tail(float (&d)[8], const float* st, int w0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = st[(w0 + i) * ab::kConsumers + threadIdx.x];
}
__device__ __forceinline__ void save_tail(const float (&d)[8], float* st, int w0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) st[(w0 + i) * ab::kConsumers + threadIdx.x] = d[i];
}
__device__ __forceinline__ void zero8(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = 0.f;
}

template <int D>
__device__ __forceinline__ void dq_ring_bf16(const BwdParams& p) {
  ab::Smem& sm = ab::smem();
  if (threadIdx.x == 0) ab::init_barriers(sm);
  __syncthreads();
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nblk = (p.S + ab::kRows - 1) / ab::kRows, items = p.B * p.H * nblk;
  const int n = (p.S + ab::kTile - 1) / ab::kTile;
  const bool producer = threadIdx.x >= ab::kConsumers;
  const ab::Consumer t;
  ab::OwnRing own;
  ab::StageRing ring;
  if (!producer) ab::turns_open(t);
  run_ring(
      g, r, c,
      [&] {
        copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 0, r, 0), static_cast<const bf16*>(p.k),
                                 p.ks, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 1, r, 0), static_cast<const bf16*>(p.v),
                                 p.vs, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
      },
      [&](int s, int slot) {
        if (producer) {
          if (threadIdx.x != ab::kConsumers) return;
          fast3r_hopper::fence_proxy_async();  // the hop's stores, then TMA reads
          for (int it = c; it < items; it += g.G) {
            const Item x(p, it, nblk);
            ab::load_own<D>(sm, own, &p.own_a, &p.own_b, x.row0, x.h, r * p.B + x.b,
                            ab::TailMaps{&p.own_at, &p.own_bt});
            ab::load_tiles<D>(sm, ring, &p.slot_a, &p.slot_b, x.bh, 2 * r + slot, n, nullptr,
                              nullptr, ab::TailMaps{&p.slot_at, &p.slot_bt});
          }
          return;
        }
        for (int it = c; it < items; it += g.G) {
          const Item x(p, it, nblk);
          const int r0 = x.row0 + t.row();
          const long long lrow = ((long long)r * p.B * p.H + x.bh) * p.S;
          float l[2], dl[2];  // the thread's rows' lse (log2 domain) and delta
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + 8 * i;
            l[i] = row < p.S ? p.lse[lrow + row] * kLog2e : 0.f;
            dl[i] = row < p.S ? p.delta[lrow + row] : 0.f;
          }
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * state_dq<bf16, D>() *
                                          ab::kConsumers;
          float dq[32], dqt[8];
          if (s == 0) {
            ab::zero(dq);
            zero8(dqt);
          } else {
            ab::load_state(dq, st, 0);
            if constexpr (D > 64) load_tail(dqt, st, 32);
          }
          ab::dq_item<D>(dq, dqt, sm, own, ring, t, n, p.S, p.scale_log2, l, dl);
          if (s == g.E - 1) {
            store_out<D>(p, p.out0, r, x, r0, dq, dqt, p.scale, t);
          } else {
            ab::save_state(dq, st, 0);
            if constexpr (D > 64) save_tail(dqt, st, 32);
          }
        }
      });
  if (!producer) ab::turns_close(t);
}

template <int D>
__device__ __forceinline__ void dkv_ring_bf16(const BwdParams& p) {
  ab::Smem& sm = ab::smem();
  if (threadIdx.x == 0) ab::init_barriers(sm);
  __syncthreads();
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nblk = (p.S + ab::kRows - 1) / ab::kRows, items = p.B * p.H * nblk;
  const int n = (p.S + ab::kTile - 1) / ab::kTile;
  const bool producer = threadIdx.x >= ab::kConsumers;
  const ab::Consumer t;
  ab::OwnRing own;
  ab::StageRing ring;
  if (!producer) ab::turns_open(t);
  run_ring(
      g, r, c,
      [&] {
        copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 0, r, 0), static_cast<const bf16*>(p.q),
                                 p.qs, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 1, r, 0), static_cast<const bf16*>(p.dout),
                                 p.os, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_flat_share(slot_ptr<float>(g, 2, r, 0), p.meta + r * p.meta_words, g.bytes[2],
                        g.G, c);
      },
      [&](int s, int slot) {
        if (producer) {
          if (threadIdx.x != ab::kConsumers) return;
          fast3r_hopper::fence_proxy_async();  // the hop's stores, then TMA reads
          const float* ms = slot_ptr<float>(g, 2, r, slot);
          const long long dlt = (long long)p.B * p.H * p.Sp;  // the delta rows
          for (int it = c; it < items; it += g.G) {
            const Item x(p, it, nblk);
            const float* lrow = ms + (long long)x.bh * p.Sp;
            ab::load_own<D>(sm, own, &p.own_a, &p.own_b, x.row0, x.h, r * p.B + x.b,
                            ab::TailMaps{&p.own_at, &p.own_bt});
            ab::load_tiles<D>(sm, ring, &p.slot_a, &p.slot_b, x.bh, 2 * r + slot, n, lrow,
                              lrow + dlt, ab::TailMaps{&p.slot_at, &p.slot_bt});
          }
          return;
        }
        for (int it = c; it < items; it += g.G) {
          const Item x(p, it, nblk);
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * state_dkv<bf16, D>() *
                                          ab::kConsumers;
          float dk[32], dv[32], dkt[8], dvt[8];
          if (s == 0) {
            ab::zero(dk);
            ab::zero(dv);
            zero8(dkt);
            zero8(dvt);
          } else {
            ab::load_state(dk, st, 0);
            ab::load_state(dv, st, 32);
            if constexpr (D > 64) {
              load_tail(dkt, st, 64);
              load_tail(dvt, st, 72);
            }
          }
          ab::dkv_item<D>(dk, dv, dkt, dvt, sm, own, ring, t, n, p.S, p.scale_log2);
          if (s == g.E - 1) {
            const int r0 = x.row0 + t.row();
            store_out<D>(p, p.out0, r, x, r0, dk, dkt, p.scale, t);
            store_out<D>(p, p.out1, r, x, r0, dv, dvt, 1.f, t);
          } else {
            ab::save_state(dk, st, 0);
            ab::save_state(dv, st, 32);
            if constexpr (D > 64) {
              save_tail(dkt, st, 64);
              save_tail(dvt, st, 72);
            }
          }
        }
      });
  if (!producer) ab::turns_close(t);
}

// ---------------------------------------------------------------------------
// fp32 items (the variants for tight checks): 64 rows, 128 threads, scalar
// FMAs, two lanes per row, each with half of the tile's columns and half of
// the head dim
// ---------------------------------------------------------------------------

template <int D>
__device__ void dq_item(const BwdParams& p, unsigned char* smem, int r, int bh, int qi,
                        const float* kb, const float* vb, float* st, bool first, bool last) {
  constexpr int kLdF = tile_ld<D>(), kHalfD = D / 2;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + kB * kLdF;
  float* Ks = Os + kB * kLdF;
  float* Vs = Ks + kB * kLdF;
  float* Ps = Vs + kB * kLdF;  // ds
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 2;  // this lane's query row in the item
  const int c0 = (lane & 1) * 32;        // its half of the keys
  const int d0 = (lane & 1) * kHalfD;    // and of D
  const float* qb = static_cast<const float*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];
  const float* ob =
      static_cast<const float*>(p.dout) + r * p.os[0] + b * p.os[1] + h * p.os[3];

  load_rows_f32<D>(Qs, qb, p.qs[2], q0, S);
  load_rows_f32<D>(Os, ob, p.os[2], q0, S);
  const int n = q0 + row;
  const long long lrow = ((long long)r * p.B * p.H + bh) * S;
  const float l2 = n < S ? p.lse[lrow + n] * kLog2e : 0.f;
  const float dl = n < S ? p.delta[lrow + n] : 0.f;

  float acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = first ? 0.f : st[i * kThreadsF + tid];

  const float* qrow = Qs + row * kLdF;
  const float* orow = Os + row * kLdF;
  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();
    load_rows_f32<D>(Ks, kb, D, k0, S);
    load_rows_f32<D>(Vs, vb, D, k0, S);
    __syncthreads();
    for (int i = 0; i < 32; ++i) {
      const int j = c0 + i;
      const float* krow = Ks + j * kLdF;
      const float* vrow = Vs + j * kLdF;
      float sv = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sv = fmaf(qrow[d], krow[d], sv);
        dp = fmaf(orow[d], vrow[d], dp);
      }
      Ps[row * kLdF + j] = k0 + j < S ? exp2f(sv * p.scale_log2 - l2) * (dp - dl) : 0.f;
    }
    __syncwarp();
    for (int j = 0; j < kB; ++j) {
      const float ds = Ps[row * kLdF + j];
      const float* krow = Ks + j * kLdF + d0;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(ds, krow[i], acc[i]);
    }
    __syncwarp();
  }
  if (!last) {
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) st[i * kThreadsF + tid] = acc[i];
  } else if (n < S) {
    float* dst = static_cast<float*>(p.out0) + (((long long)r * p.B + b) * S + n) * p.H * D +
                 h * D + d0;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) dst[i] = acc[i] * p.scale;
  }
  __syncthreads();  // the tiles are free for the next item
}

template <int D>
__device__ void dkv_item(const BwdParams& p, unsigned char* smem, int r, int bh, int ki,
                         const float* qb, const float* ob, const float* lb, const float* db,
                         float* st, bool first, bool last) {
  constexpr int kLdF = tile_ld<D>(), kHalfD = D / 2;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kB * kLdF;
  float* Qs = Vs + kB * kLdF;
  float* Os = Qs + kB * kLdF;
  float* Ps = Os + kB * kLdF;   // p^T
  float* DSs = Ps + kB * kLdF;  // ds^T
  float* Ls = DSs + kB * kLdF;  // [kB] lse, log2 domain
  float* Ds = Ls + kB;          // [kB] delta
  const int S = p.S, b = bh / p.H, h = bh % p.H, k0 = ki * kB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 2;  // this lane's key row in the item
  const int c0 = (lane & 1) * 32;        // its half of the queries
  const int d0 = (lane & 1) * kHalfD;    // and of D
  const float* kb = static_cast<const float*>(p.k) + r * p.ks[0] + b * p.ks[1] + h * p.ks[3];
  const float* vb = static_cast<const float*>(p.v) + r * p.vs[0] + b * p.vs[1] + h * p.vs[3];

  load_rows_f32<D>(Ks, kb, p.ks[2], k0, S);
  load_rows_f32<D>(Vs, vb, p.vs[2], k0, S);
  float dk[kHalfD], dv[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    dk[i] = first ? 0.f : st[i * kThreadsF + tid];
    dv[i] = first ? 0.f : st[(kHalfD + i) * kThreadsF + tid];
  }

  const float* krow = Ks + row * kLdF;
  const float* vrow = Vs + row * kLdF;
  for (int q0 = 0; q0 < S; q0 += kB) {
    __syncthreads();
    load_rows_f32<D>(Qs, qb, D, q0, S);
    load_rows_f32<D>(Os, ob, D, q0, S);
    if (tid < kB) {  // the slot's (lse, delta) rows, through L2
      const bool ok = q0 + tid < S;
      Ls[tid] = ok ? __ldcg(lb + q0 + tid) * kLog2e : 0.f;
      Ds[tid] = ok ? __ldcg(db + q0 + tid) : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < 32; ++i) {
      const int j = c0 + i;
      const float* qrow = Qs + j * kLdF;
      const float* orow = Os + j * kLdF;
      float sv = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sv = fmaf(krow[d], qrow[d], sv);
        dp = fmaf(vrow[d], orow[d], dp);
      }
      const bool ok = q0 + j < S;
      const float pv = ok ? exp2f(sv * p.scale_log2 - Ls[j]) : 0.f;
      Ps[row * kLdF + j] = pv;
      DSs[row * kLdF + j] = ok ? pv * (dp - Ds[j]) : 0.f;
    }
    __syncwarp();
    for (int j = 0; j < kB; ++j) {
      const float pv = Ps[row * kLdF + j], ds = DSs[row * kLdF + j];
      const float* orow = Os + j * kLdF + d0;
      const float* qrow = Qs + j * kLdF + d0;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        dv[i] = fmaf(pv, orow[i], dv[i]);
        dk[i] = fmaf(ds, qrow[i], dk[i]);
      }
    }
    __syncwarp();
  }
  const int n = k0 + row;
  if (!last) {
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) {
      st[i * kThreadsF + tid] = dk[i];
      st[(kHalfD + i) * kThreadsF + tid] = dv[i];
    }
  } else if (n < S) {
    const long long o = (((long long)r * p.B + b) * S + n) * p.H * D + h * D + d0;
    float* dkd = static_cast<float*>(p.out0) + o;
    float* dvd = static_cast<float*>(p.out1) + o;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) {
      dkd[i] = dk[i] * p.scale;
      dvd[i] = dv[i];
    }
  }
  __syncthreads();  // the tiles are free for the next item
}

// ---------------------------------------------------------------------------
// the kernels: R x G CTAs, rank r = blockIdx.x % R, its c-th CTA c =
// blockIdx.x / R; CTA c owns items c, c + G, ... of its rank in every epoch
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr int dq_smem() {
  return sizeof(T) == 2 ? ab::smem_bytes<D>() : 5 * kB * tile_ld<D>() * 4;
}
template <typename T, int D>
constexpr int dkv_smem() {
  return sizeof(T) == 2 ? ab::smem_bytes<D>() : 6 * kB * tile_ld<D>() * 4 + 2 * kB * 4;
}

// the fp32 rings: 64-row items of the scalar bodies above
template <int D>
__device__ __forceinline__ void dq_ring_f32(const BwdParams& p) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nq = (p.S + kB - 1) / kB, items = p.B * p.H * nq;
  const long long head = (long long)p.S * D;
  run_ring(
      g, r, c,
      [&] {
        copy_rows_share<T, D>(slot_ptr<T>(g, 0, r, 0), static_cast<const T*>(p.k), p.ks, r,
                              p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_rows_share<T, D>(slot_ptr<T>(g, 1, r, 0), static_cast<const T*>(p.v), p.vs, r,
                              p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
      },
      [&](int s, int t) {
        const T* ks = slot_ptr<T>(g, 0, r, t);
        const T* vs = slot_ptr<T>(g, 1, r, t);
        for (int it = c; it < items; it += g.G) {
          const int bh = it / nq;
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * state_dq<T, D>() * kThreadsF;
          dq_item<D>(p, smem, r, bh, it % nq, ks + bh * head, vs + bh * head, st, s == 0,
                     s == g.E - 1);
        }
      });
}

template <int D>
__device__ __forceinline__ void dkv_ring_f32(const BwdParams& p) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nk = (p.S + kB - 1) / kB, items = p.B * p.H * nk;
  const long long head = (long long)p.S * D;
  const long long dlt = (long long)p.B * p.H * p.Sp;  // the delta rows
  run_ring(
      g, r, c,
      [&] {
        copy_rows_share<T, D>(slot_ptr<T>(g, 0, r, 0), static_cast<const T*>(p.q), p.qs, r,
                              p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_rows_share<T, D>(slot_ptr<T>(g, 1, r, 0), static_cast<const T*>(p.dout), p.os,
                              r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_flat_share(slot_ptr<float>(g, 2, r, 0), p.meta + r * p.meta_words, g.bytes[2],
                        g.G, c);
      },
      [&](int s, int t) {
        const T* qs = slot_ptr<T>(g, 0, r, t);
        const T* os = slot_ptr<T>(g, 1, r, t);
        const float* ms = slot_ptr<float>(g, 2, r, t);
        for (int it = c; it < items; it += g.G) {
          const int bh = it / nk;
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * state_dkv<T, D>() * kThreadsF;
          const float* lb = ms + (long long)bh * p.Sp;
          dkv_item<D>(p, smem, r, bh, it % nk, qs + bh * head, os + bh * head, lb, lb + dlt,
                      st, s == 0, s == g.E - 1);
        }
      });
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T>::kThreads, 1)
    ring_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  if constexpr (sizeof(T) == 2)
    dq_ring_bf16<D>(p);
  else
    dq_ring_f32<D>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T>::kThreads, 1)
    ring_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  if constexpr (sizeof(T) == 2)
    dkv_ring_bf16<D>(p);
  else
    dkv_ring_f32<D>(p);
}

// the common arguments of both entry points
int fill_params(BwdParams& p, int dtype, int D, const void* q, const void* k, const void* v,
                const void* dout, const long long* st16, int B, int H, int S, float scale) {
  if (B < 1 || H < 1 || S < 1 || (dtype != 0 && dtype != 1) || (D != 64 && D != 80))
    return cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = st16[i];
    p.ks[i] = st16[4 + i];
    p.vs[i] = st16[8 + i];
    p.os[i] = st16[12 + i];
  }
  p.B = B;
  p.H = H;
  p.S = S;
  p.Sp = (S + kB - 1) / kB * kB;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return cudaSuccess;
}

// the bf16 maps at head_dim D: own rows a, b (rank-stacked, through the
// strides of p at sa, sb) and the slots of the rotating pair (at 80 with
// the tails)
template <int D>
int make_maps(BwdParams& p, const void* a, const long long (&sa)[4], const void* b,
              const long long (&sb)[4], const void* slot_a, const void* slot_b, int R) {
  const int B = p.B, H = p.H, S = p.S;
  int err;
  if ((err = own_map(&p.own_a, a, sa, R, B, S, H, ab::kTile, D)) != cudaSuccess ||
      (err = own_map(&p.own_b, b, sb, R, B, S, H, ab::kTile, D)) != cudaSuccess ||
      (err = slot_map(&p.slot_a, slot_a, R, B * H, S, ab::kTile, D)) != cudaSuccess ||
      (err = slot_map(&p.slot_b, slot_b, R, B * H, S, ab::kTile, D)) != cudaSuccess)
    return err;
  if (D == 64) {
    p.own_at = p.own_bt = p.slot_at = p.slot_bt = p.own_a;  // unused
    return cudaSuccess;
  }
  if ((err = own_map(&p.own_at, a, sa, R, B, S, H, ab::kTile, D, true)) != cudaSuccess ||
      (err = own_map(&p.own_bt, b, sb, R, B, S, H, ab::kTile, D, true)) != cudaSuccess ||
      (err = slot_map(&p.slot_at, slot_a, R, B * H, S, ab::kTile, D, true)) != cudaSuccess ||
      (err = slot_map(&p.slot_bt, slot_b, R, B * H, S, ab::kTile, D, true)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <int D>
int plan(int which, int dtype, int R, int* ctas, int* state_words_out, int* item_rows) {
  const int words = dtype == 1 ? (which == 0 ? state_dq<bf16, D>() : state_dkv<bf16, D>())
                               : (which == 0 ? state_dq<float, D>() : state_dkv<float, D>());
  *state_words_out = words * (dtype == 1 ? Cfg<bf16>::kAccThreads : Cfg<float>::kAccThreads);
  *item_rows = dtype == 1 ? Cfg<bf16>::kRows : Cfg<float>::kRows;
  if (which == 0)
    return dtype == 1 ? plan_ctas(ring_bwd_dq_kernel<bf16, D>, Cfg<bf16>::kThreads,
                                  dq_smem<bf16, D>(), R, ctas)
                      : plan_ctas(ring_bwd_dq_kernel<float, D>, kThreadsF, dq_smem<float, D>(),
                                  R, ctas);
  return dtype == 1 ? plan_ctas(ring_bwd_dkv_kernel<bf16, D>, Cfg<bf16>::kThreads,
                                dkv_smem<bf16, D>(), R, ctas)
                    : plan_ctas(ring_bwd_dkv_kernel<float, D>, kThreadsF, dkv_smem<float, D>(),
                                R, ctas);
}

template <int D>
int launch_dq(BwdParams& p, int dtype, const void* slot_k, const void* slot_v, int R,
              void* stream) {
  if (dtype == 1) {
    const int err = make_maps<D>(p, p.q, p.qs, p.dout, p.os, slot_k, slot_v, R);
    if (err != cudaSuccess) return err;
    return launch_ring(ring_bwd_dq_kernel<bf16, D>, Cfg<bf16>::kThreads, dq_smem<bf16, D>(), p,
                       p.ring, stream);
  }
  return launch_ring(ring_bwd_dq_kernel<float, D>, kThreadsF, dq_smem<float, D>(), p, p.ring,
                     stream);
}

template <int D>
int launch_dkv(BwdParams& p, int dtype, const void* slot_q, const void* slot_do, int R,
               void* stream) {
  if (dtype == 1) {
    const int err = make_maps<D>(p, p.k, p.ks, p.v, p.vs, slot_q, slot_do, R);
    if (err != cudaSuccess) return err;
    return launch_ring(ring_bwd_dkv_kernel<bf16, D>, Cfg<bf16>::kThreads, dkv_smem<bf16, D>(),
                       p, p.ring, stream);
  }
  return launch_ring(ring_bwd_dkv_kernel<float, D>, kThreadsF, dkv_smem<float, D>(), p, p.ring,
                     stream);
}

}  // namespace

extern "C" {

// which: 0 = the dq ring, 1 = the dk / dv ring; dtype: 0 = float32, 1 =
// bfloat16; D: the head_dim, 64 or 80.  *ctas: CTAs per rank that can be
// resident together with every other rank's (0: R ranks cannot be);
// *state_words: fp32 scratch words per item; *item_rows: the rows of an
// item (128 bf16, 64 fp32).
int fast3r_ring_attention_bwd_plan(int which, int dtype, int D, int R, int* ctas,
                                   int* state_words_out, int* item_rows) {
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || (D != 64 && D != 80))
    return cudaErrorInvalidValue;
  return D == 64 ? plan<64>(which, dtype, R, ctas, state_words_out, item_rows)
                 : plan<80>(which, dtype, R, ctas, state_words_out, item_rows);
}

// The dq ring.  q, k, v, dout: (R, B, S, H, D) read through their (rank,
// batch, token, head) strides (elements; 16-byte rows, and for bf16 the
// rank and batch strides merging, which the wrapper checks); lse, delta
// (R, B * H, S) fp32; dq (R, B, S, H, D) contiguous; state: R * items *
// state_words fp32 (null when R == 1); slot_k / slot_v / flags: host arrays
// of R device pointers, each rank's (2, B * H, S, D) slots (bf16: one
// allocation, rank r's 2 r slots in) and its 96 zeroed counter words.  G
// CTAs per rank.  Returns cudaGetLastError() after the launch (or the
// launch's own error).
int fast3r_ring_attention_bwd_dq(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    long long qs0, long long qs1, long long qs2, long long qs3, long long ks0, long long ks1,
    long long ks2, long long ks3, long long vs0, long long vs1, long long vs2, long long vs3,
    long long os0, long long os1, long long os2, long long os3, const void* lse,
    const void* delta, void* dq, void* state, const void* slot_k, const void* slot_v,
    const void* flags, int R, int B, int H, int S, int G, float scale, long long timeout_ns,
    void* stream) {
  BwdParams p{};
  const long long st16[16] = {qs0, qs1, qs2, qs3, ks0, ks1, ks2, ks3,
                              vs0, vs1, vs2, vs3, os0, os1, os2, os3};
  int err = fill_params(p, dtype, D, q, k, v, dout, st16, B, H, S, scale);
  if (err != cudaSuccess) return err;
  if (R > 1 && state == nullptr) return cudaErrorInvalidValue;
  const long long slot = (long long)B * H * S * D * (dtype == 1 ? 2 : 4);
  const long long bytes[2] = {slot, slot};
  const void* const* tables[2] = {static_cast<const void* const*>(slot_k),
                                  static_cast<const void* const*>(slot_v)};
  err = make_ring(p.ring, 2, tables, bytes, flags, R, R, G, timeout_ns);
  if (err != cudaSuccess) return err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = dq;
  p.state = static_cast<float*>(state);
  return D == 64 ? launch_dq<64>(p, dtype, slot_k, slot_v, R, stream)
                 : launch_dq<80>(p, dtype, slot_k, slot_v, R, stream);
}

// The dk / dv ring.  q, k, v, dout as above; meta (R, meta_words) fp32, the
// rows' lse (B * H, Sp) then their delta (B * H, Sp), Sp = S rounded up to
// a multiple of 64, so meta_words = 2 B H Sp; dk, dv (R, B, S, H, D)
// contiguous; state as above; slot_q / slot_do: each rank's (2, B * H, S,
// D) slots, slot_meta its (2, meta_words) fp32 slots; flags its 96 zeroed
// counter words.
int fast3r_ring_attention_bwd_dkv(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    long long qs0, long long qs1, long long qs2, long long qs3, long long ks0, long long ks1,
    long long ks2, long long ks3, long long vs0, long long vs1, long long vs2, long long vs3,
    long long os0, long long os1, long long os2, long long os3, const void* meta,
    long long meta_words, void* dk, void* dv, void* state, const void* slot_q,
    const void* slot_do, const void* slot_meta, const void* flags, int R, int B, int H, int S,
    int G, float scale, long long timeout_ns, void* stream) {
  BwdParams p{};
  const long long st16[16] = {qs0, qs1, qs2, qs3, ks0, ks1, ks2, ks3,
                              vs0, vs1, vs2, vs3, os0, os1, os2, os3};
  int err = fill_params(p, dtype, D, q, k, v, dout, st16, B, H, S, scale);
  if (err != cudaSuccess) return err;
  if ((R > 1 && state == nullptr) || meta_words != 2LL * B * H * p.Sp)
    return cudaErrorInvalidValue;
  const long long slot = (long long)B * H * S * D * (dtype == 1 ? 2 : 4);
  const long long bytes[3] = {slot, slot, meta_words * 4};
  const void* const* tables[3] = {static_cast<const void* const*>(slot_q),
                                  static_cast<const void* const*>(slot_do),
                                  static_cast<const void* const*>(slot_meta)};
  err = make_ring(p.ring, 3, tables, bytes, flags, R, R, G, timeout_ns);
  if (err != cudaSuccess) return err;
  p.meta = static_cast<const float*>(meta);
  p.meta_words = meta_words;
  p.out0 = dk;
  p.out1 = dv;
  p.state = static_cast<float*>(state);
  return D == 64 ? launch_dkv<64>(p, dtype, slot_q, slot_do, R, stream)
                 : launch_dkv<80>(p, dtype, slot_q, slot_do, R, stream);
}

}  // extern "C"
