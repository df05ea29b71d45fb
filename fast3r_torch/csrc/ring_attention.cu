// Ring attention forward with in-kernel hops over two slots per rank: for
// each of R ranks, softmax(scale * q_r [k_0 .. k_{R-1}]^T) [v_0 .. v_{R-1}],
// the K/V shards arriving one epoch at a time around the ring.
//
// Replaces the TPU kernel fast3r_tpu/parallel/ring_rdma.py (_rdma_forward ->
// _ring_fwd_kernel): the sequence-sharded decoder's global attention, where
// every rank holds S_loc query tokens and the K/V shards rotate.  Here the
// R ranks' buffers live on one card and run in one launch; the hop protocol
// is the TPU kernel's and is what carries over to NVLink.  It lives in
// ring_protocol.cuh, shared with the backward rings (ring_attention_bwd.cu):
// each rank owns two K and two V slots (2, B*H, S_loc, D), so the comm
// memory is O(S_loc) whatever R is; a bootstrap copy into slot 0 (fp32;
// bf16 reads epoch 0 in place); hop j from my slot (j-1)%2 into the right
// neighbour's slot j%2 while epoch j-1 computes; capacity tokens before a
// slot is reused; per-slot fill counters published with release adds; R x
// G persistent CTAs launched cooperatively; a wait that outlasts
// timeout_ns traps instead of hanging.
//
// What bounds it on an H100: the attention itself, 4 * S^2 * H * D FLOPs
// and S^2 * H exponentials over the whole sequence, as in attention_fwd.cu.
// The protocol adds R * 2 * B*H*S_loc*D elements copied per hop (R - 1
// hops, and in fp32 the bootstrap), and the
// online-softmax state (O, m, l in fp32, 36 KB an item) of every (head,
// q-block) item goes through fp32 scratch between epochs, as the TPU
// kernel's HBM state does: a CTA walks many items per epoch, since with two
// slots the epoch order is outermost.  o is normalised and the natural-log
// lse written in the last epoch.
//
// bf16 (the served and trained type): K1's tiles, attention_fwd_tile.cuh
// (items of 128 queries, wgmma m64n128 scores and RS P V, two consumer
// warpgroups taking turns), in a 384-thread CTA whose third warpgroup runs
// the protocol, so the consumers see a flat stream of (item, tile) and
// never wait on a counter.  It has no bootstrap (ring_protocol.cuh, the
// forward's schedule): epoch 0 reads the rank's own K and V where they lie
// and hop 1 sends them from there, so the first tiles load at once.
//   * warp 8, lane 0: loads each item's 128 queries and its K/V tiles
//     through rank-4 maps of q, k and v's own strides (rank and batch
//     merged) in epoch 0, and from slot s % 2 (one map over every rank's
//     slots) in epoch s >= 1, after waiting for the slot's fill (acquire)
//     and issuing fence.proxy.async;
//   * warps 9-11: every hop of the CTA's share (run_hops) and the capacity
//     tokens, sent once the consumers have waited for every tile of the
//     slot (an mbarrier per slot);
//   * the consumers: K1's item loop from a fresh state each epoch; the
//     earlier epochs' state (O, m, l) comes into shared memory by cp.async
//     while the item's tiles run and is merged at the item's end, then
//     saved, or, in the last epoch, o goes through K1's staging box and TMA
//     stores with the lse rows.
// The third warpgroup costs no registers: a CTA of 288 threads already gets
// the registers of 384 (168 a thread).  One CTA fits an SM (218 KB of
// shared memory: the tile's 181 and the state copy's 36); the occupancy
// API sizes G.
// The fp32 variant (for tight checks) is a scalar version of a 64-query
// tiling run by every thread through run_ring.
// Head_dim D is 64 or 80 (the model_scaling_huge decoder, 1280 / 16), a
// template argument of both variants.  At D = 80 the bf16 ring takes K1's
// tail tiles (attention_fwd_tile.cuh's note: each row of q, k, v and of the
// slots also read as a 16-column, 32-byte-swizzled box, 8 accumulator
// registers more, o's tail stored from registers), the slots, hops and
// tensor maps are sized by D, and the state grows by O's tail (44 words a
// thread).  The tail tiles leave no room for the state copy (217 KB of the
// 227), so at D = 80 the merge reads the earlier epochs' state from the
// scratch directly, after the item's tiles.  The fp32 variant's lanes each
// hold D / 2 columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_fwd_tile.cuh"
#include "attention_tiles.cuh"
#include "ring_protocol.cuh"

namespace {

namespace af = fast3r_attn_fwd;
namespace ab = fast3r_attn_bwd;
using namespace fast3r_ring;
using fast3r_tiles::load_rows_f32;
using fast3r_tiles::tile_ld;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;       // fp32: query rows per item, 16 per warp
constexpr int kBK = 64;       // fp32: keys per tile
constexpr int kThreads = 128; // fp32
constexpr float kLn2 = 0.6931471805599453f;
// per-thread fp32 state words of an fp32 item: acc D / 2, m, l
template <int D>
__host__ __device__ constexpr int state_f32() { return D / 2 + 2; }

// bf16: the consumers, the load warp and the three hop warps
constexpr int kRingThreads = af::kThreads;
constexpr int kHopBar = 12;  // named barrier of the hop warps (8-11: the tile's)

struct RingParams {
  CUtensorMap mq, mk0, mv0;  // bf16: own q, k, v rows, (D, S, H, R * B), 128-row boxes
  CUtensorMap mk, mv;        // bf16: every rank's K / V slots, (D, S, B * H, 2 R)
  CUtensorMap mo;            // bf16: o as (D, S, H, R * B), 64-row boxes
  CUtensorMap mqt, mk0t, mv0t, mkt, mvt;  // D = 80: the tail boxes of the five input maps
  Ring ring;               // payloads: K and V slots (2, B * H, S, D)
  const void* q;
  const void* k;
  const void* v;
  long long qs[4], ks[4], vs[4];  // rank, batch, token, head strides (elements)
  void* o;                        // (R, B, S, H, D) contiguous
  float* lse;                     // (R, B * H, S) fp32, natural log
  float* state;                   // (R, items, words, threads) fp32; null when E == 1
  int B, H, S;                    // batch, heads, S_loc
  float scale_log2;
};

// ---------------------------------------------------------------------------
// bf16: attention_fwd_tile.cuh's items in a warp-specialised CTA
// ---------------------------------------------------------------------------

// state words of a consumer thread: af::State's 36, and at D = 80 O's tail
template <int D>
__host__ __device__ constexpr int state_words() { return af::kStateWords + (D > 64 ? 8 : 0); }
// shared memory: the tile's and, at D = 64, a copy of each consumer
// thread's state words of its item (the same layout as the scratch's)
template <int D>
constexpr int ring_smem() {
  return D == 64 ? af::kSmemBytes + af::kStateWords * af::kConsumers * 4 : af::smem_bytes<D>();
}
__device__ __forceinline__ float* state_copy(af::Smem& sm) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(&sm) + sizeof(af::Smem));
}
// this thread's state words of an item, scratch -> its copy, by cp.async
// (the thread's own earlier stores, so no other ordering is needed)
__device__ __forceinline__ void fetch_state(float* held, const float* st) {
#pragma unroll
  for (int i = 0; i < af::kStateWords; ++i) {
    const int w = i * af::kConsumers + threadIdx.x;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     fast3r_hopper::smem_u32(held + w)),
                 "l"(st + w)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// D = 80: O's tail ot merged with an earlier partial's, kept at words 36 ..
// 43 of st; call before x.merge(st) (which moves x.m to the larger max)
__device__ __forceinline__ void merge_tail(const af::State& x, float (&ot)[8], const float* st,
                                           float scale_log2) {
  float a[2], b[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mo = st[(32 + h) * af::kConsumers + threadIdx.x];
    const float mx = fmaxf(mo, x.m[h]);
    a[h] = ab::ex2((mo - mx) * scale_log2);
    b[h] = ab::ex2((x.m[h] - mx) * scale_log2);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    ot[i] = st[(af::kStateWords + i) * af::kConsumers + threadIdx.x] * a[(i >> 1) & 1] +
            ot[i] * b[(i >> 1) & 1];
}

// grid: R x G CTAs, rank r = blockIdx.x % R, its c-th CTA c = blockIdx.x / R;
// CTA c owns items c, c + G, ... of its rank (batch * head, 128-query
// block) in every epoch
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    ring_attention_fwd_kernel(const __grid_constant__ RingParams p) {
  af::Smem& sm = af::smem();
  if (threadIdx.x == 0) af::init_barriers(sm);
  __syncthreads();
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nblk = (p.S + af::kRows - 1) / af::kRows, items = p.B * p.H * nblk;
  const int n = (p.S + af::kKeys - 1) / af::kKeys;
  af::OwnRing own;
  af::StageRing ring;
  if (threadIdx.x >= af::kConsumers) {
    fast3r_hopper::regs_dec<af::kProducerRegs>();
    const int tid = threadIdx.x - af::kConsumers;
    if (tid >= 32) {  // warps 9-11: the hops and the capacity tokens
      run_hops(
          g, r, c, tid - 32, 96, kHopBar,
          [&](int right, int i, int nth) {  // hop 1: my own K and V
            copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 0, right, 1),
                                     static_cast<const bf16*>(p.k), p.ks, r, p.B, p.H, p.S,
                                     g.G, c, i, nth);
            copy_rows_share<bf16, D>(slot_ptr<bf16>(g, 1, right, 1),
                                     static_cast<const bf16*>(p.v), p.vs, r, p.B, p.H, p.S,
                                     g.G, c, i, nth);
          },
          [&](int s) { fast3r_hopper::mbar_wait(&sm.done[s & 1], (unsigned)(s - 1) >> 1 & 1u); });
    } else if (tid == 0) {  // warp 8, lane 0: the loads
      for (int s = 0; s < g.E; ++s) {
        if (s > 0) {
          epoch_acquire(g, r, s);
          fast3r_hopper::fence_proxy_async();  // the hops' stores, then TMA reads
        }
        for (int it = c; it < items; it += g.G) {
          const int bh = it / nblk, b = bh / p.H, h = bh % p.H, q0 = (it % nblk) * af::kRows;
          if (s == 0)  // my own K and V, where they lie
            af::load_item<D>(sm, own, ring, &p.mq, q0, h, r * p.B + b, &p.mk0, &p.mv0, h,
                             r * p.B + b, n, af::TailMaps{&p.mqt, &p.mk0t, &p.mv0t});
          else
            af::load_item<D>(sm, own, ring, &p.mq, q0, h, r * p.B + b, &p.mk, &p.mv, bh,
                             2 * r + (s & 1), n, af::TailMaps{&p.mqt, &p.mkt, &p.mvt});
        }
      }
    }
    return;
  }
  fast3r_hopper::regs_inc<af::kConsumerRegs>();
  const af::Consumer t;
  float* held = state_copy(sm);
  ab::turns_open(t);
  for (int s = 0; s < g.E; ++s) {
    for (int it = c; it < items; it += g.G) {
      const int bh = it / nblk, b = bh / p.H, h = bh % p.H;
      float* st = p.state == nullptr
                      ? nullptr
                      : p.state + ((long long)r * items + it) * state_words<D>() * af::kConsumers;
      if (D == 64 && s > 0) fetch_state(held, st);  // lands while the item's tiles run
      af::State x;
      x.zero();
      float ot[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      af::fwd_item<D>(x, ot, sm, own, ring, t, n, p.S, p.scale_log2);
      if (s > 0) {
        if constexpr (D == 64) {
          cp_async_wait_all();
          x.merge(held, p.scale_log2);
        } else {
          merge_tail(x, ot, st, p.scale_log2);
          x.merge(st, p.scale_log2);
        }
      }
      if (s == g.E - 1) {
        bf16* o = static_cast<bf16*>(p.o);
        af::store_item<D>(x, sm, t, &p.mo, (it % nblk) * af::kRows, h, r * p.B + b,
                          p.lse + ((long long)r * p.B * p.H + bh) * p.S, p.S, p.scale_log2, ot,
                          o + (((long long)r * p.B + b) * p.S * p.H + h) * D + 64,
                          (long long)p.H * D);
      } else {
        x.save(st);
        if constexpr (D > 64) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            st[(af::kStateWords + i) * af::kConsumers + threadIdx.x] = ot[i];
        }
      }
    }
    if (s >= 1 && s + 2 < g.E) {  // every tile of slot s % 2 waited for: its next hop may come
      __syncwarp();
      if ((threadIdx.x & 31) == 0) fast3r_hopper::mbar_arrive(&sm.done[s & 1]);
    }
  }
  ab::turns_close(t);
  af::drain_stores();
}

// ---------------------------------------------------------------------------
// fp32: one item, 64 queries of (batch, head) bh of rank r against the
// slot's K/V (kb, vb: that head's (S, D) rows), the online-softmax state
// carried in st
// ---------------------------------------------------------------------------

// scalar FMAs, two lanes per query row (attention_fwd.cu's fp32 tiling):
// each lane takes half of the tile's keys and half of D
template <int D>
__device__ void ring_item_f32(const RingParams& p, unsigned char* smem, int r, int bh,
                              int qi, const float* kb, const float* vb, float* st,
                              bool first, bool last) {
  constexpr int kLdF = tile_ld<D>(), kHalfD = D / 2, kW = state_f32<D>();
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * kLdF;
  float* Vs = Ks + kBK * kLdF;
  float* Ps = Vs + kBK * kLdF;  // scores, then probabilities
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 2;  // this lane's query row in the item
  const int c0 = (lane & 1) * 32;        // its half of the keys
  const int d0 = (lane & 1) * kHalfD;    // and of D
  const float* qb = static_cast<const float*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];

  load_rows_f32<D>(Qs, qb, p.qs[2], q0, S);
  __syncthreads();
  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = Qs[row * kLdF + d];

  float acc[kHalfD];
  float m, l;
  if (first) {
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;
    m = -CUDART_INF_F;
    l = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) acc[i] = st[i * kThreads + tid];
    m = st[(kW - 2) * kThreads + tid];
    l = st[(kW - 1) * kThreads + tid];
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_rows_f32<D>(Ks, kb, D, k0, S);
    load_rows_f32<D>(Vs, vb, D, k0, S);
    __syncthreads();

    float s[32];
    float tmax = -CUDART_INF_F;
    for (int i = 0; i < 32; ++i) {
      const float* krow = Ks + (c0 + i) * kLdF;
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qreg[d], krow[d], x);
      s[i] = (k0 + c0 + i < S) ? x * p.scale_log2 : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pr = exp2f(s[i] - m_new);
      psum += pr;
      Ps[row * kLdF + c0 + i] = pr;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) acc[i] *= alpha;
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      const float pr = Ps[row * kLdF + j];
      const float* vrow = Vs + j * kLdF + d0;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(pr, vrow[i], acc[i]);
    }
    __syncwarp();
  }

  const int n = q0 + row;
  if (!last) {
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) st[i * kThreads + tid] = acc[i];
    st[(kW - 2) * kThreads + tid] = m;
    st[(kW - 1) * kThreads + tid] = l;
  } else if (n < S) {
    if (d0 == 0) p.lse[((long long)r * p.B * p.H + bh) * S + n] = (m + log2f(l)) * kLn2;
    const float inv = 1.f / l;
    float* dst = static_cast<float*>(p.o) + (((long long)r * p.B + b) * S + n) * p.H * D +
                 h * D + d0;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) dst[i] = acc[i] * inv;
  }
  __syncthreads();  // Qs / Ks / Vs / Ps free for the next item
}

template <int D>
__global__ void __launch_bounds__(kThreads) ring_attention_fwd_f32_kernel(const RingParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nq = (p.S + kBQ - 1) / kBQ, items = p.B * p.H * nq;
  const long long head = (long long)p.S * D;
  run_ring(
      g, r, c,
      [&] {
        copy_rows_share<float, D>(slot_ptr<float>(g, 0, r, 0), static_cast<const float*>(p.k),
                                  p.ks, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
        copy_rows_share<float, D>(slot_ptr<float>(g, 1, r, 0), static_cast<const float*>(p.v),
                                  p.vs, r, p.B, p.H, p.S, g.G, c, threadIdx.x, blockDim.x);
      },
      [&](int s, int t) {
        const float* ks = slot_ptr<float>(g, 0, r, t);
        const float* vs = slot_ptr<float>(g, 1, r, t);
        for (int it = c; it < items; it += g.G) {
          const int bh = it / nq;
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * state_f32<D>() * kThreads;
          ring_item_f32<D>(p, smem, r, bh, it % nq, ks + bh * head, vs + bh * head, st, s == 0,
                           s == g.E - 1);
        }
      });
}

template <int D>
constexpr int smem_f32() { return 4 * 64 * tile_ld<D>() * 4; }

template <int D>
int plan(int dtype, int R, int* ctas, int* state_words_out, int* item_rows) {
  *state_words_out = dtype == 1 ? state_words<D>() * af::kConsumers : state_f32<D>() * kThreads;
  *item_rows = dtype == 1 ? af::kRows : kBQ;
  return dtype == 1 ? plan_ctas(ring_attention_fwd_kernel<D>, kRingThreads, ring_smem<D>(), R,
                                ctas)
                    : plan_ctas(ring_attention_fwd_f32_kernel<D>, kThreads, smem_f32<D>(), R,
                                ctas);
}

// the tensor maps of a bf16 launch at head_dim D (at 80 with the tails)
template <int D>
int make_maps(RingParams& p, const void* q, const void* k, const void* v, void* o,
              const void* slot_k, const void* slot_v, int R, int B, int H, int S) {
  const long long os[4] = {(long long)B * S * H * D, (long long)S * H * D, (long long)H * D, D};
  int err;
  if ((err = own_map(&p.mq, q, p.qs, R, B, S, H, af::kRows, D)) != cudaSuccess ||
      (err = own_map(&p.mk0, k, p.ks, R, B, S, H, af::kKeys, D)) != cudaSuccess ||
      (err = own_map(&p.mv0, v, p.vs, R, B, S, H, af::kKeys, D)) != cudaSuccess ||
      (err = slot_map(&p.mk, slot_k, R, B * H, S, af::kKeys, D)) != cudaSuccess ||
      (err = slot_map(&p.mv, slot_v, R, B * H, S, af::kKeys, D)) != cudaSuccess ||
      (err = own_map(&p.mo, o, os, R, B, S, H, 64, D)) != cudaSuccess)
    return err;
  if (D == 64) {
    p.mqt = p.mk0t = p.mv0t = p.mkt = p.mvt = p.mq;  // unused
    return cudaSuccess;
  }
  if ((err = own_map(&p.mqt, q, p.qs, R, B, S, H, af::kRows, D, true)) != cudaSuccess ||
      (err = own_map(&p.mk0t, k, p.ks, R, B, S, H, af::kKeys, D, true)) != cudaSuccess ||
      (err = own_map(&p.mv0t, v, p.vs, R, B, S, H, af::kKeys, D, true)) != cudaSuccess ||
      (err = slot_map(&p.mkt, slot_k, R, B * H, S, af::kKeys, D, true)) != cudaSuccess ||
      (err = slot_map(&p.mvt, slot_v, R, B * H, S, af::kKeys, D, true)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <int D>
int launch(RingParams& p, int dtype, const void* q, const void* k, const void* v, void* o,
           const void* slot_k, const void* slot_v, int R, int B, int H, int S, void* stream) {
  if (dtype == 1) {
    const int err = make_maps<D>(p, q, k, v, o, slot_k, slot_v, R, B, H, S);
    if (err != cudaSuccess) return err;
    return launch_ring(ring_attention_fwd_kernel<D>, kRingThreads, ring_smem<D>(), p, p.ring,
                       stream);
  }
  return launch_ring(ring_attention_fwd_f32_kernel<D>, kThreads, smem_f32<D>(), p, p.ring,
                     stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the bf16 ring at head_dim 64 (the tile's and the
// state copy) and 80 (the tile's with its tails).
int fast3r_ring_attention_fwd_smem_bytes() { return ring_smem<64>(); }
int fast3r_ring_attention_fwd_smem_bytes_d80() { return ring_smem<80>(); }

// dtype: 0 = float32, 1 = bfloat16; D: the head_dim, 64 or 80.  *ctas: how
// many CTAs per rank can be resident together with every other rank's (0:
// R ranks cannot be); *state_words: fp32 scratch words per item;
// *item_rows: the queries of an item (bf16 128, fp32 64).
int fast3r_ring_attention_plan(int dtype, int D, int R, int* ctas, int* state_words_out,
                               int* item_rows) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 80)) return cudaErrorInvalidValue;
  return D == 64 ? plan<64>(dtype, R, ctas, state_words_out, item_rows)
                 : plan<80>(dtype, R, ctas, state_words_out, item_rows);
}

// q, k, v: (R, B, S, H, D) read through their strides (elements; 16-byte
// rows, and for bf16 q's rank and batch strides merging, which the wrapper
// checks); o (R, B, S, H, D) contiguous; lse (R, B * H, S) fp32; state: R *
// items * state_words fp32 (null when E == 1); slot_k / slot_v / flags: host
// arrays of R device pointers, each rank's (2, B * H, S, D) slots (bf16:
// one allocation, rank r's 2 r slots in) and its 96 zeroed counter words.
// G CTAs per rank.  Returns cudaGetLastError() after the launch (or the
// launch's own error).
int fast3r_ring_attention_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                              long long qs0, long long qs1, long long qs2, long long qs3,
                              long long ks0, long long ks1, long long ks2, long long ks3,
                              long long vs0, long long vs1, long long vs2, long long vs3,
                              void* o, void* lse, void* state, const void* slot_k,
                              const void* slot_v, const void* flags, int R, int E, int B,
                              int H, int S, int G, float scale, long long timeout_ns,
                              void* stream) {
  if (B < 1 || H < 1 || S < 1 || (E > 1 && state == nullptr) || (dtype != 0 && dtype != 1) ||
      (D != 64 && D != 80))
    return cudaErrorInvalidValue;
  RingParams p{};
  const long long slot = (long long)B * H * S * D * (dtype == 1 ? 2 : 4);
  const long long bytes[2] = {slot, slot};
  const void* const* tables[2] = {static_cast<const void* const*>(slot_k),
                                  static_cast<const void* const*>(slot_v)};
  int err = make_ring(p.ring, 2, tables, bytes, flags, R, E, G, timeout_ns);
  if (err != cudaSuccess) return err;
  p.q = q;
  p.k = k;
  p.v = v;
  const long long qs[4] = {qs0, qs1, qs2, qs3}, ks[4] = {ks0, ks1, ks2, ks3},
                  vs[4] = {vs0, vs1, vs2, vs3};
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = qs[i];
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
  }
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.state = static_cast<float*>(state);
  p.B = B;
  p.H = H;
  p.S = S;
  p.scale_log2 = scale * 1.4426950408889634f;
  return D == 64 ? launch<64>(p, dtype, q, k, v, o, slot_k, slot_v, R, B, H, S, stream)
                 : launch<80>(p, dtype, q, k, v, o, slot_k, slot_v, R, B, H, S, stream);
}

}  // extern "C"
