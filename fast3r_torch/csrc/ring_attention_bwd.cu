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
//   * dq ring: items are (batch * head, 64-query block); K and V rotate (the
//     forward's payload); q, do and the rows' lse and delta stay local.  Epoch
//     s adds ds k over the K/V of rank (r - s) mod R;
//   * dk / dv ring: items are (batch * head, 64-key block); q, do and the
//     rows' (lse, delta) rotate, packed as two fp32 words per row in a third
//     payload (B * H, S, 2); K and V stay local, so dk and dv finish at the
//     shard's owner with no final permute.  Epoch s adds ds^T q and p^T do
//     over the q / do of rank (r - s) mod R.  A CTA copies its share of all
//     three payloads of a hop before it publishes, so a slot's counter
//     reaching fill * G means all three landed.
// The accumulators (dq, or dk and dv: fp32, 16 x 64 per warp in the mma
// fragment order) go through fp32 scratch between epochs, as the TPU
// kernels' HBM state does: with two slots the epoch order is outermost and
// a CTA walks many items per epoch.  dq, dk and dv are written at the last
// epoch.
//
// Layouts: lse is the forward kernel's (R, B * H, S) fp32, natural log,
// unpadded; the dq ring reads it and delta (R, B * H, S) fp32 one row per
// thread.  The dk / dv ring's (lse, delta) payload is (R, meta_words) fp32,
// its first B * H * S * 2 words the rows' pairs (meta_words a multiple of 4
// so a slot is whole 16-byte chunks), read with 8-byte ld.cg.
//
// What bounds it on an H100: the five products per (query, key) tile, 2.5x
// the forward's FLOPs, on the tensor cores, as in attention_bwd.cu, whose
// tile math this kernel runs (attention_tiles.cuh: 64-row items, 4 warps of
// 16 rows, 64-wide tiles double-buffered with cp.async, mma.sync m16n8k16
// bf16 products; the dk / dv ring works on the transposed scores).  The
// protocol adds the hops (2 bf16 payloads per hop for dq; 2 bf16 and the
// fp32 pairs for dk / dv) and the state traffic.  Rounding points: scores
// recomputed in fp32 from the forward's lse, p = exp2(s c - lse log2 e), ds
// = p (dp - delta) with delta = rowsum(do o) in fp32 from the rounded o
// (computed by the caller); p and ds rounded to bf16 before their products;
// fp32 accumulation; dq and dk scaled in fp32 and rounded once.  The scale
// stays in fp32 (the TPU kernels round q * scale * log2 e to bf16 first).
// Ragged S is masked.  The fp32 variants are scalar versions of the same
// tiling (two lanes per row), for tight checks.
// Not yet: wgmma, TMA, keeping the accumulators in shared memory, one rank
// per card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "ptx.cuh"
#include "ring_protocol.cuh"

namespace {

using namespace fast3r_ptx;
using namespace fast3r_ring;
using namespace fast3r_tiles;

constexpr int kD = 64;         // head dim
constexpr int kB = 64;         // rows of an item or tile (queries or keys)
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kLd = kTileLd;
constexpr int kLdF = kTileLdF;
constexpr int kTile = kB * kLd;
constexpr float kLog2e = 1.4426950408889634f;
// fp32 state words per thread of one item
constexpr int kStateDq = 32;   // the dq accumulator
constexpr int kStateDkv = 64;  // the dk and dv accumulators

struct BwdParams {
  Ring ring;  // dq: K, V slots; dk / dv: q, do slots (2, B * H, S, 64), (lse, delta)
  const void *q, *k, *v, *dout;
  long long qs[4], ks[4], vs[4], os[4];  // rank, batch, token, head strides (elements)
  const float* lse;    // dq: (R, B * H, S), natural log
  const float* delta;  // dq: (R, B * H, S)
  const float* meta;   // dk / dv: (R, meta_words), the rows' (lse, delta)
  long long meta_words;
  void* out0;     // dq, or dk: (R, B, S, H, 64) contiguous
  void* out1;     // dv
  float* state;   // (R, items, words, 128) fp32; null when E == 1
  int B, H, S;
  float scale, scale_log2;
};

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}
// a warp's 16 x 64 accumulator <-> state words [w0, w0 + 32) of its item
__device__ __forceinline__ void load_acc(float (&a)[8][4], const float* st, int w0) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = st[(w0 + n * 4 + e) * kThreads + threadIdx.x];
}
__device__ __forceinline__ void save_acc(const float (&a)[8][4], float* st, int w0) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[(w0 + n * 4 + e) * kThreads + threadIdx.x] = a[n][e];
}

// ---------------------------------------------------------------------------
// bf16 items
// ---------------------------------------------------------------------------

// 64 queries of (batch, head) bh of rank r against the slot's K / V (kb, vb:
// that head's (S, 64) rows); dq carried in st
__device__ void dq_item(const BwdParams& p, unsigned char* smem, int r, int bh, int qi,
                        const bf16* kb, const bf16* vb, float* st, bool first, bool last) {
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kTile;  // dO
  bf16* Ks = Os + kTile;  // two buffers each
  bf16* Vs = Ks + 2 * kTile;
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];
  const bf16* ob = static_cast<const bf16*>(p.dout) + r * p.os[0] + b * p.os[1] + h * p.os[3];

  cp_async_rows64<kLd>(Qs, qb, p.qs[2], q0, S);
  cp_async_rows64<kLd>(Os, ob, p.os[2], q0, S);
  cp_async_rows64<kLd>(Ks, kb, kD, 0, S);
  cp_async_rows64<kLd>(Vs, vb, kD, 0, S);
  cp_async_commit();

  // lse (log2 domain) and delta of this thread's rows g and g + 8
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long lrow = ((long long)r * p.B * p.H + bh) * S;
  const float l0 = r0 < S ? p.lse[lrow + r0] * kLog2e : 0.f;
  const float l1 = r1 < S ? p.lse[lrow + r1] * kLog2e : 0.f;
  const float d0 = r0 < S ? p.delta[lrow + r0] : 0.f;
  const float d1 = r1 < S ? p.delta[lrow + r1] : 0.f;

  uint32_t qf[4][4], of[4][4];
  float acc[8][4];
  if (first)
    zero(acc);
  else
    load_acc(acc, st, 0);

  const int ntiles = (S + kB - 1) / kB;
  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) {
      cp_async_rows64<kLd>(Ks + (sb ^ 1) * kTile, kb, kD, (t + 1) * kB, S);
      cp_async_rows64<kLd>(Vs + (sb ^ 1) * kTile, vb, kD, (t + 1) * kB, S);
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
    const bf16* Kt = Ks + sb * kTile;
    const bf16* Vt = Vs + sb * kTile;

    float s[8][4], dp[8][4];
    mma_abt(s, qf, Kt, lane);   // q k^T
    mma_abt(dp, of, Vt, lane);  // do v^T
    const int kbase = t * kB + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + j * 8 + e < S;
        const float p0 = ok ? exp2f(s[j][e] * p.scale_log2 - l0) : 0.f;
        const float p1 = ok ? exp2f(s[j][e + 2] * p.scale_log2 - l1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - d0);  // ds, in place
        s[j][e + 2] = p1 * (dp[j][e + 2] - d1);
      }
    }
    uint32_t dsf[4][4];
    pack_a(dsf, s);
    mma_pt(acc, dsf, Kt, lane);  // ds k
    __syncthreads();  // every warp is done with this buffer before refill
  }
  if (last) {
    bf16* dq = static_cast<bf16*>(p.out0) + ((long long)r * p.B + b) * S * p.H * kD + h * kD;
    store_rows(dq, (long long)p.H * kD, r0, S, acc, p.scale, c);
  } else {
    save_acc(acc, st, 0);
  }
}

// 64 keys of (batch, head) bh of rank r (its own K / V, through strides)
// against the slot's q / do (qb, ob: that head's (S, 64) rows) and (lse,
// delta) pairs (mb: its (S, 2) words); dk and dv carried in st
__device__ void dkv_item(const BwdParams& p, unsigned char* smem, int r, int bh, int ki,
                         const bf16* qb, const bf16* ob, const float* mb, float* st,
                         bool first, bool last) {
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile;
  bf16* Qs = Vs + kTile;      // two buffers each
  bf16* Os = Qs + 2 * kTile;  // dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * kTile);  // [2][kB] lse, log2 domain
  float* Ds = Ls + 2 * kB;                                // [2][kB] delta
  const int S = p.S, b = bh / p.H, h = bh % p.H, k0 = ki * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const bf16* kb = static_cast<const bf16*>(p.k) + r * p.ks[0] + b * p.ks[1] + h * p.ks[3];
  const bf16* vb = static_cast<const bf16*>(p.v) + r * p.vs[0] + b * p.vs[1] + h * p.vs[3];

  // a 64-query tile's (lse, delta) pairs, from the slot through L2 (the
  // buffer's previous reader finished behind a __syncthreads)
  auto load_meta = [&](int buf, int q0) {
    if (threadIdx.x < kB) {
      const int n = q0 + threadIdx.x;
      float2 m = make_float2(0.f, 0.f);
      if (n < S) m = __ldcg(reinterpret_cast<const float2*>(mb) + n);
      Ls[buf * kB + threadIdx.x] = m.x * kLog2e;
      Ds[buf * kB + threadIdx.x] = m.y;
    }
  };

  cp_async_rows64<kLd>(Ks, kb, p.ks[2], k0, S);
  cp_async_rows64<kLd>(Vs, vb, p.vs[2], k0, S);
  cp_async_rows64<kLd>(Qs, qb, kD, 0, S);
  cp_async_rows64<kLd>(Os, ob, kD, 0, S);
  cp_async_commit();
  load_meta(0, 0);

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
  if (first) {
    zero(dk);
    zero(dv);
  } else {
    load_acc(dk, st, 0);
    load_acc(dv, st, 32);
  }

  const int ntiles = (S + kB - 1) / kB;
  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) {
      cp_async_rows64<kLd>(Qs + (sb ^ 1) * kTile, qb, kD, (t + 1) * kB, S);
      cp_async_rows64<kLd>(Os + (sb ^ 1) * kTile, ob, kD, (t + 1) * kB, S);
      cp_async_commit();
      load_meta(sb ^ 1, (t + 1) * kB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a_frags(kf, Ks, warp, lane);
      load_a_frags(vf, Vs, warp, lane);
    }
    const bf16* Qt = Qs + sb * kTile;
    const bf16* Ot = Os + sb * kTile;
    const float* Lt = Ls + sb * kB;
    const float* Dt = Ds + sb * kB;

    // transposed scores: rows = this warp's 16 keys, columns = 64 queries
    float s[8][4], dp[8][4];
    mma_abt(s, kf, Qt, lane);  // k q^T
    const int qbase = t * kB + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = qbase + j * 8 + e < S;
        const float l = Lt[j * 8 + 2 * c + e];
        s[j][e] = ok ? exp2f(s[j][e] * p.scale_log2 - l) : 0.f;  // p^T
        s[j][e + 2] = ok ? exp2f(s[j][e + 2] * p.scale_log2 - l) : 0.f;
      }
    }
    uint32_t pf[4][4];
    pack_a(pf, s);
    mma_pt(dv, pf, Ot, lane);   // dv += p^T do
    mma_abt(dp, vf, Ot, lane);  // v do^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = qbase + j * 8 + e < S;
        const float d = Dt[j * 8 + 2 * c + e];
        s[j][e] = ok ? s[j][e] * (dp[j][e] - d) : 0.f;  // ds^T
        s[j][e + 2] = ok ? s[j][e + 2] * (dp[j][e + 2] - d) : 0.f;
      }
    }
    pack_a(pf, s);
    mma_pt(dk, pf, Qt, lane);  // dk += ds^T q
    __syncthreads();
  }
  if (last) {
    const long long base = ((long long)r * p.B + b) * S * p.H * kD + h * kD;
    const int r0 = k0 + warp * 16 + g;
    store_rows(static_cast<bf16*>(p.out0) + base, (long long)p.H * kD, r0, S, dk, p.scale, c);
    store_rows(static_cast<bf16*>(p.out1) + base, (long long)p.H * kD, r0, S, dv, 1.f, c);
  } else {
    save_acc(dk, st, 0);
    save_acc(dv, st, 32);
  }
}

// ---------------------------------------------------------------------------
// fp32 items: scalar FMAs, two lanes per row, each with half of the tile's
// columns and half of the head dim
// ---------------------------------------------------------------------------

__device__ void dq_item(const BwdParams& p, unsigned char* smem, int r, int bh, int qi,
                        const float* kb, const float* vb, float* st, bool first, bool last) {
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + kB * kLdF;
  float* Ks = Os + kB * kLdF;
  float* Vs = Ks + kB * kLdF;
  float* Ps = Vs + kB * kLdF;  // ds
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 2;  // this lane's query row in the item
  const int c0 = (lane & 1) * 32;        // its half of the keys, and of D
  const float* qb = static_cast<const float*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];
  const float* ob =
      static_cast<const float*>(p.dout) + r * p.os[0] + b * p.os[1] + h * p.os[3];

  load_rows_f32(Qs, qb, p.qs[2], q0, S);
  load_rows_f32(Os, ob, p.os[2], q0, S);
  const int n = q0 + row;
  const long long lrow = ((long long)r * p.B * p.H + bh) * S;
  const float l2 = n < S ? p.lse[lrow + n] * kLog2e : 0.f;
  const float dl = n < S ? p.delta[lrow + n] : 0.f;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = first ? 0.f : st[i * kThreads + tid];

  const float* qrow = Qs + row * kLdF;
  const float* orow = Os + row * kLdF;
  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();
    load_rows_f32(Ks, kb, kD, k0, S);
    load_rows_f32(Vs, vb, kD, k0, S);
    __syncthreads();
    for (int i = 0; i < 32; ++i) {
      const int j = c0 + i;
      const float* krow = Ks + j * kLdF;
      const float* vrow = Vs + j * kLdF;
      float sv = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) {
        sv = fmaf(qrow[d], krow[d], sv);
        dp = fmaf(orow[d], vrow[d], dp);
      }
      Ps[row * kLdF + j] = k0 + j < S ? exp2f(sv * p.scale_log2 - l2) * (dp - dl) : 0.f;
    }
    __syncwarp();
    for (int j = 0; j < kB; ++j) {
      const float ds = Ps[row * kLdF + j];
      const float* krow = Ks + j * kLdF + c0;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(ds, krow[i], acc[i]);
    }
    __syncwarp();
  }
  if (!last) {
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i * kThreads + tid] = acc[i];
  } else if (n < S) {
    float* dst = static_cast<float*>(p.out0) + (((long long)r * p.B + b) * S + n) * p.H * kD +
                 h * kD + c0;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = acc[i] * p.scale;
  }
  __syncthreads();  // the tiles are free for the next item
}

__device__ void dkv_item(const BwdParams& p, unsigned char* smem, int r, int bh, int ki,
                         const float* qb, const float* ob, const float* mb, float* st,
                         bool first, bool last) {
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
  const int c0 = (lane & 1) * 32;        // its half of the queries, and of D
  const float* kb = static_cast<const float*>(p.k) + r * p.ks[0] + b * p.ks[1] + h * p.ks[3];
  const float* vb = static_cast<const float*>(p.v) + r * p.vs[0] + b * p.vs[1] + h * p.vs[3];

  load_rows_f32(Ks, kb, p.ks[2], k0, S);
  load_rows_f32(Vs, vb, p.vs[2], k0, S);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = first ? 0.f : st[i * kThreads + tid];
    dv[i] = first ? 0.f : st[(32 + i) * kThreads + tid];
  }

  const float* krow = Ks + row * kLdF;
  const float* vrow = Vs + row * kLdF;
  for (int q0 = 0; q0 < S; q0 += kB) {
    __syncthreads();
    load_rows_f32(Qs, qb, kD, q0, S);
    load_rows_f32(Os, ob, kD, q0, S);
    if (tid < kB) {
      float2 m = make_float2(0.f, 0.f);
      if (q0 + tid < S) m = __ldcg(reinterpret_cast<const float2*>(mb) + q0 + tid);
      Ls[tid] = m.x * kLog2e;
      Ds[tid] = m.y;
    }
    __syncthreads();
    for (int i = 0; i < 32; ++i) {
      const int j = c0 + i;
      const float* qrow = Qs + j * kLdF;
      const float* orow = Os + j * kLdF;
      float sv = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) {
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
      const float* orow = Os + j * kLdF + c0;
      const float* qrow = Qs + j * kLdF + c0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dv[i] = fmaf(pv, orow[i], dv[i]);
        dk[i] = fmaf(ds, qrow[i], dk[i]);
      }
    }
    __syncwarp();
  }
  const int n = k0 + row;
  if (!last) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      st[i * kThreads + tid] = dk[i];
      st[(32 + i) * kThreads + tid] = dv[i];
    }
  } else if (n < S) {
    const long long o = (((long long)r * p.B + b) * S + n) * p.H * kD + h * kD + c0;
    float* dkd = static_cast<float*>(p.out0) + o;
    float* dvd = static_cast<float*>(p.out1) + o;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
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

template <typename T>
__host__ __device__ constexpr int dq_smem() {
  return sizeof(T) == 2 ? 6 * kTile * 2 : 5 * kB * kLdF * 4;
}
template <typename T>
__host__ __device__ constexpr int dkv_smem() {
  return sizeof(T) == 2 ? 6 * kTile * 2 + 4 * kB * 4 : 6 * kB * kLdF * 4 + 2 * kB * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nq = (p.S + kB - 1) / kB, items = p.B * p.H * nq;
  const long long head = (long long)p.S * kD;
  run_ring(
      g, r, c,
      [&] {
        copy_rows64_share<T>(slot_ptr<T>(g, 0, r, 0), static_cast<const T*>(p.k), p.ks, r,
                             p.B, p.H, p.S, g.G, c);
        copy_rows64_share<T>(slot_ptr<T>(g, 1, r, 0), static_cast<const T*>(p.v), p.vs, r,
                             p.B, p.H, p.S, g.G, c);
      },
      [&](int s, int t) {
        const T* ks = slot_ptr<T>(g, 0, r, t);
        const T* vs = slot_ptr<T>(g, 1, r, t);
        for (int it = c; it < items; it += g.G) {
          const int bh = it / nq;
          float* st = p.state == nullptr
                          ? nullptr
                          : p.state + ((long long)r * items + it) * kStateDq * kThreads;
          dq_item(p, smem, r, bh, it % nq, ks + bh * head, vs + bh * head, st, s == 0,
                  s == g.E - 1);
        }
      });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nk = (p.S + kB - 1) / kB, items = p.B * p.H * nk;
  const long long head = (long long)p.S * kD;
  run_ring(
      g, r, c,
      [&] {
        copy_rows64_share<T>(slot_ptr<T>(g, 0, r, 0), static_cast<const T*>(p.q), p.qs, r,
                             p.B, p.H, p.S, g.G, c);
        copy_rows64_share<T>(slot_ptr<T>(g, 1, r, 0), static_cast<const T*>(p.dout), p.os, r,
                             p.B, p.H, p.S, g.G, c);
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
                          : p.state + ((long long)r * items + it) * kStateDkv * kThreads;
          dkv_item(p, smem, r, bh, it % nk, qs + bh * head, os + bh * head,
                   ms + (long long)bh * p.S * 2, st, s == 0, s == g.E - 1);
        }
      });
}

// the common arguments of both entry points
int fill_params(BwdParams& p, int dtype, const void* q, const void* k, const void* v,
                const void* dout, const long long* st16, int B, int H, int S, float scale) {
  if (B < 1 || H < 1 || S < 1 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
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
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// which: 0 = the dq ring, 1 = the dk / dv ring; dtype: 0 = float32, 1 =
// bfloat16.  *ctas: CTAs per rank that can be resident together with every
// other rank's (0: R ranks cannot be); *state_words: fp32 scratch words per
// item.
int fast3r_ring_attention_bwd_plan(int which, int dtype, int R, int* ctas,
                                   int* state_words_out) {
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  *state_words_out = (which == 0 ? kStateDq : kStateDkv) * kThreads;
  if (which == 0)
    return dtype == 1 ? plan_ctas(ring_bwd_dq_kernel<bf16>, kThreads, dq_smem<bf16>(), R, ctas)
                      : plan_ctas(ring_bwd_dq_kernel<float>, kThreads, dq_smem<float>(), R,
                                  ctas);
  return dtype == 1 ? plan_ctas(ring_bwd_dkv_kernel<bf16>, kThreads, dkv_smem<bf16>(), R, ctas)
                    : plan_ctas(ring_bwd_dkv_kernel<float>, kThreads, dkv_smem<float>(), R,
                                ctas);
}

// The dq ring.  q, k, v, dout: (R, B, S, H, 64) read through their (rank,
// batch, token, head) strides (elements; 16-byte rows, which the wrapper
// checks); lse, delta (R, B * H, S) fp32; dq (R, B, S, H, 64) contiguous;
// state: R * items * state_words fp32 (null when R == 1); slot_k / slot_v /
// flags: host arrays of R device pointers, each rank's (2, B * H, S, 64)
// slots and its 96 zeroed counter words.  G CTAs per rank.  Returns
// cudaGetLastError() after the launch (or the launch's own error).
int fast3r_ring_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout, long long qs0,
    long long qs1, long long qs2, long long qs3, long long ks0, long long ks1, long long ks2,
    long long ks3, long long vs0, long long vs1, long long vs2, long long vs3, long long os0,
    long long os1, long long os2, long long os3, const void* lse, const void* delta, void* dq,
    void* state, const void* slot_k, const void* slot_v, const void* flags, int R, int B, int H,
    int S, int G, float scale, long long timeout_ns, void* stream) {
  BwdParams p{};
  const long long st16[16] = {qs0, qs1, qs2, qs3, ks0, ks1, ks2, ks3,
                              vs0, vs1, vs2, vs3, os0, os1, os2, os3};
  int err = fill_params(p, dtype, q, k, v, dout, st16, B, H, S, scale);
  if (err != cudaSuccess) return err;
  if (R > 1 && state == nullptr) return cudaErrorInvalidValue;
  const long long slot = (long long)B * H * S * kD * (dtype == 1 ? 2 : 4);
  const long long bytes[2] = {slot, slot};
  const void* const* tables[2] = {static_cast<const void* const*>(slot_k),
                                  static_cast<const void* const*>(slot_v)};
  err = make_ring(p.ring, 2, tables, bytes, flags, R, R, G, timeout_ns);
  if (err != cudaSuccess) return err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = dq;
  p.state = static_cast<float*>(state);
  if (dtype == 1)
    return launch_ring(ring_bwd_dq_kernel<bf16>, kThreads, dq_smem<bf16>(), p, p.ring, stream);
  return launch_ring(ring_bwd_dq_kernel<float>, kThreads, dq_smem<float>(), p, p.ring, stream);
}

// The dk / dv ring.  q, k, v, dout as above; meta (R, meta_words) fp32 with
// the rows' (lse, delta) pairs at [(b * H + h) * S + n] * 2 and meta_words
// a multiple of 4; dk, dv (R, B, S, H, 64) contiguous; state as above;
// slot_q / slot_do: each rank's (2, B * H, S, 64) slots, slot_meta its
// (2, meta_words) fp32 slots; flags its 96 zeroed counter words.
int fast3r_ring_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout, long long qs0,
    long long qs1, long long qs2, long long qs3, long long ks0, long long ks1, long long ks2,
    long long ks3, long long vs0, long long vs1, long long vs2, long long vs3, long long os0,
    long long os1, long long os2, long long os3, const void* meta, long long meta_words,
    void* dk, void* dv, void* state, const void* slot_q, const void* slot_do,
    const void* slot_meta, const void* flags, int R, int B, int H, int S, int G, float scale,
    long long timeout_ns, void* stream) {
  BwdParams p{};
  const long long st16[16] = {qs0, qs1, qs2, qs3, ks0, ks1, ks2, ks3,
                              vs0, vs1, vs2, vs3, os0, os1, os2, os3};
  int err = fill_params(p, dtype, q, k, v, dout, st16, B, H, S, scale);
  if (err != cudaSuccess) return err;
  if ((R > 1 && state == nullptr) || meta_words % 4 || meta_words < 2LL * B * H * S)
    return cudaErrorInvalidValue;
  const long long slot = (long long)B * H * S * kD * (dtype == 1 ? 2 : 4);
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
  if (dtype == 1)
    return launch_ring(ring_bwd_dkv_kernel<bf16>, kThreads, dkv_smem<bf16>(), p, p.ring,
                       stream);
  return launch_ring(ring_bwd_dkv_kernel<float>, kThreads, dkv_smem<float>(), p, p.ring,
                     stream);
}

}  // extern "C"
