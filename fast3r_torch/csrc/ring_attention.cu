// Ring attention forward with in-kernel hops over two slots per rank: for
// each of R ranks, softmax(scale * q_r [k_0 .. k_{R-1}]^T) [v_0 .. v_{R-1}],
// the K/V shards arriving one epoch at a time around the ring.
//
// Replaces the TPU kernel fast3r_tpu/parallel/ring_rdma.py (_rdma_forward ->
// _ring_fwd_kernel): the sequence-sharded decoder's global attention, where
// every rank holds S_loc query tokens and the K/V shards rotate.  Here the
// R ranks' buffers live on one card and run in one launch; the hop protocol
// is the TPU kernel's and is what carries over to NVLink:
//   * each rank owns two K and two V slots (2, B*H, S_loc, 64), so the comm
//     memory is O(S_loc) whatever R is, and its own counters (flags below);
//   * bootstrap: the rank's CTAs copy its own K/V into its slot 0;
//   * epoch s reads slot s % 2, which then holds the K/V of rank (r - s) mod
//     R; at its start each CTA sends its share of hop s + 1 (my slot s % 2
//     -> the right neighbour's slot (s + 1) % 2), so the next shard is in
//     flight while the epoch computes;
//   * hop j >= 2 overwrites a slot the right neighbour used in epoch j - 2:
//     it waits for that neighbour's capacity token, which the neighbour's
//     last CTA to finish epoch j - 2 sends (every tile of the slot read and
//     every send out of it drained: a rank-local barrier through a counter);
//   * data is copied, fenced, then published with a release add to a
//     monotone counter; waiters spin on an acquire load of their own
//     counter.  Counters are per slot and count fills (never toggled bits),
//     so a late waiter cannot mistake fill f + 1 for fill f.  Scope .gpu:
//     with the slots peer-mapped (one rank per card) it becomes .sys and the
//     pointer tables below hold peer pointers.
// A CTA spins on counters other ranks' CTAs publish, so every CTA of every
// rank must be resident at once: the grid is R x G persistent CTAs with G
// from the occupancy calculator, launched cooperatively (the launch fails,
// and the wrapper raises, when they cannot all be resident), and a wait
// that outlasts timeout_ns traps instead of hanging.
//
// What bounds it on an H100: the attention itself, 4 * S^2 * H * 64 FLOPs
// over the whole sequence, as in attention_fwd.cu (this kernel reuses its
// tiles: 64 queries of one (batch, head) per item, 4 warps, K/V in 64-key
// tiles double-buffered with cp.async, mma.sync m16n8k16 bf16 products,
// exp2 online softmax in registers, the row sum over the unrounded fp32 p).
// The protocol adds R * 2 * B*H*S_loc*64 elements copied per hop, and the
// online-softmax state (acc, m, l in fp32) of every (head, q-block) item
// goes through fp32 scratch between epochs, as the TPU kernel's HBM state
// does: a CTA walks many items per epoch, since with two slots the epoch
// order is outermost.  o is normalised and the natural-log lse written in
// the last epoch.  The fp32 variant is a scalar version of the same tiling,
// for tight checks.
// Not yet: wgmma, TMA, keeping the state in shared memory, one rank per card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace fast3r_ptx;

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per item, 16 per warp
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kLd = kD + 8;   // bf16 smem row stride (144 B, ldmatrix conflict-free)
constexpr int kLdF = kD + 4;  // fp32 smem row stride
constexpr int kMaxRanks = 16;
constexpr float kLn2 = 0.6931471805599453f;

// counter words of each rank, one 128-byte line per kind
constexpr int kArrive = 0;   // [slot]: CTA shares that landed in my slot (bootstrap + hops)
constexpr int kDone = 32;    // [slot]: my CTAs done with the slot in an epoch
constexpr int kCap = 64;     // [slot]: capacity tokens from my right neighbour

// per-thread fp32 state words of one item: acc[32] + m0, m1, l0, l1 (bf16
// tiles, mma fragment order) or acc[32] + m, l (fp32 tiles)
constexpr int kStateBf16 = 36;
constexpr int kStateF32 = 34;

using bf16 = __nv_bfloat16;

struct RingParams {
  const void* q;
  const void* k;
  const void* v;
  long long qs[4], ks[4], vs[4];  // rank, batch, token, head strides (elements)
  void* o;                        // (R, B, S, H, 64) contiguous
  float* lse;                     // (R, B * H, S) fp32, natural log
  float* state;                   // (R, items, words, 128) fp32; null when E == 1
  void* slot_k[kMaxRanks];        // rank r's K slots (2, B * H, S, 64)
  void* slot_v[kMaxRanks];
  unsigned* flags[kMaxRanks];     // rank r's counter words
  int R, E, B, H, S, G;           // ranks, epochs, batch, heads, S_loc, CTAs per rank
  float scale_log2;
  long long timeout_ns;
};

// ---------------------------------------------------------------------------
// the protocol
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned atom_acq_rel_add(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// every thread: block until *flag >= target (thread 0 spins, the block
// follows it through the barrier); trap after timeout_ns
__device__ void wait_geq(const unsigned* flag, unsigned target, long long timeout_ns) {
  if (threadIdx.x == 0 && ld_acquire(flag) < target) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(flag) < target) {
      if ((long long)(global_ns() - t0) > timeout_ns) __trap();
      __nanosleep(256);
    }
  }
  __syncthreads();
}

// every thread: this CTA's writes are done; add one to *flag (release)
__device__ void publish(unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(flag, 1u);
}

// this CTA's share [lo, hi) of n items split over G CTAs
__device__ __forceinline__ void share(long long n, int G, int c, long long& lo,
                                      long long& hi) {
  const long long per = (n + G - 1) / G;
  lo = (long long)c * per;
  hi = lo + per < n ? lo + per : n;
}

// bootstrap share: rank r's own K/V, read through their strides, into its
// slot 0 laid out (B * H, S, 64)
template <typename T>
__device__ void bootstrap_share(const RingParams& p, int r, int c) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = kD / kVec;         // 16-byte chunks per row
  long long lo, hi;
  share((long long)p.B * p.H * p.S * kChunks, p.G, c, lo, hi);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* dk = static_cast<T*>(p.slot_k[r]);
  T* dv = static_cast<T*>(p.slot_v[r]);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long row = i / kChunks;  // (b * H + h) * S + token
    const int off = (int)(i % kChunks) * kVec;
    const int tok = (int)(row % p.S);
    const int bh = (int)(row / p.S);
    const int b = bh / p.H, h = bh % p.H;
    const long long ko = r * p.ks[0] + b * p.ks[1] + tok * p.ks[2] + h * p.ks[3] + off;
    const long long vo = r * p.vs[0] + b * p.vs[1] + tok * p.vs[2] + h * p.vs[3] + off;
    __stcg(reinterpret_cast<int4*>(dk + row * kD + off),
           *reinterpret_cast<const int4*>(k + ko));
    __stcg(reinterpret_cast<int4*>(dv + row * kD + off),
           *reinterpret_cast<const int4*>(v + vo));
  }
}

// hop share: my slot `src` -> the right neighbour's slot `dst`, through L2
template <typename T>
__device__ void hop_share(const RingParams& p, int r, int right, int src, int dst, int c) {
  const long long n = (long long)p.B * p.H * p.S * kD * (long long)sizeof(T) / 16;
  long long lo, hi;
  share(n, p.G, c, lo, hi);
  const int4* sk = static_cast<const int4*>(p.slot_k[r]) + src * n;
  const int4* sv = static_cast<const int4*>(p.slot_v[r]) + src * n;
  int4* dk = static_cast<int4*>(p.slot_k[right]) + dst * n;
  int4* dv = static_cast<int4*>(p.slot_v[right]) + dst * n;
  long long i = lo + threadIdx.x;
  for (; i + 3 * kThreads < hi; i += 4 * kThreads) {
    int4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = __ldcg(sk + i + u * kThreads);
      b[u] = __ldcg(sv + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __stcg(dk + i + u * kThreads, a[u]);
      __stcg(dv + i + u * kThreads, b[u]);
    }
  }
  for (; i < hi; i += kThreads) {
    __stcg(dk + i, __ldcg(sk + i));
    __stcg(dv + i, __ldcg(sv + i));
  }
}

// ---------------------------------------------------------------------------
// one item: 64 queries of (batch, head) bh of rank r against the slot's K/V
// (kb, vb: that head's (S, 64) rows), the online-softmax state carried in st
// ---------------------------------------------------------------------------

__device__ void ring_item(const RingParams& p, unsigned char* smem, int r, int bh,
                          int qi, const bf16* kb, const bf16* vb, float* st,
                          bool first, bool last) {
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLd;      // two buffers
  bf16* Vs = Ks + 2 * kBK * kLd;  // two buffers
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;  // mma fragment row / column pair
  const bf16* qb = static_cast<const bf16*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];

  cp_async_rows64<kLd>(Qs, qb, p.qs[2], q0, S);
  cp_async_rows64<kLd>(Ks, kb, kD, 0, S);
  cp_async_rows64<kLd>(Vs, vb, kD, 0, S);
  cp_async_commit();

  float acc[8][4];  // O: 16 rows x 64 d as 8 n-tiles of 8
  float m0, m1, l0, l1;  // rows g and g + 8: running max (log2 domain), partial sum
  if (first) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m0 = m1 = -CUDART_INF_F;
    l0 = l1 = 0.f;
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = st[(n * 4 + e) * kThreads + tid];
    m0 = st[32 * kThreads + tid];
    m1 = st[33 * kThreads + tid];
    l0 = st[34 * kThreads + tid];
    l1 = st[35 * kThreads + tid];
  }

  uint32_t qf[4][4];  // this warp's 16 query rows as A fragments, 4 k-steps
  const int ntiles = (S + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int sb = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      cp_async_rows64<kLd>(Ks + (sb ^ 1) * kBK * kLd, kb, kD, (t + 1) * kBK, S);
      cp_async_rows64<kLd>(Vs + (sb ^ 1) * kBK * kLd, vb, kD, (t + 1) * kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + sb * kBK * kLd;
    const bf16* Vt = Vs + sb * kBK * kLd;

    float s[8][4];  // S = Q K^T: 16 rows x 64 keys as 8 n-tiles of 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + (lane & 7)) * kLd + kk * 16 + (lane >> 3) * 8);
        mma16816(s[j], qf[kk], kf[0], kf[1]);
        mma16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    const int kbase = t * kBK + 2 * c;  // ragged tail: keys past S masked
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + j * 8 + e < S;
        s[j][e] = ok ? s[j][e] * p.scale_log2 : -CUDART_INF_F;
        s[j][e + 2] = ok ? s[j][e + 2] * p.scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][e + 2]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[4][4];  // P as A fragments of the p v product, 4 k-steps
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                  n * 8 + (lane >> 4) * 8);
        mma16816(acc[n], pf[kk], vf[0], vf[1]);
        mma16816(acc[n + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  if (!last) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[(n * 4 + e) * kThreads + tid] = acc[n][e];
    st[32 * kThreads + tid] = m0;
    st[33 * kThreads + tid] = m1;
    st[34 * kThreads + tid] = l0;
    st[35 * kThreads + tid] = l1;
    return;
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if (c == 0) {
    float* lrow = p.lse + ((long long)r * p.B * p.H + bh) * S;
    if (r0 < S) lrow[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < S) lrow[r1] = (m1 + log2f(l1)) * kLn2;
  }
  bf16* ob = static_cast<bf16*>(p.o) + ((long long)r * p.B + b) * S * p.H * kD + h * kD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * p.H * kD + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * p.H * kD + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// rows [row0, row0 + 64) x 64 fp32 of a strided source -> smem rows of
// stride kLdF, through L2; rows at or past n_valid zero-filled
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long s_row, int row0, int n_valid) {
  for (int i = threadIdx.x; i < 64 * (kD / 4); i += kThreads) {
    const int rr = i / (kD / 4), col = (i % (kD / 4)) * 4;
    const int n = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid) val = __ldcg(reinterpret_cast<const float4*>(src + n * s_row + col));
    *reinterpret_cast<float4*>(dst + rr * kLdF + col) = val;
  }
}

// fp32: scalar FMAs, two lanes per query row (attention_fwd.cu's fp32 tiling)
__device__ void ring_item(const RingParams& p, unsigned char* smem, int r, int bh,
                          int qi, const float* kb, const float* vb, float* st,
                          bool first, bool last) {
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * kLdF;
  float* Vs = Ks + kBK * kLdF;
  float* Ps = Vs + kBK * kLdF;  // scores, then probabilities
  const int S = p.S, b = bh / p.H, h = bh % p.H, q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 2;  // this lane's query row in the item
  const int c0 = (lane & 1) * 32;        // its half of the keys, and of D
  const float* qb = static_cast<const float*>(p.q) + r * p.qs[0] + b * p.qs[1] + h * p.qs[3];

  load_rows_f32(Qs, qb, p.qs[2], q0, S);
  __syncthreads();
  float qreg[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qreg[d] = Qs[row * kLdF + d];

  float acc[32];
  float m, l;
  if (first) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    m = -CUDART_INF_F;
    l = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = st[i * kThreads + tid];
    m = st[32 * kThreads + tid];
    l = st[33 * kThreads + tid];
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_rows_f32(Ks, kb, kD, k0, S);
    load_rows_f32(Vs, vb, kD, k0, S);
    __syncthreads();

    float s[32];
    float tmax = -CUDART_INF_F;
    for (int i = 0; i < 32; ++i) {
      const float* krow = Ks + (c0 + i) * kLdF;
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) x = fmaf(qreg[d], krow[d], x);
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
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      const float pr = Ps[row * kLdF + j];
      const float* vrow = Vs + j * kLdF + c0;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(pr, vrow[i], acc[i]);
    }
    __syncwarp();
  }

  const int n = q0 + row;
  if (!last) {
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i * kThreads + tid] = acc[i];
    st[32 * kThreads + tid] = m;
    st[33 * kThreads + tid] = l;
  } else if (n < S) {
    if (c0 == 0) p.lse[((long long)r * p.B * p.H + bh) * S + n] = (m + log2f(l)) * kLn2;
    const float inv = 1.f / l;
    float* dst = static_cast<float*>(p.o) + (((long long)r * p.B + b) * S + n) * p.H * kD +
                 h * kD + c0;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = acc[i] * inv;
  }
  __syncthreads();  // Qs / Ks / Vs / Ps free for the next item
}

template <typename T>
__host__ __device__ constexpr int state_words() {
  return sizeof(T) == 2 ? kStateBf16 : kStateF32;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return sizeof(T) == 2 ? (kBQ + 4 * kBK) * kLd * 2 : 4 * 64 * kLdF * 4;
}

// grid: R x G CTAs, rank r = blockIdx.x % R, its c-th CTA c = blockIdx.x / R;
// CTA c owns items c, c + G, ... of its rank in every epoch
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_attention_fwd_kernel(const RingParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r = blockIdx.x % p.R, c = blockIdx.x / p.R;
  const int right = (r + 1) % p.R, left = (r + p.R - 1) % p.R;
  const int nq = (p.S + kBQ - 1) / kBQ, items = p.B * p.H * nq;
  const long long slot = (long long)p.B * p.H * p.S * kD;
  const long long head = (long long)p.S * kD;
  unsigned* flags = p.flags[r];

  bootstrap_share<T>(p, r, c);
  publish(flags + kArrive + 0);
  for (int s = 0; s < p.E; ++s) {
    const int t = s & 1;
    const unsigned fill = (unsigned)(s / 2 + 1);  // slot t's fill that epoch s reads
    wait_geq(flags + kArrive + t, fill * p.G, p.timeout_ns);
    if (s + 1 < p.E) {  // hop s + 1: my slot t -> right's slot (s + 1) % 2
      const int j = s + 1;
      if (j >= 2) wait_geq(flags + kCap + (j & 1), (unsigned)(j / 2), p.timeout_ns);
      hop_share<T>(p, r, right, t, j & 1, c);
      publish(p.flags[right] + kArrive + (j & 1));
    }
    const T* ks = static_cast<const T*>(p.slot_k[r]) + t * slot;
    const T* vs = static_cast<const T*>(p.slot_v[r]) + t * slot;
    for (int it = c; it < items; it += p.G) {
      const int bh = it / nq;
      float* st = p.state == nullptr
                      ? nullptr
                      : p.state + ((long long)r * items + it) * state_words<T>() * kThreads;
      ring_item(p, smem, r, bh, it % nq, ks + bh * head, vs + bh * head, st, s == 0,
                s == p.E - 1);
    }
    if (s + 2 < p.E) {  // hop s + 2 refills slot t: release it when all my CTAs are done
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0 &&
          atom_acq_rel_add(flags + kDone + t, 1u) == fill * p.G - 1)
        red_release_add(p.flags[left] + kCap + t, 1u);
    }
  }
}

template <typename T>
cudaError_t resident_ctas(int* per_sm, int* sms) {
  const int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(ring_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ring_attention_fwd_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T>
int launch(RingParams& p, void* stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_ctas<T>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  if ((long long)p.R * p.G > (long long)per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ring_attention_fwd_kernel<T>),
                                    dim3(p.R * p.G), dim3(kThreads), args,
                                    smem_bytes<T>(), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  *ctas: how many CTAs per rank can be
// resident together with every other rank's (0: R ranks cannot be);
// *state_words: fp32 scratch words per item per thread.
int fast3r_ring_attention_plan(int dtype, int R, int* ctas, int* state_words_out) {
  int per_sm = 0, sms = 0;
  cudaError_t err = dtype == 1 ? resident_ctas<bf16>(&per_sm, &sms)
                               : dtype == 0 ? resident_ctas<float>(&per_sm, &sms)
                                            : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  *ctas = R >= 1 && R <= kMaxRanks ? per_sm * sms / R : 0;
  *state_words_out = dtype == 1 ? kStateBf16 * kThreads : kStateF32 * kThreads;
  return cudaSuccess;
}

// q, k, v: (R, B, S, H, 64) read through their strides (elements; 16-byte
// rows, which the wrapper checks); o (R, B, S, H, 64) contiguous; lse
// (R, B * H, S) fp32; state: R * items * state_words fp32 (null when E ==
// 1); slot_k / slot_v / flags: host arrays of R device pointers, each rank's
// (2, B * H, S, 64) slots and its 96 zeroed counter words.  G CTAs per rank.
// Returns cudaGetLastError() after the launch (or the launch's own error).
int fast3r_ring_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                              long long qs0, long long qs1, long long qs2, long long qs3,
                              long long ks0, long long ks1, long long ks2, long long ks3,
                              long long vs0, long long vs1, long long vs2, long long vs3,
                              void* o, void* lse, void* state, const void* slot_k,
                              const void* slot_v, const void* flags, int R, int E, int B,
                              int H, int S, int G, float scale, long long timeout_ns,
                              void* stream) {
  if (R < 1 || R > kMaxRanks || E < 1 || G < 1 || B < 1 || H < 1 || S < 1 ||
      (E > 1 && state == nullptr))
    return cudaErrorInvalidValue;
  RingParams p{};
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
  for (int i = 0; i < R; ++i) {
    p.slot_k[i] = static_cast<void* const*>(slot_k)[i];
    p.slot_v[i] = static_cast<void* const*>(slot_v)[i];
    p.flags[i] = static_cast<unsigned* const*>(flags)[i];
  }
  p.R = R;
  p.E = E;
  p.B = B;
  p.H = H;
  p.S = S;
  p.G = G;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.timeout_ns = timeout_ns;
  if (dtype == 1) return launch<bf16>(p, stream);
  if (dtype == 0) return launch<float>(p, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
