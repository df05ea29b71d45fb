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
// each rank owns two K and two V slots (2, B*H, S_loc, 64), so the comm
// memory is O(S_loc) whatever R is; a bootstrap copy into slot 0; hop j
// from my slot (j-1)%2 into the right neighbour's slot j%2 while epoch j-1
// computes; capacity tokens before a slot is reused; per-slot fill
// counters published with release adds; R x G persistent CTAs launched
// cooperatively; a wait that outlasts timeout_ns traps instead of hanging.
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

#include "attention_tiles.cuh"
#include "ptx.cuh"
#include "ring_protocol.cuh"

namespace {

using namespace fast3r_ptx;
using namespace fast3r_ring;
using fast3r_tiles::load_rows_f32;

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per item, 16 per warp
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kLd = kD + 8;   // bf16 smem row stride (144 B, ldmatrix conflict-free)
constexpr int kLdF = kD + 4;  // fp32 smem row stride
static_assert(kLdF == fast3r_tiles::kTileLdF, "attention_tiles.cuh's fp32 row stride");
constexpr float kLn2 = 0.6931471805599453f;

// per-thread fp32 state words of one item: acc[32] + m0, m1, l0, l1 (bf16
// tiles, mma fragment order) or acc[32] + m, l (fp32 tiles)
constexpr int kStateBf16 = 36;
constexpr int kStateF32 = 34;

using bf16 = __nv_bfloat16;

struct RingParams {
  Ring ring;                      // payloads: K and V slots (2, B * H, S, 64)
  const void* q;
  const void* k;
  const void* v;
  long long qs[4], ks[4], vs[4];  // rank, batch, token, head strides (elements)
  void* o;                        // (R, B, S, H, 64) contiguous
  float* lse;                     // (R, B * H, S) fp32, natural log
  float* state;                   // (R, items, words, 128) fp32; null when E == 1
  int B, H, S;                    // batch, heads, S_loc
  float scale_log2;
};

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
  const Ring& g = p.ring;
  const int r = blockIdx.x % g.R, c = blockIdx.x / g.R;
  const int nq = (p.S + kBQ - 1) / kBQ, items = p.B * p.H * nq;
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
                          : p.state + ((long long)r * items + it) * state_words<T>() * kThreads;
          ring_item(p, smem, r, bh, it % nq, ks + bh * head, vs + bh * head, st, s == 0,
                    s == g.E - 1);
        }
      });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  *ctas: how many CTAs per rank can be
// resident together with every other rank's (0: R ranks cannot be);
// *state_words: fp32 scratch words per item per thread.
int fast3r_ring_attention_plan(int dtype, int R, int* ctas, int* state_words_out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  *state_words_out = dtype == 1 ? kStateBf16 * kThreads : kStateF32 * kThreads;
  return dtype == 1 ? plan_ctas(ring_attention_fwd_kernel<bf16>, kThreads, smem_bytes<bf16>(),
                                R, ctas)
                    : plan_ctas(ring_attention_fwd_kernel<float>, kThreads,
                                smem_bytes<float>(), R, ctas);
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
  if (B < 1 || H < 1 || S < 1 || (E > 1 && state == nullptr) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  RingParams p{};
  const long long slot = (long long)B * H * S * kD * (dtype == 1 ? 2 : 4);
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
  if (dtype == 1)
    return launch_ring(ring_attention_fwd_kernel<bf16>, kThreads, smem_bytes<bf16>(), p,
                       p.ring, stream);
  return launch_ring(ring_attention_fwd_kernel<float>, kThreads, smem_bytes<float>(), p,
                     p.ring, stream);
}

}  // extern "C"
