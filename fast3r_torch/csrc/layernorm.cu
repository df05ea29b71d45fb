// LayerNorm over the last axis for the port (K7): the forward and the
// backward.
//
// Forward: x (rows, C) in fp32 or bf16, weight and bias (C,) in fp32 or
// bf16, y in x's dtype; fp32 two-pass statistics (the mean, then the mean
// of squared deviations) and fp32 affine, y = (x - mean) * rsqrt(var +
// eps) * w + b, rounded once.  Replaces the TPU kernel
// fast3r_tpu/ops/fused_layernorm.py (_fwd_kernel, as called by _run_fwd),
// which normalises blocks of rows held whole in VMEM; here a warp holds a
// whole row in its registers.
//
// What bounds it on an H100: bytes.  It reads x once and writes y once, a
// few fp32 operations an element: 63 MB at (15360, 1024) in bf16, 18.8 us
// at 3.35 TB/s.  At that size the host's launch costs as much as the
// kernel: the Triton kernel this replaces ran within 1.21x of the bound on
// the device but spent 0.038-0.045 ms of host time a call in its Python
// launcher, twice its device time.  This one launches through the kernel
// library's plain C entry point (ctypes).
//
// Design, three roads chosen per call on the host:
//   * a warp per row (rows of at most 4 KB whose bytes are a multiple of
//     16): each lane holds its share of the row as 16-byte chunks (lane l
//     takes chunks l, l + 32, ...: each load instruction of the warp reads
//     512 contiguous bytes, all of a lane's loads in flight at once) and
//     the warp reduces by shuffles alone (no shared memory, no
//     __syncthreads).  The chunks stay packed between the passes
//     (unpacking again is cheaper than holding fp32 copies); weight and
//     bias come from L1 at the store, one 16-byte store per chunk.  The
//     grid gives each row a warp of its own: on the card that beat a
//     persistent walk of the rows by the CTAs that fit (by 4%) and a walk
//     of two rows a warp with the second's loads in flight during the
//     first's reductions (by 2%) at (15360, 1024) in bf16; only the 4 KB
//     rows (fp32 C = 1024), whose 150 registers a thread leave an SM 8
//     warps, walk two rows a warp (kWalk);
//   * a CTA per row (wider rows, up to 64 KB: C <= 16384 in fp32): the same
//     chunks over 512 threads, the two sums through shared memory;
//   * a scalar road for rows whose bytes are not a multiple of 16 (or
//     tensors that are not 16-byte aligned): a warp per row reads x three
//     times, one element a lane at a time, from L1 / L2 after the first.
//
// Backward (below the forward): dx in x's dtype, fp32 dweight = sum of
// dy * xhat and dbias = sum of dy over the rows, with mean and rstd
// recomputed from x by the forward's two-pass statistics, dx = (g -
// mean(g) - xhat mean(g xhat)) rstd for g = dy * w.  Replaces the TPU
// kernel fast3r_tpu/ops/fused_layernorm.py (_bwd_kernel, as called by
// _run_bwd).  Bound by bytes: x and dy read once, dx written once, 94 MB
// at (15360, 1024) in bf16, 28.2 us at 3.35 TB/s.  The Triton kernel it
// replaces walked about 15 rows a program one after another and cost
// three launches a call (a memset of its partials, the kernel, a torch
// sum) behind Triton's launcher.  Here one C call launches two kernels:
//   * ln_bwd_kernel / ln_bwd_cta_kernel / ln_bwd_scalar_kernel, the
//     forward's three roads: the warp road's warps walk rows (warp i of
//     the grid: rows i, i + warps, ...) holding x and dy in registers (on
//     rows of at most 2 KB the next row's too, its loads in flight during
//     this row's passes) and their lanes' columns of dweight and dbias in
//     fp32 registers, one CTA of 8 warps an SM; each
//     CTA sums its 8 warps' columns through shared memory in warp order
//     and writes one partial row of each in full (no memset).  The CTA
//     road's CTAs (one a row at a time) and the scalar road's warps own a
//     partial row in device memory, which each thread updates for its own
//     columns;
//   * ln_bwd_sum_kernel: the partial rows summed in a fixed order, 32
//     columns a CTA, 32 warps each a fixed stride of them, then the warps'
//     sums in warp order: deterministic, no float atomics.
// The host's plan (ops/fused_layernorm.bwd_plan) picks the road and the
// grid: the warp road runs the CTAs that fit on the card at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 256;        // the warp and scalar roads' CTA
constexpr int kCtaThreads = 512;   // the CTA road's

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over a CTA of THREADS threads, in every thread (red: a float
// a warp of shared memory, free again when this returns to every thread)
template <int THREADS>
__device__ __forceinline__ float cta_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float t = lane < (THREADS >> 5) ? red[lane] : 0.f;
  __syncthreads();
  return warp_sum(t);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// one parameter value as fp32, from an fp32 or a bf16 vector
__device__ __forceinline__ float param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// a 16-byte chunk of T as V fp32 values, and back
template <typename T, int V = 16 / sizeof(T)>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[V]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
}
template <typename T, int V = 16 / sizeof(T)>
__device__ __forceinline__ uint4 pack(const float (&f)[V]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f32<T>(f[i]);
  return u;
}

// the V parameter values of chunk v, as fp32 (16-byte aligned vectors)
template <int V>
__device__ __forceinline__ void load_param(const void* p, int v, int is_bf16,
                                           float (&f)[V]) {
  if (is_bf16) {
    const bf16* q = static_cast<const bf16*>(p) + v * V;
    if constexpr (V == 8) {
      unpack<bf16>(__ldg(reinterpret_cast<const uint4*>(q)), f);
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = __bfloat162float(e[i]);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + v * V);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = __ldg(q + i);
      f[4 * i] = t.x;
      f[4 * i + 1] = t.y;
      f[4 * i + 2] = t.z;
      f[4 * i + 3] = t.w;
    }
  }
}

// The vector roads: RT threads a row (32: a warp, 8 rows to a 256-thread
// CTA; kCtaThreads: a CTA), each holding the row's chunks idx, idx + RT, ...
// (NCH of them at most; those past the row's nvec are skipped).  Row group
// `g` (a warp or a CTA) of the grid normalises rows g, g + groups, ...
template <typename T, int NCH, int RT>
__global__ void __launch_bounds__(RT == 32 ? kBlock : RT)
ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ wp,
              const void* __restrict__ bp, T* __restrict__ y, int rows, int C,
              float eps, int w_bf16, int b_bf16) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kThreads = RT == 32 ? kBlock : RT;
  __shared__ float red[RT == 32 ? 1 : RT / 32];
  const int idx = threadIdx.x % RT;
  const int groups = gridDim.x * (kThreads / RT);
  const int nvec = C / V;
  const float inv_c = 1.f / static_cast<float>(C);
  auto sum = [&](float v) {
    if constexpr (RT == 32)
      return warp_sum(v);
    else
      return cta_sum<RT>(v, red);
  };
  auto load = [&](uint4 (&r)[NCH], int row) {
    const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * C);
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      if (k * RT + idx < nvec) r[k] = __ldcs(src + k * RT + idx);  // read once
  };

  int row = blockIdx.x * (kThreads / RT) + threadIdx.x / RT;
  if (row >= rows) return;  // whole row groups: a CTA's barriers stay whole
  uint4 cur[NCH], nxt[NCH];
  load(cur, row);
  for (; row < rows; row += groups) {
    if (row + groups < rows) load(nxt, row + groups);  // in flight meanwhile
    float f[V], s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * RT + idx < nvec) {
        unpack<T>(cur[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) s += f[e];
      }
    }
    const float mean = sum(s) * inv_c;
    s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * RT + idx < nvec) {
        unpack<T>(cur[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = f[e] - mean;
          s += d * d;
        }
      }
    }
    const float rstd = rsqrtf(sum(s) * inv_c + eps);
    uint4* dst = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * C);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * RT + idx;
      if (v < nvec) {
        float w[V], b[V];
        unpack<T>(cur[k], f);
        load_param(wp, v, w_bf16, w);
        load_param(bp, v, b_bf16, b);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = (f[e] - mean) * rstd * w[e] + b[e];
        dst[v] = pack<T>(f);
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) cur[k] = nxt[k];
  }
}

// the scalar road: warp `w` of the grid normalises rows w, w + warps, ...,
// one element a lane at a time
template <typename T>
__global__ void __launch_bounds__(kBlock)
ln_fwd_scalar_kernel(const T* __restrict__ x, const void* __restrict__ wp,
                     const void* __restrict__ bp, T* __restrict__ y, int rows,
                     int C, float eps, int w_bf16, int b_bf16) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * kBlock) >> 5;
  const float inv_c = 1.f / static_cast<float>(C);
  for (int row = (blockIdx.x * kBlock + threadIdx.x) >> 5; row < rows;
       row += warps) {
    const T* xr = x + static_cast<size_t>(row) * C;
    T* yr = y + static_cast<size_t>(row) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mean = warp_sum(s) * inv_c;
    s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      s += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s) * inv_c + eps);
    for (int c = lane; c < C; c += 32)
      yr[c] = from_f32<T>((to_f32(xr[c]) - mean) * rstd * param(wp, c, w_bf16) +
                          param(bp, c, b_bf16));
  }
}

// Rows a row group walks: two on the warp road's widest rows (4 KB, fp32
// C = 1024: at 150 registers a thread an SM holds 8 warps, and the second
// row's loads in flight make up for it), one elsewhere, where a warp for
// every row measured faster on the card (PERF.md)
template <int NCH, int RT>
constexpr int kWalk = RT == 32 && NCH == 8 ? 2 : 1;

// CTAs of a grid whose row groups, `per_cta` to a CTA, walk `walk` rows
inline int grid_for(int rows, int per_cta, int walk) {
  const long long groups = (rows + per_cta - 1LL) / per_cta;
  return static_cast<int>((groups + walk - 1) / walk);
}

template <typename T, int NCH, int RT>
void launch_vec(const T* x, const void* w, const void* b, T* y, int rows,
                int C, float eps, int w_bf16, int b_bf16, cudaStream_t s) {
  constexpr int threads = RT == 32 ? kBlock : RT;
  const int grid = grid_for(rows, threads / RT, kWalk<NCH, RT>);
  ln_fwd_kernel<T, NCH, RT><<<grid, threads, 0, s>>>(x, w, b, y, rows, C, eps,
                                                     w_bf16, b_bf16);
}

template <typename T>
void layernorm_fwd(const T* x, const void* w, const void* b, T* y, int rows,
                   int C, float eps, int w_bf16, int b_bf16, cudaStream_t s) {
  const long long bytes = static_cast<long long>(C) * sizeof(T);
  const long long nvec = bytes / 16;
  const bool vec = bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) &
                    15) == 0;
  if (vec && nvec <= 32)
    launch_vec<T, 1, 32>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 64)
    launch_vec<T, 2, 32>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 128)
    launch_vec<T, 4, 32>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 256)
    launch_vec<T, 8, 32>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= kCtaThreads)
    launch_vec<T, 1, kCtaThreads>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 2 * kCtaThreads)
    launch_vec<T, 2, kCtaThreads>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 4 * kCtaThreads)
    launch_vec<T, 4, kCtaThreads>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else if (vec && nvec <= 8 * kCtaThreads)
    launch_vec<T, 8, kCtaThreads>(x, w, b, y, rows, C, eps, w_bf16, b_bf16, s);
  else
    ln_fwd_scalar_kernel<T><<<grid_for(rows, kBlock / 32, 1), kBlock, 0, s>>>(
        x, w, b, y, rows, C, eps, w_bf16, b_bf16);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kWarps = kBlock / 32;  // the warp and scalar roads' CTA
constexpr int kSumThreads = 1024;

// the statistics of one row: mean, rstd, and the two means of the dx
// formula, mean(g) and mean(g xhat); fp32, in every thread of the row group
struct BwdStats {
  float mean, rstd, m1, m2;
};

// The warp road: RT = 32 threads a row.  Warp i of the grid takes rows i,
// i + warps, ...; a lane holds chunks lane, lane + 32, ... (NCH at most) of
// x and dy and its columns' sums of dy * xhat and dy.  At the end the CTA
// sums its warps' columns in warp order through shared memory (dynamic, 8 C
// floats) and writes partial rows blockIdx.x of part[0] and part[1].
template <typename T, int NCH>
__global__ void __launch_bounds__(kBlock, NCH <= 4 ? 2 : 1)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const void* __restrict__ wp, T* __restrict__ dx,
              float* __restrict__ part, int rows, int C, float eps,
              int w_bf16) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float red[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = gridDim.x * kWarps, nvec = C / V;
  const float inv_c = 1.f / static_cast<float>(C);
  float aw[NCH][V], ab[NCH][V];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) aw[k][e] = ab[k][e] = 0.f;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += warps) {
    const uint4* xs = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * C);
    const uint4* ds = reinterpret_cast<const uint4*>(dy + static_cast<size_t>(row) * C);
    uint4 xr[NCH], dr[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * 32 + lane < nvec) {
        xr[k] = __ldcs(xs + k * 32 + lane);  // read once
        dr[k] = __ldcs(ds + k * 32 + lane);
      }
    }
    float f[V], g[V], w[V], s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * 32 + lane < nvec) {
        unpack<T>(xr[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) s += f[e];
      }
    }
    BwdStats st;
    st.mean = warp_sum(s) * inv_c;
    s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * 32 + lane < nvec) {
        unpack<T>(xr[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = f[e] - st.mean;
          s += d * d;
        }
      }
    }
    st.rstd = rsqrtf(warp_sum(s) * inv_c + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * 32 + lane;
      if (v < nvec) {
        unpack<T>(xr[k], f);
        unpack<T>(dr[k], g);
        load_param(wp, v, w_bf16, w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gw = g[e] * w[e];
          s1 += gw;
          s2 += gw * ((f[e] - st.mean) * st.rstd);
        }
      }
    }
    st.m1 = warp_sum(s1) * inv_c;
    st.m2 = warp_sum(s2) * inv_c;
    uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * C);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * 32 + lane;
      if (v < nvec) {
        unpack<T>(xr[k], f);
        unpack<T>(dr[k], g);
        load_param(wp, v, w_bf16, w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (f[e] - st.mean) * st.rstd;
          aw[k][e] += g[e] * xh;
          ab[k][e] += g[e];
          f[e] = (g[e] * w[e] - st.m1 - xh * st.m2) * st.rstd;
        }
        dst[v] = pack<T>(f);
      }
    }
  }
  // the CTA's partial rows: its warps' columns summed in warp order
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * 32 + lane;
      if (v < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e)
          red[warp * C + v * V + e] = which == 0 ? aw[k][e] : ab[k][e];
    }
    __syncthreads();
    float* out = part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) * C;
    for (int c = threadIdx.x; c < C; c += kBlock) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) t += red[i * C + c];
      out[c] = t;
    }
    __syncthreads();
  }
}

// The CTA road: kCtaThreads threads a row, CTA b of the grid takes rows b,
// b + grid, ...; thread idx holds chunks idx, idx + kCtaThreads, ... and
// adds its columns of dy * xhat and dy into the CTA's partial rows in
// device memory (its own columns only, so no other thread touches them)
template <typename T, int NCH>
__global__ void __launch_bounds__(kCtaThreads)
ln_bwd_cta_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const void* __restrict__ wp, T* __restrict__ dx,
                  float* __restrict__ part, int rows, int C, float eps,
                  int w_bf16) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kCtaThreads / 32];
  const int idx = threadIdx.x, nvec = C / V;
  const float inv_c = 1.f / static_cast<float>(C);
  float* pw = part + static_cast<size_t>(blockIdx.x) * C;
  float* pb = part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int v = k * kCtaThreads + idx;
    if (v < nvec)
#pragma unroll
      for (int e = 0; e < V; ++e) pw[v * V + e] = pb[v * V + e] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* xs = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * C);
    const uint4* ds = reinterpret_cast<const uint4*>(dy + static_cast<size_t>(row) * C);
    uint4 xr[NCH], dr[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * kCtaThreads + idx;
      if (v < nvec) {
        xr[k] = __ldcs(xs + v);
        dr[k] = __ldcs(ds + v);
      }
    }
    float f[V], g[V], w[V], s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * kCtaThreads + idx < nvec) {
        unpack<T>(xr[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) s += f[e];
      }
    }
    const float mean = cta_sum<kCtaThreads>(s, red) * inv_c;
    s = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k * kCtaThreads + idx < nvec) {
        unpack<T>(xr[k], f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = f[e] - mean;
          s += d * d;
        }
      }
    }
    const float rstd = rsqrtf(cta_sum<kCtaThreads>(s, red) * inv_c + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * kCtaThreads + idx;
      if (v < nvec) {
        unpack<T>(xr[k], f);
        unpack<T>(dr[k], g);
        load_param(wp, v, w_bf16, w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gw = g[e] * w[e];
          s1 += gw;
          s2 += gw * ((f[e] - mean) * rstd);
        }
      }
    }
    const float m1 = cta_sum<kCtaThreads>(s1, red) * inv_c;
    const float m2 = cta_sum<kCtaThreads>(s2, red) * inv_c;
    uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * C);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int v = k * kCtaThreads + idx;
      if (v < nvec) {
        unpack<T>(xr[k], f);
        unpack<T>(dr[k], g);
        load_param(wp, v, w_bf16, w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (f[e] - mean) * rstd;
          pw[v * V + e] += g[e] * xh;
          pb[v * V + e] += g[e];
          f[e] = (g[e] * w[e] - m1 - xh * m2) * rstd;
        }
        dst[v] = pack<T>(f);
      }
    }
  }
}

// The scalar road: warp i of the grid takes rows i, i + warps, ..., one
// element a lane at a time, and adds into its own partial rows in device
// memory (lane l: columns l, l + 32, ...)
template <typename T>
__global__ void __launch_bounds__(kBlock)
ln_bwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const void* __restrict__ wp, T* __restrict__ dx,
                     float* __restrict__ part, int rows, int C, float eps,
                     int w_bf16) {
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int warps = (gridDim.x * kBlock) >> 5;
  const float inv_c = 1.f / static_cast<float>(C);
  float* pw = part + static_cast<size_t>(gw) * C;
  float* pb = part + (static_cast<size_t>(warps) + gw) * C;
  for (int c = lane; c < C; c += 32) pw[c] = pb[c] = 0.f;
  for (int row = gw; row < rows; row += warps) {
    const T* xr = x + static_cast<size_t>(row) * C;
    const T* dr = dy + static_cast<size_t>(row) * C;
    T* dxr = dx + static_cast<size_t>(row) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mean = warp_sum(s) * inv_c;
    s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      s += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s) * inv_c + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gw_ = to_f32(dr[c]) * param(wp, c, w_bf16);
      s1 += gw_;
      s2 += gw_ * ((to_f32(xr[c]) - mean) * rstd);
    }
    const float m1 = warp_sum(s1) * inv_c, m2 = warp_sum(s2) * inv_c;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f32(xr[c]) - mean) * rstd, g = to_f32(dr[c]);
      pw[c] += g * xh;
      pb[c] += g;
      dxr[c] = from_f32<T>((g * param(wp, c, w_bf16) - m1 - xh * m2) * rstd);
    }
  }
}

// out[which][c] = sum over p of part[which][p][c], for which = blockIdx.y:
// 32 columns a CTA, warp i summing partials i, i + 32, ..., then the 32
// warps' sums in warp order
__global__ void __launch_bounds__(kSumThreads)
ln_bwd_sum_kernel(const float* __restrict__ part, int P, int C,
                  float* __restrict__ out) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* src = part + static_cast<size_t>(blockIdx.y) * P * C;
  float t = 0.f;
  if (c < C)
    for (int p = warp; p < P; p += 32) t += src[static_cast<size_t>(p) * C + c];
  red[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && c < C) {
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) u += red[i][lane];
    out[static_cast<size_t>(blockIdx.y) * C + c] = u;
  }
}

template <typename T, int NCH>
cudaError_t launch_bwd_warp(const T* x, const T* dy, const void* w, T* dx,
                            float* part, int rows, int C, float eps,
                            int w_bf16, int ctas, cudaStream_t s) {
  const int smem = kWarps * C * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWarps * 2048 * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ln_bwd_kernel<T, NCH><<<ctas, kBlock, smem, s>>>(x, dy, w, dx, part, rows,
                                                  C, eps, w_bf16);
  return cudaGetLastError();
}

// road 0: a warp a row (16-byte rows of at most 4 KB), ctas CTAs of 8 warps,
// ctas partial rows; road 1: a CTA a row (up to 4096 chunks), ctas partial
// rows; road 2: scalar, ctas CTAs of 8 warps, 8 ctas partial rows
template <typename T>
cudaError_t layernorm_bwd(const T* x, const T* dy, const void* w, T* dx,
                          float* part, float* dwdb, int rows, int C,
                          float eps, int w_bf16, int road, int ctas,
                          cudaStream_t s) {
  const long long bytes = static_cast<long long>(C) * sizeof(T);
  const long long nvec = bytes / 16;
  const bool vec = bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(w)) &
                    15) == 0;
  cudaError_t err = cudaSuccess;
  int P = ctas;
  if (road == 0 && vec && nvec <= 32) {
    err = launch_bwd_warp<T, 1>(x, dy, w, dx, part, rows, C, eps, w_bf16, ctas, s);
  } else if (road == 0 && vec && nvec <= 64) {
    err = launch_bwd_warp<T, 2>(x, dy, w, dx, part, rows, C, eps, w_bf16, ctas, s);
  } else if (road == 0 && vec && nvec <= 128) {
    err = launch_bwd_warp<T, 4>(x, dy, w, dx, part, rows, C, eps, w_bf16, ctas, s);
  } else if (road == 0 && vec && nvec <= 256) {
    err = launch_bwd_warp<T, 8>(x, dy, w, dx, part, rows, C, eps, w_bf16, ctas, s);
  } else if (road == 1 && vec && nvec <= kCtaThreads) {
    ln_bwd_cta_kernel<T, 1><<<ctas, kCtaThreads, 0, s>>>(x, dy, w, dx, part, rows, C, eps, w_bf16);
  } else if (road == 1 && vec && nvec <= 2 * kCtaThreads) {
    ln_bwd_cta_kernel<T, 2><<<ctas, kCtaThreads, 0, s>>>(x, dy, w, dx, part, rows, C, eps, w_bf16);
  } else if (road == 1 && vec && nvec <= 4 * kCtaThreads) {
    ln_bwd_cta_kernel<T, 4><<<ctas, kCtaThreads, 0, s>>>(x, dy, w, dx, part, rows, C, eps, w_bf16);
  } else if (road == 1 && vec && nvec <= 8 * kCtaThreads) {
    ln_bwd_cta_kernel<T, 8><<<ctas, kCtaThreads, 0, s>>>(x, dy, w, dx, part, rows, C, eps, w_bf16);
  } else if (road == 2) {
    ln_bwd_scalar_kernel<T><<<ctas, kBlock, 0, s>>>(x, dy, w, dx, part, rows, C, eps, w_bf16);
    P = ctas * kWarps;
  } else {
    return cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_sum_kernel<<<dim3((C + 31) / 32, 2), kSumThreads, 0, s>>>(part, P, C,
                                                                  dwdb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y (rows, C), contiguous, bf16 if x_bf16 else fp32; w and b (C,),
// contiguous, each bf16 if its flag is set else fp32; all on CUDA device
// `device`, which is made current for the launch and then restored.  Takes
// C up to 16384 in fp32 (rows of at most 64 KB) on the vector roads and any
// C on the scalar one.  Returns cudaGetLastError().
int fast3r_layernorm_fwd(const void* x, const void* w, const void* b, void* y,
                         int rows, int C, int x_bf16, int w_bf16, int b_bf16,
                         float eps, int device, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (C <= 0) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    layernorm_fwd(static_cast<const bf16*>(x), w, b, static_cast<bf16*>(y),
                  rows, C, eps, w_bf16, b_bf16, s);
  else
    layernorm_fwd(static_cast<const float*>(x), w, b, static_cast<float*>(y),
                  rows, C, eps, w_bf16, b_bf16, s);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return err;
}

// dx = the LayerNorm backward of dy at x (rows, C), fp32 dwdb = (dweight,
// dbias) as (2, C); x, dy, dx contiguous, bf16 if x_bf16 else fp32; w (C,)
// bf16 if w_bf16 else fp32; part a (2, P, C) fp32 scratch of the plan's P
// partial rows (ops/fused_layernorm.bwd_plan: road 0 and 1 P = ctas, road 2
// P = 8 ctas), written in full; all on CUDA device `device`, made current
// for the launches and then restored.  rows > 0.  Returns
// cudaGetLastError().
int fast3r_layernorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                         void* part, void* dwdb, int rows, int C, int x_bf16,
                         int w_bf16, int road, int ctas, float eps, int device,
                         void* stream) {
  if (rows <= 0 || C <= 0 || ctas <= 0) return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(dwdb);
  if (x_bf16)
    err = layernorm_bwd(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                        w, static_cast<bf16*>(dx), p, o, rows, C, eps, w_bf16,
                        road, ctas, s);
  else
    err = layernorm_bwd(static_cast<const float*>(x),
                        static_cast<const float*>(dy), w,
                        static_cast<float*>(dx), p, o, rows, C, eps, w_bf16,
                        road, ctas, s);
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
