// LayerNorm forward over the last axis for the port (K7's forward): x
// (rows, C) in fp32 or bf16, weight and bias (C,) in fp32 or bf16, y in x's
// dtype; fp32 two-pass statistics (the mean, then the mean of squared
// deviations) and fp32 affine, y = (x - mean) * rsqrt(var + eps) * w + b,
// rounded once.
//
// Replaces the TPU kernel fast3r_tpu/ops/fused_layernorm.py (_fwd_kernel, as
// called by _run_fwd), which normalises blocks of rows held whole in VMEM;
// here a warp holds a whole row in its registers.
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

}  // extern "C"
