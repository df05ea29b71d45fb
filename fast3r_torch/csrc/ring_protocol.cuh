// The hop protocol of the ring kernels (csrc/ring_attention.cu: the forward;
// csrc/ring_attention_bwd.cu: the dq and dk/dv rings), the counterpart of
// fast3r_tpu/parallel/ring_rdma.py _epoch_logistics, which the TPU's forward
// and both backward kernels share.
//
// R ranks each own two slots of every payload (the forward and the dq ring
// rotate K and V; the dk/dv ring rotates q, do and the rows' (lse, delta)),
// and 96 counter words.  A launch runs R x G persistent CTAs (rank r =
// blockIdx.x % R, its c-th CTA c = blockIdx.x / R) and E epochs:
//   * bootstrap: the rank's CTAs copy its own payloads into its slot 0;
//   * epoch s reads slot s % 2, which then holds the payloads of rank
//     (r - s) mod R; at its start each CTA sends its share of hop s + 1 (my
//     slot s % 2 -> the right neighbour's slot (s + 1) % 2), so the next
//     shard is in flight while the epoch computes;
//   * hop j >= 2 overwrites a slot the right neighbour used in epoch j - 2:
//     it waits for that neighbour's capacity token, which the neighbour's
//     last CTA to finish epoch j - 2 sends (every tile of the slot read and
//     every send out of it drained: a rank-local barrier through a counter);
//   * data is copied, fenced, then published with a release add to a
//     monotone per-slot fill counter; waiters spin on an acquire load of
//     their own counter.  A CTA copies its share of EVERY payload of a hop
//     before it publishes once, so a slot's fill f is complete, all payloads
//     of it, when its counter reaches f * G.  Counters count fills (never
//     toggled bits), so a late waiter cannot mistake fill f + 1 for fill f;
//     each launch gets freshly zeroed counters.  Scope .gpu: with the slots
//     peer-mapped (one rank per card) it becomes .sys and the pointer tables
//     hold peer pointers.
//   * Slot reads go through L2 (cp.async.cg, ld.cg, st.cg), so a stale L1
//     line of an earlier fill is never read.
// A CTA spins on counters other ranks' CTAs publish, so every CTA of every
// rank must be resident at once: G comes from the occupancy calculator, the
// launch is cooperative (refused, and the wrapper raises, when the grid
// cannot be resident), and a wait that outlasts timeout_ns traps instead of
// hanging.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fast3r_ring {

constexpr int kMaxRanks = 16;    // the pointer tables
constexpr int kMaxPayloads = 3;  // buffers rotating per hop
// counter words of each rank, one 128-byte line per kind
constexpr int kArrive = 0;  // [slot]: CTA shares that landed in my slot (bootstrap + hops)
constexpr int kDone = 32;   // [slot]: my CTAs done with the slot in an epoch
constexpr int kCap = 64;    // [slot]: capacity tokens from my right neighbour
constexpr int kFlagWords = 96;

struct Ring {
  char* slots[kMaxPayloads][kMaxRanks];  // rank r's payload i: 2 slots of bytes[i]
  long long bytes[kMaxPayloads];         // one slot of payload i, a multiple of 16
  unsigned* flags[kMaxRanks];            // rank r's kFlagWords counter words
  int npay, R, E, G;                     // payloads, ranks, epochs, CTAs per rank
  long long timeout_ns;
};

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

static __device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
static __device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
static __device__ __forceinline__ unsigned atom_acq_rel_add(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// every thread: block until *flag >= target (thread 0 spins, the block
// follows it through the barrier); trap after timeout_ns
static __device__ void wait_geq(const unsigned* flag, unsigned target, long long timeout_ns) {
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
static __device__ void publish(unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(flag, 1u);
}

// this CTA's share [lo, hi) of n items split over G CTAs
static __device__ __forceinline__ void share(long long n, int G, int c, long long& lo,
                                             long long& hi) {
  const long long per = (n + G - 1) / G;
  lo = (long long)c * per;
  hi = lo + per < n ? lo + per : n;
}

// bootstrap share of a rows-of-64 payload: rank r's (B, S, H, 64) tensor,
// read through its (rank, batch, token, head) strides st (elements, 16-byte
// rows), into dst laid out (B * H, S, 64)
template <typename T>
__device__ void copy_rows64_share(T* dst, const T* src, const long long (&st)[4], int r,
                                  int B, int H, int S, int G, int c) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = 64 / kVec;         // 16-byte chunks per row
  long long lo, hi;
  share((long long)B * H * S * kChunks, G, c, lo, hi);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const long long row = i / kChunks;  // (b * H + h) * S + token
    const int off = (int)(i % kChunks) * kVec;
    const int tok = (int)(row % S);
    const int bh = (int)(row / S);
    const int b = bh / H, h = bh % H;
    const long long so = r * st[0] + b * st[1] + tok * st[2] + h * st[3] + off;
    __stcg(reinterpret_cast<int4*>(dst + row * 64 + off),
           *reinterpret_cast<const int4*>(src + so));
  }
}

// bootstrap share of a flat payload: `bytes` (a multiple of 16) from src
static __device__ void copy_flat_share(void* dst, const void* src, long long bytes, int G,
                                       int c) {
  long long lo, hi;
  share(bytes / 16, G, c, lo, hi);
  const int4* s = static_cast<const int4*>(src);
  int4* d = static_cast<int4*>(dst);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) __stcg(d + i, s[i]);
}

// hop share: every payload of my slot `src` -> the right neighbour's slot
// `dst`, through L2
static __device__ void hop_share(const Ring& g, int r, int right, int src, int dst, int c) {
  for (int pi = 0; pi < g.npay; ++pi) {
    const long long n = g.bytes[pi] / 16;
    long long lo, hi;
    share(n, g.G, c, lo, hi);
    const int4* s = reinterpret_cast<const int4*>(g.slots[pi][r]) + src * n;
    int4* d = reinterpret_cast<int4*>(g.slots[pi][right]) + dst * n;
    long long i = lo + threadIdx.x;
    const int step = blockDim.x;
    for (; i + 7 * step < hi; i += 8 * step) {
      int4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = __ldcg(s + i + u * step);
#pragma unroll
      for (int u = 0; u < 8; ++u) __stcg(d + i + u * step, a[u]);
    }
    for (; i < hi; i += step) __stcg(d + i, __ldcg(s + i));
  }
}

// rank r's slot t of payload pi
template <typename T>
__device__ __forceinline__ T* slot_ptr(const Ring& g, int pi, int r, int t) {
  return reinterpret_cast<T*>(g.slots[pi][r] + t * g.bytes[pi]);
}

// The schedule, run by every CTA: bootstrap() copies this CTA's share of
// rank r's payloads into its slot 0; epoch(s, t) computes epoch s from
// slot t = s % 2 (holding rank (r - s) mod R's payloads).
template <class Bootstrap, class Epoch>
__device__ void run_ring(const Ring& g, int r, int c, Bootstrap&& bootstrap, Epoch&& epoch) {
  const int right = (r + 1) % g.R, left = (r + g.R - 1) % g.R;
  unsigned* flags = g.flags[r];
  bootstrap();
  publish(flags + kArrive + 0);
  for (int s = 0; s < g.E; ++s) {
    const int t = s & 1;
    const unsigned fill = (unsigned)(s / 2 + 1);  // slot t's fill that epoch s reads
    wait_geq(flags + kArrive + t, fill * g.G, g.timeout_ns);
    if (s + 1 < g.E) {  // hop s + 1: my slot t -> right's slot (s + 1) % 2
      const int j = s + 1;
      if (j >= 2) wait_geq(flags + kCap + (j & 1), (unsigned)(j / 2), g.timeout_ns);
      hop_share(g, r, right, t, j & 1, c);
      publish(g.flags[right] + kArrive + (j & 1));
    }
    epoch(s, t);
    if (s + 2 < g.E) {  // hop s + 2 refills slot t: release it when all my CTAs are done
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0 && atom_acq_rel_add(flags + kDone + t, 1u) == fill * g.G - 1)
        red_release_add(g.flags[left] + kCap + t, 1u);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Fill g from host arrays of R device pointers (one table per payload) and
// the payloads' slot sizes.
static inline int make_ring(Ring& g, int npay, const void* const* tables[],
                            const long long* bytes, const void* flags, int R, int E, int G,
                            long long timeout_ns) {
  if (R < 1 || R > kMaxRanks || E < 1 || G < 1 || npay < 1 || npay > kMaxPayloads)
    return cudaErrorInvalidValue;
  g.npay = npay;
  for (int pi = 0; pi < npay; ++pi) {
    if (bytes[pi] % 16) return cudaErrorInvalidValue;
    g.bytes[pi] = bytes[pi];
    for (int i = 0; i < R; ++i) g.slots[pi][i] = static_cast<char*>(const_cast<void*>(tables[pi][i]));
  }
  for (int i = 0; i < R; ++i) g.flags[i] = static_cast<unsigned* const*>(flags)[i];
  g.R = R;
  g.E = E;
  g.G = G;
  g.timeout_ns = timeout_ns;
  return cudaSuccess;
}

// how many CTAs of `kernel` (threads, dynamic smem bytes) each SM holds, and
// the SM count; cudaErrorNotSupported without cooperative launch
template <typename K>
cudaError_t resident_ctas(K kernel, int threads, int smem, int* per_sm, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
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

// CTAs per rank that can be resident with every other rank's (0: R ranks
// cannot be)
template <typename K>
int plan_ctas(K kernel, int threads, int smem, int R, int* ctas) {
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_ctas(kernel, threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  *ctas = R >= 1 && R <= kMaxRanks ? per_sm * sms / R : 0;
  return cudaSuccess;
}

// the cooperative launch of R x G CTAs with params p; refused (an error, no
// launch) when they cannot all be resident
template <typename K, typename P>
int launch_ring(K kernel, int threads, int smem, const P& p, const Ring& g, void* stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_ctas(kernel, threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if ((long long)g.R * g.G > (long long)per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  P copy = p;
  void* args[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(g.R * g.G),
                                    dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace fast3r_ring
