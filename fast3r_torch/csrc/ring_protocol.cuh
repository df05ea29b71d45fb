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

#include "hopper.cuh"

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
// named barrier `id` (1..15) over `count` threads
static __device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// one thread: until *flag >= target (acquire); trap after timeout_ns
static __device__ void spin_until(const unsigned* flag, unsigned target, long long timeout_ns) {
  if (ld_acquire(flag) >= target) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < target) {
    if ((long long)(global_ns() - t0) > timeout_ns) __trap();
    __nanosleep(256);
  }
}

// every thread: block until *flag >= target (thread 0 spins, the block
// follows it through the barrier)
static __device__ void wait_geq(const unsigned* flag, unsigned target, long long timeout_ns) {
  if (threadIdx.x == 0) spin_until(flag, target, timeout_ns);
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

// bootstrap share of a rows-of-D payload: rank r's (B, S, H, D) tensor,
// read through its (rank, batch, token, head) strides st (elements, 16-byte
// rows), into dst laid out (B * H, S, D), by threads tid = 0 .. nth - 1
template <typename T, int D = 64>
__device__ void copy_rows_share(T* dst, const T* src, const long long (&st)[4], int r, int B,
                                int H, int S, int G, int c, int tid, int nth) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = D / kVec;          // 16-byte chunks per row
  static_assert(D % kVec == 0, "16-byte rows");
  long long lo, hi;
  share((long long)B * H * S * kChunks, G, c, lo, hi);
  for (long long i = lo + tid; i < hi; i += nth) {
    const long long row = i / kChunks;  // (b * H + h) * S + token
    const int off = (int)(i % kChunks) * kVec;
    const int tok = (int)(row % S);
    const int bh = (int)(row / S);
    const int b = bh / H, h = bh % H;
    const long long so = r * st[0] + b * st[1] + tok * st[2] + h * st[3] + off;
    __stcg(reinterpret_cast<int4*>(dst + row * D + off),
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
// `dst`, through L2, by threads tid = 0 .. nth - 1
static __device__ void hop_share(const Ring& g, int r, int right, int src, int dst, int c,
                                 int tid, int nth) {
  for (int pi = 0; pi < g.npay; ++pi) {
    const long long n = g.bytes[pi] / 16;
    long long lo, hi;
    share(n, g.G, c, lo, hi);
    const int4* s = reinterpret_cast<const int4*>(g.slots[pi][r]) + src * n;
    int4* d = reinterpret_cast<int4*>(g.slots[pi][right]) + dst * n;
    long long i = lo + tid;
    const int step = nth;
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
      hop_share(g, r, right, t, j & 1, c, threadIdx.x, blockDim.x);
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

// The bf16 forward's schedule (csrc/ring_attention.cu): run_ring's, split
// over a warp-specialised CTA's roles, and with no bootstrap.  Epoch 0
// reads the rank's own K and V where they lie and hop 1 sends them to the
// right neighbour's slot 1 from there, so nothing is copied before the
// first tile and slot 0 is first filled by hop 2.  Epoch s >= 1 then reads
// slot s % 2 at its fill (s + 1) / 2; hop j >= 3 overwrites a slot the
// right neighbour read in epoch j - 2 and waits for its (j - 1) / 2-th
// token of that slot (hop 2 fills a slot nothing has read yet).
//   * the thread that issues the TMA loads calls epoch_acquire(s) before
//     it loads epoch s >= 1's tiles from slot s % 2 (then fence.proxy.async);
//   * run_hops, on nth threads of their own (tid 0 .. nth - 1, named
//     barrier bar), moves every hop (hop 1: first_hop(right, tid, nth),
//     the rank's own payloads into right's slot 1) and sends the capacity
//     tokens; consumed(s) returns once the CTA's consumers have waited for
//     every tile they read from slot s % 2 in epoch s;
// so the consumers never wait on the protocol, only on their tiles.
static __device__ __forceinline__ unsigned fwd_fill(int s) { return (unsigned)(s + 1) / 2; }

static __device__ void epoch_acquire(const Ring& g, int r, int s) {
  spin_until(g.flags[r] + kArrive + (s & 1), fwd_fill(s) * g.G, g.timeout_ns);
}

template <class FirstHop, class Consumed>
__device__ void run_hops(const Ring& g, int r, int c, int tid, int nth, int bar,
                         FirstHop&& first_hop, Consumed&& consumed) {
  const int right = (r + 1) % g.R, left = (r + g.R - 1) % g.R;
  unsigned* flags = g.flags[r];
  for (int s = 0; s + 1 < g.E; ++s) {
    const int t = s & 1, j = s + 1;  // hop j: my slot t (hop 1: my own) -> right's slot j % 2
    if (tid == 0) {
      if (s >= 1) spin_until(flags + kArrive + t, fwd_fill(s) * g.G, g.timeout_ns);
      if (j >= 3) spin_until(flags + kCap + (j & 1), (unsigned)(j - 1) / 2, g.timeout_ns);
    }
    bar_sync(bar, nth);
    if (j == 1)
      first_hop(right, tid, nth);
    else
      hop_share(g, r, right, t, j & 1, c, tid, nth);
    __threadfence();
    bar_sync(bar, nth);
    if (tid == 0) red_release_add(g.flags[right] + kArrive + (j & 1), 1u);
    if (s >= 1 && s + 2 < g.E && tid == 0) {  // hop s + 2 refills slot t
      consumed(s);
      __threadfence();
      if (atom_acq_rel_add(flags + kDone + t, 1u) == fwd_fill(s) * g.G - 1)
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

// The bf16 rings read through rank-4 TMA maps (head dim D, 64 or 80), in
// boxes of `rows` rows of columns 0 .. 63 (128-byte swizzled), and at D =
// 80 a second map of each tensor in boxes of its columns 64 .. 79 (`tail`:
// 16 columns, 32-byte swizzled; attention_fwd_tile.cuh's note):
//   * own_map: rank-stacked rows (R, B, S, H, D) through their (rank,
//     batch, token, head) strides st, as (D, S, H, R * B), rank and batch
//     merged (R == 1, B == 1, or st[0] == B st[1]; anything else is
//     refused, and the wrapper copies such a tensor first);
//   * slot_map: a payload's slots, one allocation of R x 2 slots (B * H, S,
//     D), which the pointer table must describe, as (D, S, B * H, 2 R).
static inline cudaError_t tmap4(CUtensorMap* m, const void* base, const long long (&dims)[4],
                                const long long (&strides)[3], int rows, bool tail) {
  return tail ? fast3r_hopper::make_tmap_sw32(m, base, 4, dims, strides, rows)
              : fast3r_hopper::make_tmap(m, base, 4, dims, strides, rows);
}
static inline cudaError_t own_map(CUtensorMap* m, const void* base, const long long (&st)[4],
                                  int R, int B, int S, int H, int rows, int D = 64,
                                  bool tail = false) {
  long long sb;
  if (R == 1 || st[0] == (long long)B * st[1])
    sb = st[1];
  else if (B == 1)
    sb = st[0];
  else
    return cudaErrorInvalidValue;
  const long long dims[4] = {D, S, H, (long long)R * B};
  const long long strides[3] = {st[2], st[3], sb};
  return tmap4(m, base, dims, strides, rows, tail);
}
static inline cudaError_t slot_map(CUtensorMap* m, const void* table, int R, int BH, int S,
                                   int rows, int D = 64, bool tail = false) {
  const char* const* t = static_cast<const char* const*>(table);
  const long long slot = (long long)BH * S * D;  // elements
  for (int i = 1; i < R; ++i)
    if (t[i] != t[0] + i * 2 * slot * 2) return cudaErrorInvalidValue;
  const long long dims[4] = {D, S, BH, 2LL * R};
  const long long strides[3] = {D, (long long)S * D, slot};
  return tmap4(m, t[0], dims, strides, rows, tail);
}

// how many CTAs of `kernel` (threads, dynamic smem bytes) each SM holds, and
// the SM count; cudaErrorNotSupported without cooperative launch.  Asked of
// the CUDA runtime once per kernel, launch shape and device (a launch's
// host time otherwise pays for the attribute and the occupancy query every
// call).
template <typename K>
cudaError_t resident_ctas(K kernel, int threads, int smem, int* per_sm, int* sms) {
  struct Known {
    const void* kernel;
    int dev, threads, smem, per_sm, sms;
  };
  static Known known[16];
  static int n_known = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == fn && known[i].dev == dev && known[i].threads == threads &&
        known[i].smem == smem) {
      *per_sm = known[i].per_sm;
      *sms = known[i].sms;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && n_known < 16) known[n_known++] = {fn, dev, threads, smem, *per_sm, *sms};
  return err;
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
