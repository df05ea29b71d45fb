// The whole pre-LN MLP sublayer in one launch:
//   y = x + GELU(LN(x) W1^T + b1) W2^T + b2
// bf16 in and out, fp32 accumulation, W1 (hidden, C) and W2 (C, hidden) in
// the nn.Linear layout, C a template argument: 1024 (the flagship), 768
// and 1280 (the model_scaling decoders; 3 and 5 fc2 tiles a band, hidden
// 3072 and 5120).
//
// Replaces the TPU kernel fast3r_tpu/nn/fused_block.py _ln_mlp_kernel
// (through ln_mlp -> _ln_mlp_call).  That kernel exists to keep the
// (M, hidden) GELU activation out of device memory (252 MB a layer at
// M = 15360, 6.3 GB at the 1000-view shape).  Here h is rounded to bf16 (the
// TPU kernel's rounding point) and passes through a fixed ring of S band
// slots of 128 x hidden bf16 in device memory (1 MB each at hidden 4096,
// 1.25 MB at 5120; S = 16 by default, 16-20 MB, so the ring stays in the
// 50 MB L2; shared memory holds only the tile's stages, whatever the
// width), never through an (M, hidden) tensor;
// the residual is added in fp32 and rounded once.
//
// What bounds it on an H100: 4 M C hidden FLOPs (0.261 ms at M = 15360 and
// the published 989 TFLOP/s) against ~330 MB even if h went through device
// memory (0.099 ms), so the tensor cores.  A block cannot hold a 64 x 1024
// fp32 fc2 accumulator (the whole register file), so the two products are
// separate tiles of one persistent launch on the fused-GEMM tile
// (csrc/gemm_tile.cuh: TMA ring, wgmma m64n256k16, a producer and two
// consumer warpgroups, epilogues by TMA store):
//   * statistics items: a band's 128 rows' LN mean and rstd, into a scratch
//     buffer, once per band;
//   * fc1 tiles: 128 rows x a 256-wide hidden slice over K = C, the LN
//     prologue (the band's statistics read back) and the bias + GELU
//     epilogue, bf16 h into the band's ring slot (band b uses slot b % S);
//   * fc2 tiles (C / 256 a band): 128 rows x 256 output columns over
//     K = hidden, A = the
//     band's h slot by TMA, the bias + residual epilogue;
//   * items are claimed from an atomic counter in dependency order: the
//     statistics of band 0, then for each band b the statistics of band
//     b + 1, band b's fc1 tiles and band b - 1's fc2 tiles (a one-band
//     lookahead each way).  An fc1 tile's consumers wait (acquire load) for
//     its band's statistics; the producer, before loading an fc2 tile, until
//     its band's fc1 tiles are counted done; an fc1 tile's consumers, before
//     storing h, until the slot's previous band (b - S) has had all its fc2
//     tiles done.  Completion is a release add after the item's writes have
//     landed (statistics, fc1: the TMA stores waited for) or its reads
//     (fc2).  Every wait is on an item claimed earlier by a running CTA, and
//     a CTA finishes an item without waiting on its later claims, so the
//     walk cannot deadlock at any grid size (S >= 2);
//   * the claimed item goes from the producer to the consumers through a
//     two-deep ring of shared-memory slots with mbarriers, so the producer
//     loads the next item while the consumers run an epilogue.
// The counters are freshly zeroed per launch (the wrapper), so no waiter
// can mistake one band's count for another's.  With `prof` given, consumer
// thread 0 of every CTA adds its clock64 cycles in fc1 items, fc2 items,
// waits for a free slot, waits for the next item and statistics items into
// prof[0..3] and prof[5], and the producer its waits for fc1 bands into
// prof[4].
// What it did about the mma.sync kernel's limits: the thin 32-wide fc1
// chunks, three block barriers a chunk and single-buffered weight slices
// are gone (full-rate wgmma tiles fed by a TMA ring), and each weight slice
// is read once per tile instead of once per 32-row block.  Measured at the
// flagship's shape (M = 15360, hidden 4096; chip_smoke.py phase 2 and
// python -m fast3r_torch.profile_request; NVIDIA H100 80GB HBM3, 700 W):
// 0.82-0.86 ms a call, 298-313 TFLOP/s, 32% of its bound (the mma.sync
// kernel: 2.830 ms with its host time); fc1 items 63% of the consumers'
// item time, fc2 items 35%, statistics items 1.7%, waits for a slot or an
// item under 1%; as fast with a 120 MB ring past the L2 as with 16 slots,
// so h's traffic is not its limit; and slower than its own two-kernel road
// (ln_matmul GELU, then matmul_residual), since both are bound by the
// products and their epilogues and the walk adds its waits.
// Constraints (the wrapper checks them): C in {768, 1024, 1280},
// hidden % 32 == 0; M may be ragged.
// Not yet: an epilogue that overlaps the next tile's products (the GELU of
// fc1 tiles leaves the tensor cores idle), 2-CTA clusters with TMA
// multicast of W1 / W2 slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "ptx.cuh"

namespace {

using namespace fast3r_gemm;
using fast3r_ptx::gelu_erf;

struct MlpArgs {
  const bf16* x;       // (M, C)
  const float* gamma;  // (C,)
  const float* beta;   // (C,)
  const float* b1;     // (hidden,)
  const float* b2;     // (C,)
  bf16* out;           // (M, C)
  bf16* ring;          // (slots * 128, hidden) h band slots
  float* stats;        // (2, nb * 128) the rows' mean, then rstd
  // 1 + 3 nb zeroed counters: claims, then per band statistics done, fc1
  // tiles done, fc2 tiles done
  int* cnt;
  long long* prof;     // optional clock64 tallies, 6 words
  int M, hidden, slots;
  int residual;        // 0: no x in the fc2 epilogue (a tensor-parallel
                       // rank's partial output)
  float eps;
};

enum Kind { kSkip, kStats, kFc1, kFc2 };

struct Item {
  Kind kind;
  int band, tile;
};

// claim order: stats(0), then for g = 0 .. nb the group stats(g + 1),
// fc1(g, 0 .. nf1 - 1), fc2(g - 1, 0 .. nf2 - 1) (members past the bands
// are skipped): a band's statistics one group ahead of its fc1 tiles, its
// fc2 tiles one group behind
__device__ __forceinline__ Item decode(int i, int nb, int nf1, int nf2) {
  if (i == 0) return {kStats, 0, 0};
  const int per = 1 + nf1 + nf2, g = (i - 1) / per, r = (i - 1) % per;
  if (r == 0) return {g + 1 < nb ? kStats : kSkip, g + 1, 0};
  if (r <= nf1) return {g < nb ? kFc1 : kSkip, g, r - 1};
  return {g >= 1 ? kFc2 : kSkip, g - 1, r - 1 - nf1};
}

// the tensor maps of a launch: x (fc1's A), W1, the ring (fc2's A), W2, and
// for the epilogues' 64-row boxes the ring (h stores), x (the residual) and
// the output
struct Maps {
  CUtensorMap x, w1, h, w2, h_out, x_res, out;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const __grid_constant__ Maps mp, const MlpArgs a) {
  Smem& s = smem();
  if (threadIdx.x == 0) init_barriers(s);
  load_norm_params<kLN>(s, a.gamma, a.beta, C);
  __syncthreads();

  constexpr int nf2 = C / kBN;  // fc2 tiles of a band
  constexpr int KT1 = C / kBK;
  const int M = a.M, hidden = a.hidden, S = a.slots;
  const int nb = (M + kBM - 1) / kBM, nf1 = (hidden + kBN - 1) / kBN;
  const int claims = 1 + (nb + 1) * (1 + nf1 + nf2);
  const int KT2 = (hidden + kBK - 1) / kBK;
  int* stats_done = a.cnt + 1;
  int* fc1_done = a.cnt + 1 + nb;
  int* fc2_done = a.cnt + 1 + 2 * nb;
  float* mean_g = a.stats;
  float* rstd_g = a.stats + (long long)nb * kBM;

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring<kStages> ring;
      Ring<2> items;
      long long t_dep = 0;
      for (;;) {
        const int i = claim(a.cnt);
        const Item it = decode(i, nb, nf1, nf2);
        if (i < claims && it.kind == kSkip) continue;
        mbar_wait(&s.item_empty[items.stage], items.phase ^ 1u);
        s.item[items.stage] = i < claims ? i : -1;
        mbar_arrive(&s.item_full[items.stage]);
        items.advance();
        if (i >= claims) break;
        if (it.kind == kFc1) {
          load_tile(s, ring, &mp.x, &mp.w1, it.band * kBM, it.tile * kBN, KT1);
        } else if (it.kind == kFc2) {
          const long long t0 = clock64();
          spin_geq(fc1_done + it.band, nf1);
          t_dep += clock64() - t0;
          fence_proxy_async();  // h written by other CTAs, read by TMA
          load_tile(s, ring, &mp.h, &mp.w2, (it.band % S) * kBM,
                    it.tile * kBN, KT2);
        }
      }
      if (a.prof != nullptr)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.prof + 4),
                  (unsigned long long)t_dep);
    }
  } else {  // consumer warpgroups
    regs_inc<kConsumerRegs>();
    const Consumer th;
    const bool lead = threadIdx.x == 128;
    Ring<kStages> ring;
    Ring<2> items;
    unsigned res_phase = 0;
    const int r0 = th.warp * 16 + th.g();  // rows r0, r0 + 8 of the staging
    long long t_fc1 = 0, t_fc2 = 0, t_slot = 0, t_item = 0, t_stats = 0;
    float acc[kAcc];
    for (;;) {
      long long t0 = clock64();
      mbar_wait(&s.item_full[items.stage], items.phase);
      const int i = s.item[items.stage];
      __syncwarp();
      if (th.lane == 0) mbar_arrive(&s.item_empty[items.stage]);
      items.advance();
      const long long t1 = clock64();
      t_item += t1 - t0;
      if (i < 0) break;
      const Item it = decode(i, nb, nf1, nf2);
      const int m0 = it.band * kBM, n0 = it.tile * kBN;
      // the row this thread normalises (two lanes a row)
      const int row = m0 + th.row0() + (th.lane >> 1);
      if (it.kind == kStats) {  // the band's rows' statistics, published
        const RowStats st = row_stats<kLN, (C > kNarrowK)>(a.x, M, C, a.eps,
                                                            m0 + th.row0(),
                                           nullptr, nullptr);
        if ((th.lane & 1) == 0) {
          mean_g[row] = st.mu;
          rstd_g[row] = st.rs;
        }
        __threadfence();
        named_sync(1, kConsumerThreads);
        if (lead) red_release_add(stats_done + it.band, 1);
        t_stats += clock64() - t1;
      } else if (it.kind == kFc1) {
        if (lead) spin_geq(stats_done + it.band, 1);
        named_sync(1, kConsumerThreads);
        RowStats rstat;
        rstat.mu = __ldcg(mean_g + row);
        rstat.rs = __ldcg(rstd_g + row);
        mainloop<kLN>(acc, s, ring, KT1, th, rstat, nullptr, m0, M, C);
        if (it.band >= S) {  // the slot's previous band read by its fc2 tiles
          t0 = clock64();
          if (lead) spin_geq(fc2_done + it.band - S, nf2);
          named_sync(1, kConsumerThreads);
          t_slot += clock64() - t0;
        }
        // h = bf16(GELU(acc + b1)) into the slot (all 128 rows), box by box
        out_bias(s, th, a.b1, n0, hidden);
        const int hrow = (it.band % S) * kBM + th.wg * 64;
#pragma unroll
        for (int bx = 0; bx < kBN / 64; ++bx) {
          char* box = out_begin(s, th);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * bx + jj, cl = 8 * jj + 2 * th.c();
            const float2 b = tile_bias(s, th, 8 * j + 2 * th.c());
#pragma unroll
            for (int h = 0; h < 2; ++h)
              out_put(box, r0 + 8 * h, cl,
                      pack_bf16(gelu_erf(acc[4 * j + 2 * h] + b.x),
                                gelu_erf(acc[4 * j + 2 * h + 1] + b.y)));
          }
          out_store(th, box, &mp.h_out, n0 + 64 * bx, hrow, hidden);
        }
        if (th.leader) {  // written, then visible to the TMA loads of fc2
          bulk_wait<0>();
          fence_proxy_async();
        }
        named_sync(1, kConsumerThreads);
        if (lead) red_release_add(fc1_done + it.band, 1);
        t_fc1 += clock64() - t1;
      } else {
        mainloop<kNoNorm>(acc, s, ring, KT2, th, RowStats(), nullptr, m0, M,
                          hidden);
        named_sync(1, kConsumerThreads);  // the slot's tiles all landed
        if (lead) red_release_add(fc2_done + it.band, 1);
        // out = x + (acc + b2), rounded once; x's boxes through the staging
        // (without the residual: acc + b2)
        const int rw = m0 + th.wg * 64;
        out_bias(s, th, a.b2, n0, C);
#pragma unroll
        for (int bx = 0; bx < kBN / 64; ++bx) {
          char* box = out_begin(s, th);
          if (a.residual)
            out_load(s, th, box, &mp.x_res, n0 + 64 * bx, rw, res_phase);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * bx + jj, cl = 8 * jj + 2 * th.c();
            const float2 b = tile_bias(s, th, 8 * j + 2 * th.c());
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 x = a.residual ? out_get(box, r0 + 8 * h, cl)
                                          : make_float2(0.f, 0.f);
              out_put(box, r0 + 8 * h, cl,
                      pack_bf16(x.x + (acc[4 * j + 2 * h] + b.x),
                                x.y + (acc[4 * j + 2 * h + 1] + b.y)));
            }
          }
          out_store(th, box, &mp.out, n0 + 64 * bx, rw, C);
        }
        t_fc2 += clock64() - t1;
      }
    }
    if (th.leader) bulk_wait<0>();  // the last stores written
    if (lead && a.prof != nullptr) {
      unsigned long long* p = reinterpret_cast<unsigned long long*>(a.prof);
      atomicAdd(p + 0, (unsigned long long)t_fc1);
      atomicAdd(p + 1, (unsigned long long)t_fc2);
      atomicAdd(p + 2, (unsigned long long)t_slot);
      atomicAdd(p + 3, (unsigned long long)t_item);
      atomicAdd(p + 5, (unsigned long long)t_stats);
    }
  }
}

template <int C>
cudaError_t launch(const Maps& mp, const MlpArgs& a, int ctas, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_mlp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ln_mlp_kernel<C><<<ctas, kThreads, kSmemBytes, st>>>(mp, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, w1, w2, out bf16; gamma, beta, b1, b2 fp32; ring bf16 (slots * 128,
// hidden); stats fp32 (2, 128 ceil(M / 128)) scratch; cnt 1 + 3 ceil(M / 128)
// zeroed int32; prof null or 6 zeroed int64.  C is 768, 1024 or 1280 (an
// instantiation each); hidden % 32 == 0; slots >= 2 unless M <= 128;
// ctas >= 1 persistent CTAs; residual 0 leaves x out of the output (a
// tensor-parallel rank's partial: GELU(LN(x) W1^T + b1) W2^T + b2).
// Returns cudaGetLastError() after the launch.
int fast3r_ln_mlp(const void* x, const void* gamma, const void* beta,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, void* ring, void* stats,
                  void* cnt, void* prof,
                  int M, int C, int hidden, int slots, int ctas, int residual,
                  float eps, void* stream) {
  const int nb = (M + kBM - 1) / kBM;
  if (M <= 0 || hidden <= 0 || hidden % 32 || ctas < 1 || slots < 1 ||
      (slots < 2 && nb > 1))
    return cudaErrorInvalidValue;
  cudaError_t err;
  Maps mp;
  const long long ring_rows = (long long)slots * kBM;
  if ((err = make_tmap(&mp.x, x, M, C, C, kBM)) != cudaSuccess ||
      (err = make_tmap(&mp.w1, w1, hidden, C, C, kBN)) != cudaSuccess ||
      (err = make_tmap(&mp.h, ring, ring_rows, hidden, hidden, kBM)) !=
          cudaSuccess ||
      (err = make_tmap(&mp.w2, w2, C, hidden, hidden, kBN)) != cudaSuccess ||
      (err = make_tmap(&mp.h_out, ring, ring_rows, hidden, hidden, 64)) !=
          cudaSuccess ||
      (err = make_tmap(&mp.x_res, x, M, C, C, 64)) != cudaSuccess ||
      (err = make_tmap(&mp.out, out, M, C, C, 64)) != cudaSuccess)
    return err;
  MlpArgs a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<bf16*>(out);
  a.ring = static_cast<bf16*>(ring);
  a.stats = static_cast<float*>(stats);
  a.cnt = static_cast<int*>(cnt);
  a.prof = static_cast<long long*>(prof);
  a.M = M;
  a.hidden = hidden;
  a.slots = slots;
  a.residual = residual;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {  // the models' widths, each its own instantiation
    case 768: return launch<768>(mp, a, ctas, st);
    case 1024: return launch<1024>(mp, a, ctas, st);
    case 1280: return launch<1280>(mp, a, ctas, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
