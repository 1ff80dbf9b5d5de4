// The backward of mha_packed_trainable (ops/attention.py), in two kernels.
//
// Replaces the backward of the JAX custom VJP mha_packed_trainable,
// zenker_audio_detection_tpu/ops/attention.py:441-465 (_mha_packed_bwd, XLA
// there, not Pallas), and computes the same function with the same rounding
// points. Per head, with s = q k^T and scale = 1 / sqrt(D):
//   p    = softmax(s * scale) in f32, here exp2(s * scale_log2 - lse) from
//          the row log-sum-exp that the forward kept (mha_packed_lse:
//          attention_ws.cu, f32 attention_pipelined.cu), so p is
//          recomputed tile by tile and never stored;
//   dv   = bf16(p)^T g, f32 accumulate, cast to the input dtype;
//   dp   = g v^T in f32;
//   ds   = p (dp - delta), delta_i = sum_j p_ij dp_ij = sum_d g_id o_id,
//          taken from the forward's output o (the JAX code sums p dp; the
//          two agree up to o's rounding);
//   ds_b = (ds * scale) cast to the input dtype;
//   dq   = ds_b k and dk = ds_b^T q, f32 accumulate, cast.
// No (S, S) tensor is written to device memory.
//
// What bounds it on an H100 SXM. At the training shape (B, S, NH, D) =
// (16, 1214, 12, 64) bf16 the function's five products (s, dv, dp, dq, dk)
// are 10 B NH S^2 D = 181 GFLOP, 0.183 ms at 989 TFLOP/s; its bytes (q, k,
// v, o, g in, dq, dk, dv out) are ~0.24 GB, 0.07 ms at 3.35 TB/s. So it is
// bound by operations, and only wgmma reaches the tensor cores' rate. The
// two kernels compute s and dp each (7 products, 253 GFLOP): that keeps
// every (S, S) tile on chip and needs no atomics, so a backward gives the
// same bits on every run.
//
// The bf16 instances take the shape of attention_ws.cu's forward:
//   * a persistent walk: one CTA per SM (gridDim.x = min(items, SMs))
//     walks the (batch element, head, W::kRows-row block) items, i =
//     blockIdx.x + j * gridDim.x, batch-major. Persistent because a CTA
//     holds the SM alone (its registers fill the SM): with one CTA per
//     item, every item would start with an empty ring and end with idle
//     tensor cores, while here the producer fills the next item's stages
//     as the consumers finish this one;
//   * consumer warpgroups of 64 rows each (kDqConsumers of query rows in
//     bwd_dq, kDkdvConsumers of keys in bwd_dkdv) and a producer
//     warpgroup, whose first thread keeps kStages tiles in flight with TMA
//     (cp.async.bulk.tensor on hopper.cuh's 3-D tensor map over (B, S, H),
//     so rows past S of one batch element are zero-filled, not the next
//     element's), with a full and an empty mbarrier per stage; the tiles
//     land in the swizzle the wgmma descriptors read. In bwd_dkdv the
//     producer's first warp also stages each query tile's lse (+inf past
//     S) and delta (0 past S) into the stage, and its 32 lanes arrive on
//     the full barrier with the TMA;
//   * setmaxnreg leaves the producer 24 registers (40 in bwd_dkdv) and
//     gives the consumers the rest of the CTA's pool: 160 each of bwd_dq's
//     three, 232 each of bwd_dkdv's two, whose dK, dV, K, V, the scores
//     and p^T, ds^T fragments need about 200. dQ (or dK and dV) stay in
//     f32 registers for the whole walk of an item;
//   * every product is a wgmma with A from registers (hopper.cuh's
//     wgmma_n64 / wgmma_n32):
//       bwd_dq    s = q k^T, dp = g v^T   A: q, g (kept for the item)
//                                         B: the K, V tiles, K-major
//                 dq += ds_b k            A: ds_b from the s accumulator
//                                         B: the K tile, MN-major
//       bwd_dkdv  s^T = k q^T, dp^T = v g^T  A: k, v (kept for the item)
//                                         B: the Q, g tiles, K-major
//                 dv += bf16(p^T) g, dk += ds_b^T q
//                                         A: the accumulator fragments
//                                         B: the g, Q tiles, MN-major
//     and a consumer issues a tile's two score products, waits, computes
//     p and ds, then issues its one or two gradient products and waits:
//     the ring overlaps the loads, and the consumer warpgroups of a CTA
//     overlap one's exponentials with another's products. Issuing the
//     next tile's scores before this tile's ds (two sets of score
//     registers, which spill in bwd_dq) measured slower on an H100
//     (tools/bwd_times.py, PERF.md);
//   * 2^x is ex2.approx.ftz, exp2f's value wherever the result is a
//     normal float: exp2f's guarded path for subnormal results, under the
//     key mask of bwd_dq, took a third of that kernel's time.
// Kept from the mma.sync kernels they replace: 64-row tiles walked in
// ascending order, so each accumulator sums the same 16-row k-steps in the
// same order; delta summed from the same fragments, and ds written in the
// same expression. ds is computed in both kernels, independently: the two
// may differ in the last bit (the compiler's contraction need not be the
// same), which is far inside the tolerance.
//
// Ragged tails (1214 = 18 * 64 + 62): K, V, Q and g rows past S are
// TMA's zero fill; keys past S get p = 0 in bwd_dq and their dk, dv rows
// are not stored by bwd_dkdv; query rows past S are read as zero q, g and
// o and their lse as +inf, so p = 0 and they add nothing, whatever the
// buffers hold past S.
//
// The f32 instances use plain f32 FMAs, never TF32, two threads per row
// (query in bwd_dq, key in bwd_dkdv), each holding D / 2 lanes, with
// synchronous staging, in the manner of the f32 forward body; one block
// per (64-row tile, head, batch element). They need only be right.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;  // rows of a tile: queries, keys, or an f32 block
constexpr int kThreads = 128;  // an f32 block

// The bf16 walks' shapes. ops/attention.py:bwd_tile reads these three
// lines for the launch geometry.
constexpr int kDqConsumers = 3;    // warpgroups of 64 query rows (bwd_dq)
constexpr int kDkdvConsumers = 2;  // warpgroups of 64 keys (bwd_dkdv)
constexpr int kStages = 4;  // tiles (two 64 x D operands each) in the ring
constexpr int kThreadsWG = 128;

// A walk of kC consumer warpgroups and a producer warpgroup. setmaxnreg
// moves registers within the CTA's own pool, which is what the launch gave
// it (the launch bounds' cap, in multiples of 8, for every thread); the
// producer keeps kProducer and the consumers take the rest, at most 240.
// Asking more than the pool holds never returns.
template <int kC, int kProducer>
struct Walk {
  static constexpr int kConsumers = kC;
  static constexpr int kRows = 64 * kC;  // rows of an item
  static constexpr int kThreads = (kC + 1) * kThreadsWG;
  static constexpr int kProducerRegs = kProducer;
  static constexpr int kPool = 65536 / kThreads / 8 * 8 * kThreads;
  static constexpr int kFree =
      (kPool - kProducer * kThreadsWG) / (kC * kThreadsWG) / 8 * 8;
  static constexpr int kConsumerRegs = kFree > 240 ? 240 : kFree;
};
// bwd_dq's producer only issues TMA; bwd_dkdv's first producer warp also
// stages lse and delta
using DqWalk = Walk<kDqConsumers, 24>;
using DkdvWalk = Walk<kDkdvConsumers, 40>;

// 2^x, flushing results below 2^-126 to 0: exp2f's value wherever that is
// a normal float (the mma.sync kernels' exp2f), one MUFU instruction where
// exp2f adds a guarded path for subnormal results
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the f32 dot product of two pairs of bf16 values
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// A fragments of a warp's 16 rows (r0 = row g, r1 = row g + 8) of one head,
// straight from device memory; zeros past S.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const __nv_bfloat16* __restrict__ x,
                                       size_t base, int ld, int S, int r0,
                                       int r1, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = r0 < S ? ld32(x + base + (size_t)r0 * ld + c) : 0u;
    f[kk][1] = r1 < S ? ld32(x + base + (size_t)r1 * ld + c) : 0u;
    f[kk][2] = r0 < S ? ld32(x + base + (size_t)r0 * ld + c + 8) : 0u;
    f[kk][3] = r1 < S ? ld32(x + base + (size_t)r1 * ld + c + 8) : 0u;
  }
}

// Stores a warp's 16 x D f32 accumulator rows (the wgmma layout: acc[4n ..
// 4n + 3] the C fragment of lanes 8n .. 8n + 7) as bf16, rows < S only.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[D / 2],
                                          size_t base, int ld, int S, int r0,
                                          int r1, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * ld + c) =
          pack_bf16(acc[4 * n], acc[4 * n + 1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * ld + c) =
          pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// The C fragments of a 64 x 64 f32 tile (x[4n + e]) as the four k-step A
// fragments of a product over its 64 columns, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[kT / 16][4],
                                       const float (&x)[kT / 2]) {
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    a[n >> 1][(n & 1) * 2 + 0] = pack_bf16(x[4 * n], x[4 * n + 1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
  }
}

// The shared memory of a walk: 1024 bytes to align the ring, the stages
// (two (64, D) bf16 tiles each), bwd_dkdv's lse and delta of each stage's
// 64 queries, then the full and empty barriers.
template <int D, bool kWithStats>
struct Ring {
  static constexpr int kTile = kT * D * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStats = kWithStats ? 2 * kT * 4 : 0;
  static constexpr int kBytes =
      1024 + kStages * (kStage + kStats) + 2 * kStages * 8;
};

// Waits for and releases `tiles` ring slots from `it` without reading
// them: a consumer whose rows all lie past S keeps the ring going.
__device__ __forceinline__ void skip(uint32_t full, uint32_t empty, int it,
                                     int tiles) {
  for (int j = 0; j < tiles; ++j) {
    const int slot = (it + j) % kStages;
    mbar_wait(full + 8 * slot, ((it + j) / kStages) & 1);
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
  }
}

// ---------------------------------------------------------------- bwd_dq bf16
// One item for a consumer warpgroup: dq of the 64 query rows from q0 of the
// head whose lanes start at base, rows ld elements apart, and their delta
// (delta[lbase + r]); it consumes ring slots it .. it + tiles - 1, the K and
// V tiles of keys 0, 64, ...
template <int D>
__device__ __forceinline__ void dq_item(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, size_t base,
    size_t lbase, int S, int ld, int q0, uint32_t ring, uint32_t full,
    uint32_t empty, int it, int tiles, float scale, float scale_log2) {
  using R = Ring<D, false>;
  const int warp = (threadIdx.x % kThreadsWG) >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  if (q0 >= S) {
    skip(full, empty, it, tiles);
    return;
  }
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a<D>(qf, q, base, ld, S, r0, r1, t);
  load_a<D>(gf, g, base, ld, S, r0, r1, t);
  float dl0 = 0.f, dl1 = 0.f;  // delta of rows r0, r1
  {
    uint32_t of[D / 16][4];
    load_a<D>(of, o, base, ld, S, r0, r1, t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      dl0 += dot2(gf[kk][0], of[kk][0]) + dot2(gf[kk][2], of[kk][2]);
      dl1 += dot2(gf[kk][1], of[kk][1]) + dot2(gf[kk][3], of[kk][3]);
    }
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (t == 0 && r0 < S) delta[lbase + r0] = dl0;
  if (t == 0 && r1 < S) delta[lbase + r1] = dl1;
  const float ls0 = r0 < S ? lse[lbase + r0] : INFINITY;
  const float ls1 = r1 < S ? lse[lbase + r1] : INFINITY;

  float acc[D / 2], s[kT / 2], dp[kT / 2];
  uint32_t af[kT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int slot = (it + j) % kStages;
    const uint32_t ks = ring + slot * R::kStage, vs = ks + R::kTile;
    mbar_wait(full + 8 * slot, ((it + j) / kStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<kT, 0>(s, qf[kk], smem_desc<D>(ks + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<kT, 0>(dp, gf[kk], smem_desc<D>(vs + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // ds_b in place of s: key 8n + 2t + e of the tile, rows r0 and r1
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * kT + n * 8 + 2 * t + e < S;
        const float p0 = ok ? ex2(s[4 * n + e] * scale_log2 - ls0) : 0.f;
        const float p1 = ok ? ex2(s[4 * n + 2 + e] * scale_log2 - ls1) : 0.f;
        s[4 * n + e] = p0 * (dp[4 * n + e] - dl0) * scale;
        s[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dl1) * scale;
      }
    }
    c_to_a(af, s);
    fence_regs(acc);
    fence_regs(af);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      wgmma<D, 1>(acc, af[kk], smem_desc<D>(ks + kk * 16 * D * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(af);
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // K and V are read
  }
  store_acc<D>(dq, acc, base, ld, S, r0, r1, t);
}

template <int D>
__global__ void __launch_bounds__(DqWalk::kThreads, 1)
dq_ws_kernel(const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ o,
             const float* __restrict__ lse,
             const __nv_bfloat16* __restrict__ g,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
             int B, int S, int NH, float scale, float scale_log2) {
  using W = DqWalk;
  using R = Ring<D, false>;
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t ring =
      ((uint32_t)__cvta_generic_to_shared(dyn) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * R::kStage;
  const uint32_t empty = full + 8 * kStages;
  const int H = NH * D, nblk = (S + W::kRows - 1) / W::kRows;
  const int tiles = (S + kT - 1) / kT;
  const int items = B * NH * nblk;
  const int wg = threadIdx.x / kThreadsWG;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, W::kConsumers * 4);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == W::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(W::kProducerRegs));
    if (threadIdx.x == W::kConsumers * kThreadsWG) {
      int it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int b = i / (NH * nblk), h = i / nblk % NH;
        for (int j = 0; j < tiles; ++j, ++it) {
          const int slot = it % kStages;
          const uint32_t dst = ring + slot * R::kStage;
          mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * slot, R::kStage);
          tma_load(dst, &tk, full + 8 * slot, h * D, j * kT, b);
          tma_load(dst + R::kTile, &tv, full + 8 * slot, h * D, j * kT, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(W::kConsumerRegs));
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, it += tiles) {
      const int b = i / (NH * nblk), h = i / nblk % NH;
      dq_item<D>(q, o, lse, g, dq, delta, (size_t)b * S * H + (size_t)h * D,
                 (size_t)(b * NH + h) * S, S, H, i % nblk * W::kRows + wg * 64,
                 ring, full, empty, it, tiles, scale, scale_log2);
    }
  }
}

// -------------------------------------------------------------- bwd_dkdv bf16
// One item for a consumer warpgroup: dk and dv of the 64 keys from k0 of
// the head whose lanes start at base; it consumes ring slots it .. it +
// tiles - 1, the Q and g tiles of queries 0, 64, ... with their lse and
// delta at stats + slot * 2 * kT (lse, then delta).
template <int D>
__device__ __forceinline__ void dkdv_item(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    size_t base, int S, int ld, int k0, uint32_t ring, const float* stats,
    uint32_t full, uint32_t empty, int it, int tiles, float scale,
    float scale_log2) {
  using R = Ring<D, true>;
  const int warp = (threadIdx.x % kThreadsWG) >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = k0 + warp * 16 + gr, r1 = r0 + 8;  // keys
  if (k0 >= S) {
    skip(full, empty, it, tiles);
    return;
  }
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, k, base, ld, S, r0, r1, t);
  load_a<D>(vf, v, base, ld, S, r0, r1, t);
  float dka[D / 2], dva[D / 2], st[kT / 2], dpt[kT / 2];
  uint32_t pf[kT / 16][4], dsf[kT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int slot = (it + j) % kStages;
    const uint32_t qs = ring + slot * R::kStage, gs = qs + R::kTile;
    const float* ls = stats + slot * 2 * kT;
    const float* dls = ls + kT;
    mbar_wait(full + 8 * slot, ((it + j) / kStages) & 1);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<kT, 0>(st, kf[kk], smem_desc<D>(qs + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<kT, 0>(dpt, vf[kk], smem_desc<D>(gs + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // columns are queries: query 8n + 2t + e of the tile; p^T in st, ds^T
    // (times scale) in dpt
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = n * 8 + 2 * t + e;
        const float l = ls[i], dl = dls[i];
        const float p0 = ex2(st[4 * n + e] * scale_log2 - l);
        const float p1 = ex2(st[4 * n + 2 + e] * scale_log2 - l);
        st[4 * n + e] = p0;
        st[4 * n + 2 + e] = p1;
        dpt[4 * n + e] = p0 * (dpt[4 * n + e] - dl) * scale;
        dpt[4 * n + 2 + e] = p1 * (dpt[4 * n + 2 + e] - dl) * scale;
      }
    }
    c_to_a(pf, st);
    c_to_a(dsf, dpt);
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      wgmma<D, 1>(dva, pf[kk], smem_desc<D>(gs + kk * 16 * D * 2), 1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      wgmma<D, 1>(dka, dsf[kk], smem_desc<D>(qs + kk * 16 * D * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pf);
    fence_regs(dsf);
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // Q, g and stats are read
  }
  store_acc<D>(dk, dka, base, ld, S, r0, r1, t);
  store_acc<D>(dv, dva, base, ld, S, r0, r1, t);
}

template <int D>
__global__ void __launch_bounds__(DkdvWalk::kThreads, 1)
dkdv_ws_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tg,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int B, int S, int NH,
               float scale, float scale_log2) {
  using W = DkdvWalk;
  using R = Ring<D, true>;
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(dyn);
  const uint32_t ring = (at + 1023u) & ~1023u;
  const uint32_t stats_at = ring + kStages * R::kStage;
  float* stats = reinterpret_cast<float*>(dyn + (stats_at - at));
  const uint32_t full = stats_at + kStages * R::kStats;
  const uint32_t empty = full + 8 * kStages;
  const int H = NH * D, nblk = (S + W::kRows - 1) / W::kRows;
  const int tiles = (S + kT - 1) / kT;
  const int items = B * NH * nblk;
  const int wg = threadIdx.x / kThreadsWG;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      // the producer's TMA arrival and each of its first warp's 32 lanes
      mbar_init(full + 8 * i, 1 + 32);
      mbar_init(empty + 8 * i, W::kConsumers * 4);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == W::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(W::kProducerRegs));
    if (threadIdx.x < W::kConsumers * kThreadsWG + 32) {  // the first warp
      const int lane = threadIdx.x & 31;
      int it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int b = i / (NH * nblk), h = i / nblk % NH;
        const size_t lbase = (size_t)(b * NH + h) * S;
        for (int j = 0; j < tiles; ++j, ++it) {
          const int slot = it % kStages;
          const uint32_t dst = ring + slot * R::kStage;
          mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full + 8 * slot, R::kStage);
            tma_load(dst, &tq, full + 8 * slot, h * D, j * kT, b);
            tma_load(dst + R::kTile, &tg, full + 8 * slot, h * D, j * kT, b);
          }
          float* ls = stats + slot * 2 * kT;
#pragma unroll
          for (int i2 = lane; i2 < kT; i2 += 32) {
            const int r = j * kT + i2;
            ls[i2] = r < S ? lse[lbase + r] : INFINITY;
            ls[kT + i2] = r < S ? delta[lbase + r] : 0.f;
          }
          mbar_arrive(full + 8 * slot);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(W::kConsumerRegs));
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, it += tiles) {
      const int b = i / (NH * nblk), h = i / nblk % NH;
      dkdv_item<D>(k, v, dk, dv, (size_t)b * S * H + (size_t)h * D, S, H,
                   i % nblk * W::kRows + wg * 64, ring, stats, full, empty, it,
                   tiles, scale, scale_log2);
    }
  }
}

// ------------------------------------------------------------------- f32
// Two threads per row: thread 2r + half holds lanes half * D/2 .. of row r
// of the block's 64; the partial dot products meet through one shuffle.

template <int D>
__device__ __forceinline__ void load_half(float (&x)[D / 2],
                                          const float* __restrict__ src,
                                          size_t at, bool ok) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) f = *reinterpret_cast<const float4*>(src + at + i);
    x[i] = f.x;
    x[i + 1] = f.y;
    x[i + 2] = f.z;
    x[i + 3] = f.w;
  }
}

template <int D>
__device__ __forceinline__ void store_half(float* __restrict__ dst,
                                           const float (&x)[D / 2],
                                           size_t at) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 4)
    *reinterpret_cast<float4*>(dst + at + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

// Stages rows r0..r0+63 of one head into a (64, D) f32 tile, zeros past S.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ x,
                                          size_t base, int S, int ld,
                                          int r0) {
  static_assert((kT * D / 4) % kThreads == 0, "staging must divide evenly");
#pragma unroll
  for (int i = 0; i < (kT * D / 4) / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i;
    const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      f = *reinterpret_cast<const float4*>(x + base + (size_t)(r0 + r) * ld +
                                           d4);
    *reinterpret_cast<float4*>(dst + r * D + d4) = f;
  }
}

// the full dot product of a row held by two threads
template <int D>
__device__ __forceinline__ float dot_half(const float (&x)[D / 2],
                                          const float* y) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) part = fmaf(x[i], y[i], part);
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ lse, const float* __restrict__ g,
              float* __restrict__ dq, float* __restrict__ delta, int S,
              int NH, float scale, float scale_log2) {
  __shared__ __align__(16) float ks[kT * D];
  __shared__ __align__(16) float vs[kT * D];
  const int H = NH * D;
  const size_t base = blockIdx.z * ((size_t)S * H) + (size_t)blockIdx.y * D;
  const size_t lbase = ((size_t)blockIdx.z * NH + blockIdx.y) * S;
  const int half = threadIdx.x & 1, lane0 = half * (D / 2);
  const int row = blockIdx.x * kT + (threadIdx.x >> 1);
  const bool live = row < S;
  const size_t at = base + (size_t)row * H + lane0;

  float qr[D / 2], gr[D / 2], acc[D / 2];
  load_half<D>(qr, q, at, live);
  load_half<D>(gr, g, at, live);
  load_half<D>(acc, o, at, live);  // o, for delta; then the dq accumulator
  const float dl = dot_half<D>(gr, acc);
  if (live && half == 0) delta[lbase + row] = dl;
  const float ls = live ? lse[lbase + row] : INFINITY;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kT) {
    __syncthreads();
    stage_f32<D>(ks, k, base, S, H, k0);
    stage_f32<D>(vs, v, base, S, H, k0);
    __syncthreads();
    const int n = min(kT, S - k0);
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * D + lane0;
      const float s = dot_half<D>(qr, kr);
      const float dp = dot_half<D>(gr, vs + j * D + lane0);
      const float p = exp2f(s * scale_log2 - ls);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (live) store_half<D>(dq, acc, at);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dkdv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int S, int NH, float scale,
                float scale_log2) {
  __shared__ __align__(16) float qs[kT * D];
  __shared__ __align__(16) float gs[kT * D];
  __shared__ float ls[kT], dls[kT];
  const int H = NH * D;
  const size_t base = blockIdx.z * ((size_t)S * H) + (size_t)blockIdx.y * D;
  const size_t lbase = ((size_t)blockIdx.z * NH + blockIdx.y) * S;
  const int half = threadIdx.x & 1, lane0 = half * (D / 2);
  const int key = blockIdx.x * kT + (threadIdx.x >> 1);
  const bool live = key < S;
  const size_t at = base + (size_t)key * H + lane0;

  float kr[D / 2], vr[D / 2], dka[D / 2], dva[D / 2];
  load_half<D>(kr, k, at, live);
  load_half<D>(vr, v, at, live);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kT) {
    __syncthreads();
    stage_f32<D>(qs, q, base, S, H, q0);
    stage_f32<D>(gs, g, base, S, H, q0);
    if (threadIdx.x < kT) {
      const int i = threadIdx.x;
      const bool ok = q0 + i < S;
      ls[i] = ok ? lse[lbase + q0 + i] : INFINITY;
      dls[i] = ok ? delta[lbase + q0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(kT, S - q0);
    for (int i = 0; i < n; ++i) {
      const float* qr = qs + i * D + lane0;
      const float* gr = gs + i * D + lane0;
      const float s = dot_half<D>(kr, qr);
      const float dpt = dot_half<D>(vr, gr);
      const float p = exp2f(s * scale_log2 - ls[i]);
      const float ds = p * (dpt - dls[i]) * scale;
#pragma unroll
      for (int c = 0; c < D / 2; ++c) {
        dva[c] = fmaf(p, gr[c], dva[c]);
        dka[c] = fmaf(ds, qr[c], dka[c]);
      }
    }
  }
  if (live) {
    store_half<D>(dk, dka, at);
    store_half<D>(dv, dva, at);
  }
}

// f32 scale factors of the JAX code: scale = 1 / sqrt(D) rounded once to
// f32, as JAX rounds the Python float; scale_log2 as the forward's.
inline float scale_of(int D) { return (float)(1.0 / sqrt((double)D)); }
inline float scale_log2_of(int D) { return kLog2e / sqrtf((float)D); }

// The bf16 instance of bwd_dq (kDkdv false) or bwd_dkdv for D, with the
// threads and dynamic shared memory it needs; nullptr for a D it is not
// compiled for. These numbers are ops/attention.py:launch_geometry's.
template <bool kDkdv>
const void* instance(int D, int* threads, int* smem) {
  *threads = kDkdv ? DkdvWalk::kThreads : DqWalk::kThreads;
  if (D == 64) {
    *smem = Ring<64, kDkdv>::kBytes;
    return kDkdv ? (const void*)dkdv_ws_kernel<64>
                 : (const void*)dq_ws_kernel<64>;
  }
  if (D == 32) {
    *smem = Ring<32, kDkdv>::kBytes;
    return kDkdv ? (const void*)dkdv_ws_kernel<32>
                 : (const void*)dq_ws_kernel<32>;
  }
  return nullptr;
}

template <bool kDkdv>
const void* prepared(int D, int threads, int smem) {
  int need_threads = 0, need_smem = 0;
  const void* kern = instance<kDkdv>(D, &need_threads, &need_smem);
  if (kern == nullptr || threads != need_threads || smem < need_smem)
    return nullptr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return kern;
}

// The bf16 walk: x0, x1 are the operands its TMA maps read (k, v for
// bwd_dq; q, g for bwd_dkdv), the other pointers its kernel's own.
template <bool kDkdv>
int launch_ws(const void* x0, const void* x1, void* args_tail[], int n_tail,
              int B, int S, int NH, int D, int gx, int gy, int gz,
              int threads, int smem, cudaStream_t st) {
  const void* kern = prepared<kDkdv>(D, threads, smem);
  CUtensorMap t0, t1;
  if (kern == nullptr || gy != 1 || gz != 1 ||
      !tensor_map(&t0, x0, B, S, NH * D, D, kT) ||
      !tensor_map(&t1, x1, B, S, NH * D, D, kT))
    return (int)cudaErrorInvalidValue;
  float sc = scale_of(D), sl = scale_log2_of(D);
  void* args[16] = {&t0, &t1};
  for (int i = 0; i < n_tail; ++i) args[2 + i] = args_tail[i];
  args[2 + n_tail] = &B;
  args[3 + n_tail] = &S;
  args[4 + n_tail] = &NH;
  args[5 + n_tail] = &sc;
  args[6 + n_tail] = &sl;
  cudaLaunchKernel(kern, dim3(gx), dim3(threads), args, smem, st);
  return (int)cudaGetLastError();
}

template <bool kDkdv>
int occupancy(int D, int threads, int smem) {
  const void* kern = prepared<kDkdv>(D, threads, smem);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* o, const void* lse, const void* g, void* dq,
                  void* delta, int B, int S, int NH, int D, dim3 grid,
                  int threads, int smem, cudaStream_t st) {
  if (threads != kThreads || smem != 0 || (int)grid.z != B)
    return (int)cudaErrorInvalidValue;
  const float sc = scale_of(D), sl = scale_log2_of(D);
#define DQ_ARGS                                                          \
  (const float*)q, (const float*)k, (const float*)v, (const float*)o,    \
      (const float*)lse, (const float*)g, (float*)dq, (float*)delta, S,  \
      NH, sc, sl
  if (D == 32) dq_kernel_f32<32><<<grid, threads, 0, st>>>(DQ_ARGS);
  else if (D == 64) dq_kernel_f32<64><<<grid, threads, 0, st>>>(DQ_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef DQ_ARGS
  return (int)cudaGetLastError();
}

int launch_dkdv_f32(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int NH, int D,
                    dim3 grid, int threads, int smem, cudaStream_t st) {
  if (threads != kThreads || smem != 0 || (int)grid.z != B)
    return (int)cudaErrorInvalidValue;
  const float sc = scale_of(D), sl = scale_log2_of(D);
#define DKDV_ARGS                                                        \
  (const float*)q, (const float*)k, (const float*)v, (const float*)g,    \
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S, \
      NH, sc, sl
  if (D == 32) dkdv_kernel_f32<32><<<grid, threads, 0, st>>>(DKDV_ARGS);
  else if (D == 64)
    dkdv_kernel_f32<64><<<grid, threads, 0, st>>>(DKDV_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef DKDV_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. Pointers are device pointers: q, k, v, o, g, dq, dk, dv
// contiguous (B, S, NH * D) tensors of the entry's dtype, 16-byte aligned;
// lse and delta contiguous (B, NH, S) f32. (gx, gy, gz), threads and the
// dynamic shared memory in bytes are ops/attention.py's launch_geometry:
// bf16 the persistent walk ((gx, 1, 1)), f32 one block per (tile, head,
// batch element) ((cdiv(S, 64), NH, B), 128 threads, 0 bytes); `stream` is
// a cudaStream_t. Returns the cudaError_t of the launch (0 on success); an
// instance that does not exist, a launch other than it needs or a tensor
// map cuTensorMapEncodeTiled refuses is cudaErrorInvalidValue. The caller
// validates shapes. bwd_dq writes delta, which bwd_dkdv reads: launch them
// in that order on one stream.
extern "C" int mha_packed_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* g,
                                      void* dq, void* delta, int B, int S,
                                      int NH, int D, int gx, int gy, int gz,
                                      int threads, int smem, void* stream) {
  void* tail[] = {&q, &o, &lse, &g, &dq, &delta};
  return launch_ws<false>(k, v, tail, 6, B, S, NH, D, gx, gy, gz, threads,
                          smem, (cudaStream_t)stream);
}

extern "C" int mha_packed_bwd_dkdv_bf16(const void* q, const void* k,
                                        const void* v, const void* g,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int S,
                                        int NH, int D, int gx, int gy,
                                        int gz, int threads, int smem,
                                        void* stream) {
  void* tail[] = {&k, &v, &lse, &delta, &dk, &dv};
  return launch_ws<true>(q, g, tail, 6, B, S, NH, D, gx, gy, gz, threads,
                         smem, (cudaStream_t)stream);
}

extern "C" int mha_packed_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* g,
                                     void* dq, void* delta, int B, int S,
                                     int NH, int D, int gx, int gy, int gz,
                                     int threads, int smem, void* stream) {
  return launch_dq_f32(q, k, v, o, lse, g, dq, delta, B, S, NH, D,
                       dim3(gx, gy, gz), threads, smem,
                       (cudaStream_t)stream);
}

extern "C" int mha_packed_bwd_dkdv_f32(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int NH, int D, int gx, int gy, int gz,
                                       int threads, int smem, void* stream) {
  return launch_dkdv_f32(q, k, v, g, lse, delta, dk, dv, B, S, NH, D,
                         dim3(gx, gy, gz), threads, smem,
                         (cudaStream_t)stream);
}

// The CTAs of a bf16 instance that fit on one SM at (threads, smem), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them; a negative
// cudaError_t on failure.
extern "C" int mha_packed_bwd_dq_occupancy_bf16(int D, int threads,
                                                int smem) {
  return occupancy<false>(D, threads, smem);
}

extern "C" int mha_packed_bwd_dkdv_occupancy_bf16(int D, int threads,
                                                  int smem) {
  return occupancy<true>(D, threads, smem);
}
