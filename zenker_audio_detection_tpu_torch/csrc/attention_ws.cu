// A warp-specialised flash-attention walk for Hopper: the bf16 mha_packed,
// mha_packed_lse, mha, mha_pairs and mha_qblock of the port's
// ops/attention.py.
//
// Replaces, in bf16, four Pallas kernels of
// zenker_audio_detection_tpu/ops/attention.py and the forward of its custom
// VJP mha_packed_trainable:
//   mha_packed     <- _attn_kernel_packed (:295, call :330; grid (B, q
//                     blocks) on packed (B, S, H = NH * D) projections,
//                     heads by lane slices): ws_kernel<D, false>
//   mha_packed_lse <- the custom VJP's forward: ws_kernel<D, true>, the same
//                     code, and each row's log-sum-exp for the backward in
//                     attention_bwd.cu after the output; its output is
//                     mha_packed's bit for bit.
//   mha            <- _attn_kernel (:59, call :98; grid (B * NH) on
//                     (B, S, NH, D)): ws_kernel<D, false>
//   mha_pairs      <- _attn_kernel_pairs (:349, call :403; two heads per
//                     program on packed tensors, even NH): ws_kernel<D, false>
//   mha_qblock     <- _attn_kernel_qblock (:165, call :202; grid (B * NH,
//                     q blocks of block_q rows) on (B, S, NH, D)):
//                     ws_kernel<D, false>
// All five compute one function on one memory: a contiguous (B, S, NH, D)
// tensor is packed (B, S, NH * D). So mha, mha_pairs and mha_qblock launch
// mha_packed's instance as it is, and their outputs are its outputs bit for
// bit. The TPU decompositions are not carried over. mha's one program per
// (batch, head) holds a head's whole S in VMEM; here the walk's items are
// (batch, head, 64 * kConsumers rows) and share K/V tiles through the ring
// and L2. mha_qblock's grid of block_q-row query blocks keeps the score tile
// small in VMEM and reuses a head's K/V across its q blocks; the walk
// already streams kKeys-key K/V tiles by TMA under 64 * kConsumers-row
// items, and a row's result does not depend on how rows are grouped, so a
// grid of block_q-row blocks would be one more launch shape for the same
// function.
// mha_pairs packs two heads block-diagonally into a (2S, 128) K/V to fill
// the 128-wide MXU; on Hopper the two heads' products cannot share a wgmma
// (p differs per head) and the block-diagonal form doubles the products.
// A head-pair item on this walk loses as well: with one 64-row consumer per
// head the ring stages two heads' tiles for 64 rows each, three times the
// fill per row of a 192-row single-head item; with two consumers per head
// the CTA is 640 threads, a pool of 96 registers a thread, and after the
// producer's 24 a consumer gets 112, which the D = 64 state (s 32, acc 32,
// p 16, q 16, the next item's q 16) fills before any temporary, so it
// spills.
// Their f32 forms run attention_pipelined.cu's walk and FMA tile.
// Contract: reference_mha's (ops/attention.py), as attention_pipelined.cu:
// scores and softmax in f32 in the log2 domain, the unnormalised p rounded
// to bf16 for the PV product, one division by the row sum at the end.
//
// What bounds it on an H100 SXM. At the AST shape (B, S, NH, D) =
// (128, 1214, 12, 64): 579.5 GFLOP of products, 0.59 ms at 989 TFLOP/s, and
// 2.26 G exponentials, about as long at the SFU rate; 955 MB of q, k, v and
// output, 0.29 ms at 3.35 TB/s. Bound by operations, of two units that can
// run at once: the design keeps the tensor cores busy while the softmax
// runs. attention_pipelined.cu's walk (2 CTAs of two warpgroups per SM,
// every thread staging with cp.async, each warpgroup's products and softmax
// in series) ran at 4x the bound; this one:
//   * one persistent CTA per SM walks the (batch element, head, kRows-row
//     block) items as attention_pipelined.cu does (i = blockIdx.x + j *
//     gridDim.x, batch-major), with kConsumers warpgroups of 64 query rows
//     each and a producer warpgroup;
//   * the producer's one thread keeps kStages K/V tiles of kKeys keys in
//     flight with TMA (cp.async.bulk.tensor on a 3-D tensor map over
//     (B, S, H), so keys past S of one batch element are zero-filled rather
//     than the next element's), a full and an empty mbarrier per stage; the
//     tiles land in the swizzle the wgmma descriptors read (hopper.cuh);
//   * setmaxnreg leaves the producer 24 registers and gives each consumer
//     thread the rest of the CTA's pool (kConsumerRegs, at most 240): room
//     to overlap within a warpgroup. Tile j's S product is
//     issued with tile j - 1's PV product, tile j's softmax runs while the
//     PV product is in flight, and p is rounded to bf16 once it is done;
//   * the softmax does the arithmetic of attention_pipelined.cu's item in
//     its order, over key tiles of the same 64 keys, so each p is rounded to
//     bf16 as there: the training route's losses after an Adam update turn
//     on those roundings (tools/train_route_noise.py). Only the exponent
//     differs, as ex2.approx.ftz (no handling of results below 2^-126,
//     which round to 0 in p's sums);
//   * a consumer loads the next item's Q fragments while it computes this
//     one.
// The tensor map encoder comes from cudaGetDriverEntryPoint, so the library
// needs nvcc alone (no -lcuda). tools/packed_ws.py builds this source with
// other tile shapes and softmax forms and times them side by side.

#include <cuda.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// The tile shape. ops/attention.py:ws_tile reads these three lines for the
// launch geometry, and tools/packed_ws.py rewrites them for its variants.
constexpr int kKeys = 64;       // keys of a K/V tile
constexpr int kConsumers = 3;   // warpgroups of 64 query rows
constexpr int kStages = 4;      // K/V tiles in the ring
constexpr int kThreadsWG = 128;
constexpr int kRows = 64 * kConsumers;  // query rows of an item
constexpr int kThreads = (kConsumers + 1) * kThreadsWG;
// The registers shared out: setmaxnreg moves them within the CTA's own
// pool, which is what the launch gave it (the launch bounds' cap, in
// multiples of 8, for every thread); a producer thread keeps 24 and the
// consumers take the rest, at most 240. Asking more than the pool holds
// never returns.
constexpr int kProducerRegs = 24;
constexpr int kPool = 65536 / kThreads / 8 * 8 * kThreads;
constexpr int kConsumerRegs =
    (kPool - kProducerRegs * kThreadsWG) / (kConsumers * kThreadsWG) / 8 * 8 >
            240
        ? 240
        : (kPool - kProducerRegs * kThreadsWG) / (kConsumers * kThreadsWG) /
              8 * 8;
static_assert(kKeys == 64 || kKeys == 128, "tiles of 64 or 128 keys");

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------- mbarrier and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box (D lanes, kKeys keys, 1 batch element) at (lane c0, key c1, element
// c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

template <int D>
struct Ring {
  static constexpr int kTile = kKeys * D * 2;  // one (keys, D) bf16 tile
  static constexpr int kStage = 2 * kTile;   // K then V
  // 1024 bytes to align the ring, then the stages, then the barriers
  static constexpr int kBytes = 1024 + kStages * kStage + 2 * kStages * 8;
};

// One consumer warpgroup's state for one item, as the m64nNk16 fragments
// of flash_common.cuh: s[4n + e] is row g (e < 2) or g + 8, key 8n + 2t +
// (e & 1); acc likewise over the D lanes.
template <int D>
struct Rows {
  using R = Ring<D>;
  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 x D Q slice
  float acc[D / 2], s[kKeys / 2];
  uint32_t pf[kKeys / 16][4];  // p of the tile whose PV product is next
  float m0, m1, l0, l1, c0, c1;

  // s = q k^T of the tile in ring stage `at`, issued and committed
  __device__ __forceinline__ void issue_s(uint32_t at) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<kKeys, 0>(s, qf[kk], smem_desc<D>(at + kk * 32), kk);
    wgmma_commit();
  }
  // acc += p v of the tile in ring stage `at`, issued and committed
  __device__ __forceinline__ void issue_pv(uint32_t at) {
    const uint32_t vs = at + R::kTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma<D, 1>(acc, pf[kk], smem_desc<D>(vs + kk * 16 * D * 2), 1);
    wgmma_commit();
  }
  // The online softmax of the scores of keys k0.. in place, in the order
  // of attention_pipelined.cu's item: the scores scaled into the log2
  // domain and masked, the new maxima, then s becomes exp2(s - m), l is
  // rescaled and takes the new terms pair by pair, and c0, c1 are the
  // factors that rescale the output so far.
  __device__ __forceinline__ void softmax(int k0, int S, int t,
                                          float scale_log2) {
    const bool whole = k0 + kKeys <= S;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = whole || k0 + n * 8 + 2 * t + e < S;
        s[4 * n + e] = ok ? s[4 * n + e] * scale_log2 : -INFINITY;
        s[4 * n + 2 + e] = ok ? s[4 * n + 2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    // key k0 is in every tile, so the maxima are finite
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    c0 = ex2(m0 - mx0);
    c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - m0);
      s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
      s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
      s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
      l0 += s[4 * n] + s[4 * n + 1];
      l1 += s[4 * n + 2] + s[4 * n + 3];
    }
  }
  // once the PV product in flight is done: the output so far rescaled to
  // the new maxima, and p of the last softmax rounded to bf16 for the next
  __device__ __forceinline__ void rescale_and_pack() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(s[4 * n], s[4 * n + 1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    }
  }
};

// The A fragments of this warp's 16 x D slice of the 64 query rows from q0
// (zeros past S); the head's lanes start at base, rows ld elements apart.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* __restrict__ q,
                                       size_t base, int S, int ld, int q0) {
  const int warp = (threadIdx.x % kThreadsWG) >> 5, lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool ok0 = r0 < S, ok1 = r1 < S;
    qf[kk][0] = ok0 ? ld32(q + base + (size_t)r0 * ld + c) : 0u;
    qf[kk][1] = ok1 ? ld32(q + base + (size_t)r1 * ld + c) : 0u;
    qf[kk][2] = ok0 ? ld32(q + base + (size_t)r0 * ld + c + 8) : 0u;
    qf[kk][3] = ok1 ? ld32(q + base + (size_t)r1 * ld + c + 8) : 0u;
  }
}

// One item for a consumer warpgroup: 64 query rows from q0 of the head
// whose lanes start at base (token 0 of the batch element plus the head's
// lane offset), rows ld elements apart; it consumes ring slots it .. it +
// tiles - 1, with qf its Q fragments (load_q's). The lse of row r goes to
// lse[lbase + r].
template <int D, bool kLse>
__device__ __forceinline__ void consume(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, size_t base, size_t lbase, int S, int ld,
    int q0, uint32_t ring, uint32_t full, uint32_t empty, int it, int tiles,
    float scale_log2, const uint32_t (&qf)[D / 16][4]) {
  using R = Ring<D>;
  const int warp = (threadIdx.x % kThreadsWG) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  if (q0 >= S) {  // no rows (in an item past S): keep the ring going
    for (int j = 0; j < tiles; ++j) {
      const int slot = (it + j) % kStages;
      mbar_wait(full + 8 * slot, ((it + j) / kStages) & 1);
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
    return;
  }

  Rows<D> x;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) x.qf[kk][e] = qf[kk][e];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) x.acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) x.s[i] = 0.f;
  x.m0 = x.m1 = -INFINITY;
  x.l0 = x.l1 = 0.f;

  // tile 0: its S product alone
  int slot = it % kStages;
  mbar_wait(full + 8 * slot, (it / kStages) & 1);
  fence_regs(x.s);
  wgmma_fence();
  x.issue_s(ring + slot * R::kStage);
  wgmma_wait<0>();
  fence_regs(x.s);
  x.softmax(0, S, t, scale_log2);
  x.rescale_and_pack();
  // tile j's S product issued with tile j - 1's PV product; tile j's
  // softmax runs while the PV product is in flight
  for (int j = 1; j < tiles; ++j) {
    const int prev = slot;
    slot = (it + j) % kStages;
    mbar_wait(full + 8 * slot, ((it + j) / kStages) & 1);
    fence_regs(x.s);
    fence_regs(x.acc);
    fence_regs(x.pf);
    wgmma_fence();
    x.issue_s(ring + slot * R::kStage);
    x.issue_pv(ring + prev * R::kStage);
    wgmma_wait<1>();  // the S product is done, the PV product may not be
    fence_regs(x.s);
    x.softmax(j * kKeys, S, t, scale_log2);
    wgmma_wait<0>();
    fence_regs(x.acc);
    fence_regs(x.pf);
    fence_regs(x.s);
    if (lane == 0) mbar_arrive(empty + 8 * prev);  // tile j - 1 is read
    x.rescale_and_pack();
  }
  fence_regs(x.acc);
  fence_regs(x.pf);
  wgmma_fence();
  x.issue_pv(ring + slot * R::kStage);
  wgmma_wait<0>();
  fence_regs(x.acc);
  if (lane == 0) mbar_arrive(empty + 8 * slot);

  const float sum0 = quad_sum(x.l0), sum1 = quad_sum(x.l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * ld + c) =
          pack_bf16(x.acc[4 * n] * inv0, x.acc[4 * n + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * ld + c) =
          pack_bf16(x.acc[4 * n + 2] * inv1, x.acc[4 * n + 3] * inv1);
  }
  if constexpr (kLse) {
    if (t == 0 && r0 < S) lse[lbase + r0] = x.m0 + log2f(sum0);
    if (t == 0 && r1 < S) lse[lbase + r1] = x.m1 + log2f(sum1);
  }
}

// The persistent walk over (b, h, kRows-row block) items, i = blockIdx.x +
// j * gridDim.x, one CTA per SM. Warpgroups 0 .. kConsumers - 1 consume,
// the last produces.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
ws_kernel(const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int B, int S, int NH, float scale_log2) {
  using R = Ring<D>;
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t ring =
      ((uint32_t)__cvta_generic_to_shared(dyn) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * R::kStage;
  const uint32_t empty = full + 8 * kStages;
  const int H = NH * D, nqb = (S + kRows - 1) / kRows;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int items = B * NH * nqb;
  const int wg = threadIdx.x / kThreadsWG;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * kThreadsWG) {
      int it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int b = i / (NH * nqb), h = i / nqb % NH;
        for (int j = 0; j < tiles; ++j, ++it) {
          const int slot = it % kStages;
          const uint32_t dst = ring + slot * R::kStage;
          mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * slot, R::kStage);
          tma_load(dst, &tk, full + 8 * slot, h * D, j * kKeys, b);
          tma_load(dst + R::kTile, &tv, full + 8 * slot, h * D, j * kKeys, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // item i's head lanes and this warpgroup's first query row
    auto base = [&](int i) {
      return (size_t)(i / (NH * nqb)) * S * H + (size_t)(i / nqb % NH) * D;
    };
    auto row = [&](int i) { return i % nqb * kRows + wg * 64; };
    uint32_t qn[D / 16][4];  // the next item's Q fragments
    if ((int)blockIdx.x < items)
      load_q<D>(qn, q, base(blockIdx.x), S, H, row(blockIdx.x));
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, it += tiles) {
      uint32_t qf[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = qn[kk][e];
      const int next = i + gridDim.x;
      if (next < items) load_q<D>(qn, q, base(next), S, H, row(next));
      consume<D, kLse>(q, o, lse, base(i), (size_t)(i / nqb) * S, S, H,
                       row(i), ring, full, empty, it, tiles, scale_log2, qf);
    }
  }
}

// ------------------------------------------------------------------ launch
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<Encode>(p);
  }
  return fn;
}

// (B, S, H) bf16 at ptr as a 3-D map, boxes of (D lanes, kKeys keys, 1)
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D) {
  Encode encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)S * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)kKeys, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The instance for D, with the threads and dynamic shared memory it needs;
// nullptr for a D it is not compiled for. These numbers are
// ops/attention.py:launch_geometry's.
template <bool kLse>
const void* instance(int D, int* threads, int* smem) {
  *threads = kThreads;
  if (D == 64) {
    *smem = Ring<64>::kBytes;
    return (const void*)ws_kernel<64, kLse>;
  }
  if (D == 32) {
    *smem = Ring<32>::kBytes;
    return (const void*)ws_kernel<32, kLse>;
  }
  return nullptr;
}

template <bool kLse>
const void* prepared(int D, int threads, int smem) {
  int need_threads = 0, need_smem = 0;
  const void* kern = instance<kLse>(D, &need_threads, &need_smem);
  if (kern == nullptr || threads != need_threads || smem < need_smem)
    return nullptr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return kern;
}

template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int NH, int D, int gx, int gy, int gz, int threads,
           int smem, void* stream) {
  const void* kern = prepared<kLse>(D, threads, smem);
  CUtensorMap tk, tv;
  if (kern == nullptr || gy != 1 || gz != 1 ||
      !tensor_map(&tk, k, B, S, NH * D, D) ||
      !tensor_map(&tv, v, B, S, NH * D, D))
    return (int)cudaErrorInvalidValue;
  float scale_log2 = kLog2e / sqrtf((float)D);
  void* args[] = {&tk, &tv, &q, &o, &lse, &B, &S, &NH, &scale_log2};
  cudaLaunchKernel(kern, dim3(gx), dim3(threads), args, smem,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <bool kLse>
int occupancy(int D, int threads, int smem) {
  const void* kern = prepared<kLse>(D, threads, smem);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// C entry points, as attention_pipelined.cu's: pointers are device pointers
// to contiguous (B, S, NH * D) bf16 tensors, 16-byte aligned (lse: a
// contiguous (B, NH, S) f32 buffer); (gx, 1, 1), threads and the dynamic
// shared memory in bytes are ops/attention.py's launch_geometry; `stream` is
// a cudaStream_t. Returns the cudaError_t of the launch (0 on success); an
// instance that does not exist, a launch other than it needs or a tensor
// map cuTensorMapEncodeTiled refuses is cudaErrorInvalidValue. The caller
// validates shapes. mha_packed, mha, mha_pairs and mha_qblock launch one
// instance on the same memory.
#define WS_ENTRY(name)                                                       \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      int B, int S, int NH, int D, int gx, int gy, int gz,  \
                      int threads, int smem, void* stream) {                 \
    return launch<false>(q, k, v, o, nullptr, B, S, NH, D, gx, gy, gz,      \
                         threads, smem, stream);                             \
  }

WS_ENTRY(mha_packed_bf16)
WS_ENTRY(mha_bf16)
WS_ENTRY(mha_pairs_bf16)
WS_ENTRY(mha_qblock_bf16)

extern "C" int mha_packed_lse_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int NH, int D, int gx, int gy,
                                   int gz, int threads, int smem,
                                   void* stream) {
  return launch<true>(q, k, v, o, lse, B, S, NH, D, gx, gy, gz, threads,
                      smem, stream);
}

// The CTAs of an instance that fit on one SM at (threads, smem), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them; a negative
// cudaError_t on failure.
#define WS_OCCUPANCY(name, kLse)                      \
  extern "C" int name(int D, int threads, int smem) { \
    return occupancy<kLse>(D, threads, smem);         \
  }

WS_OCCUPANCY(mha_packed_occupancy_bf16, false)
WS_OCCUPANCY(mha_packed_lse_occupancy_bf16, true)
WS_OCCUPANCY(mha_occupancy_bf16, false)
WS_OCCUPANCY(mha_pairs_occupancy_bf16, false)
WS_OCCUPANCY(mha_qblock_occupancy_bf16, false)
