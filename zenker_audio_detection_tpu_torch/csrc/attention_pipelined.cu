// A flash-attention body built for Hopper, and the two (B, S, NH, D) entry
// points of the port's ops/attention.py that run it.
//
// Replaces two Pallas kernels of zenker_audio_detection_tpu/ops/attention.py:
//   mha_batched_heads <- _attn_kernel_batched (grid (B), a fori_loop over
//                        heads): all heads of one batch element per program,
//                        to amortise the per-step DMA latency of a single
//                        sequential core. Here: a persistent grid of
//                        sms x 2 CTAs walks the work items (batch element,
//                        head, 128-row query block), batch-major, then head,
//                        then query block, as i = blockIdx.x + j * gridDim.x,
//                        so the CTAs that run at one time work on the same
//                        batch element's K/V, which stays in the 50 MB L2.
//                        Two consumer warpgroups take the two 64-row halves
//                        of an item and share each staged K/V tile.
//   mha_fused         <- _attn_kernel_fused (grid (B, q blocks), all heads
//                        of one query block, one (BQ, NH, D) store, a Mosaic
//                        workaround). Here: grid (cdiv(S, 64), B); a CTA
//                        walks the head pairs of its 64 query rows, its two
//                        warpgroups take heads 2p and 2p + 1 on one staged
//                        64-key x 2D-lane tile, and each writes its head's
//                        rows from registers. No (rows, NH * D) tile is
//                        staged, so shared memory does not cap NH * D; an
//                        odd NH leaves the last pair one head.
// Contract: reference_mha's (ops/attention.py), as csrc/attention.cu.
//
// What bounds it on an H100 SXM. At the AST shape (B, S, NH, D) =
// (128, 1214, 12, 64) bf16: 4 * B * NH * S^2 * D = 579.5 GFLOP of products,
// 0.59 ms at 989 TFLOP/s; B * NH * S^2 = 2.26 G exponentials, about as long
// at the SFU rate; q, k, v and the output are 955 MB, 0.29 ms at 3.35 TB/s.
// So it is bound by operations, and the design keeps the tensor cores fed:
//   * products on wgmma m64nNk16 (bf16 in, f32 accumulate), one warpgroup per
//     64 query rows, Q and P as register A operands, K and V read from shared
//     memory through descriptors: S = Q K^T with K K-major, O += P V with V
//     row-major through the transpose flag (MN-major B), so no transposed V
//     copy is written;
//   * K/V tiles of 64 keys go through a ring of kStages stages in shared
//     memory, filled by cp.async (16 bytes a thread, zero-filled with a
//     source size of 0 past S, so the ragged 1214 = 18 * 64 + 62 needs no
//     masked loads), kStages - 1 tiles ahead of the one being computed;
//   * tiles are stored in the layout the descriptors read: 128-byte swizzle
//     at D = 64 (a key's 64 lanes are one 128-byte row), 64-byte swizzle at
//     D = 32, so the wgmma reads are free of bank conflicts;
//   * the online softmax is f32 in the log2 domain, as in attention.cu: the
//     unnormalised exp(s - m) is rounded to bf16 for the PV product and the
//     division by the row sum happens once, at the end;
//   * 256 threads and at most 128 registers a thread (the launch bounds), and
//     at most 97 KB of shared memory a CTA, so 2 CTAs (16 warps) share an SM:
//     while one waits on its products or its softmax the other issues.
//     mha_batched_heads_occupancy_* and mha_fused_occupancy_* report what the
//     card makes of it.
// The f32 instances keep attention.cu's FMA tile (never TF32) under the same
// decompositions: 8 warps of 128 rows a work item for mha_batched_heads, and
// for mha_fused 4 warps walking the heads of 64 rows one at a time.

#include "flash_common.cuh"

namespace {

constexpr int kStages = 3;  // K/V tiles in the ring
constexpr int kRowsWG = 64;  // query rows of a warpgroup (wgmma's M)
constexpr int kThreadsWG = 128;
constexpr int kWGs = 2;      // consumer warpgroups of a bf16 CTA
enum Fn { kBatched, kFused };

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// a fence or a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// cp.async writes to shared memory become visible to wgmma's reads (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride
// byte offset >> 4 in 32-45, swizzle mode in 62-63 (1: 128 B, 2: 64 B). A
// tile here is rows of kRow bytes (one swizzle atom wide), 8-row groups
// 8 * kRow bytes apart: that is the stride byte offset of both the K-major
// (K in S = Q K^T) and the MN-major (V in O += P V) reading; the leading
// byte offset is not used by either at these widths.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint32_t kRow = D * 2;
  constexpr uint64_t kMode = D == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * kRow) >> 4) << 32) | (kMode << 62);
}

// The byte offset of logical byte `off` of a tile of kRow-byte rows under
// the swizzle the descriptor names: the 16-byte chunk index XOR the row's
// index within the swizzle period. Tiles start 1024-byte aligned.
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t kMask = D == 64 ? 0x70 : 0x30;
  return off ^ ((off >> 3) & kMask);
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N f32, accumulator layout) = a (64 x 16 bf16, registers) * B
// (16 x N bf16 at desc) + (scale_d ? d : 0). Per warp w of the warpgroup,
// rows 16w..16w+15; a and d are laid out as the mma.m16n8k16 fragments
// (flash_common.cuh), d[4n..4n+3] the C fragment of columns 8n..8n+7. kTrans
// reads B MN-major (N contiguous).
template <int kTrans>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTrans),
        "r"(scale_d));
}

template <int kTrans>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTrans),
        "r"(scale_d));
}
#undef WG_D8

template <int N, int kTrans>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  if constexpr (N == 64)
    wgmma_n64<kTrans>(d, a, desc, scale_d);
  else
    wgmma_n32<kTrans>(d, a, desc, scale_d);
}

// ------------------------------------------------------------- bf16 body
// The ring: kStages stages of P heads' K tiles then their V tiles, each a
// (64 keys, D) row-major swizzled tile; 1024 bytes of slack to align it.
template <int D, int P>
struct Ring {
  static constexpr int kTile = kBK * D * 2;     // bytes of one head's tile
  static constexpr int kStage = 2 * P * kTile;  // K and V of P heads
  static constexpr int kBytes = kStages * kStage + 1024;
};

// Copies keys k0..k0+63 of nh <= P heads (lanes hd..hd + nh * D of each
// key row, hd = lane offset of the first head in base) into ring stage
// `at`, zeros past S. Every thread of the CTA takes part.
template <int D, int P>
__device__ __forceinline__ void stage_kv(uint32_t at,
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v,
                                         size_t base, int S, int ld, int k0,
                                         int nh) {
  using R = Ring<D, P>;
  constexpr int kRowChunks = D / 8;  // 16-byte chunks of one key's D lanes
  constexpr int kChunks = P * kBK * kRowChunks;
  constexpr int kThreads = kWGs * kThreadsWG;
  static_assert(kChunks % kThreads == 0, "staging must divide evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = threadIdx.x + kThreads * i;
    const int hp = c / (kBK * kRowChunks);
    const int r = (c / kRowChunks) % kBK, ch = c % kRowChunks;
    if (P == 1 || hp < nh) {
      const bool ok = k0 + r < S;
      const size_t src =
          base + (size_t)(ok ? k0 + r : 0) * ld + hp * D + ch * 8;
      const uint32_t dst = at + hp * R::kTile + swizzle<D>(r * D * 2 + ch * 16);
      cp_async16(dst, k + src, ok);
      cp_async16(dst + P * R::kTile, v + src, ok);
    }
  }
}

// One work item: warpgroup wg computes 64 query rows, from q0, of head
// hd / D + (P == 1 ? 0 : wg), where the P heads' lanes start at base (token
// 0 of the batch element) + hd; rows ld elements apart. nh heads are present
// (P == 2 with an odd NH: 1); a warpgroup without rows or head only helps
// stage. `ring` is the 1024-aligned shared address of the ring.
template <int D, int P>
__device__ __forceinline__ void item(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     __nv_bfloat16* __restrict__ o,
                                     size_t base, int S, int ld, int q0,
                                     int nh, uint32_t ring,
                                     float scale_log2) {
  using R = Ring<D, P>;
  const int wg = threadIdx.x / kThreadsWG;
  const int warp = (threadIdx.x % kThreadsWG) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hp = P == 1 ? 0 : wg;
  const bool live = hp < nh && q0 < S;  // uniform over the warpgroup
  const size_t hbase = base + hp * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 x D Q slice
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool ok0 = live && r0 < S, ok1 = live && r1 < S;
    qf[kk][0] = ok0 ? ld32(q + hbase + (size_t)r0 * ld + c) : 0u;
    qf[kk][1] = ok1 ? ld32(q + hbase + (size_t)r1 * ld + c) : 0u;
    qf[kk][2] = ok0 ? ld32(q + hbase + (size_t)r0 * ld + c + 8) : 0u;
    qf[kk][3] = ok1 ? ld32(q + hbase + (size_t)r1 * ld + c + 8) : 0u;
  }
  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  const int tiles = (S + kBK - 1) / kBK;
  __syncthreads();  // the previous item is done with every stage
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) stage_kv<D, P>(ring + j * R::kStage, k, v, base, S, ld,
                                  j * kBK, nh);
    cp_async_commit();
  }
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; everyone is done with tile j - 1
    {
      const int jn = j + kStages - 1;  // into the stage tile j - 1 used
      if (jn < tiles) stage_kv<D, P>(ring + (jn % kStages) * R::kStage, k, v,
                                     base, S, ld, jn * kBK, nh);
      cp_async_commit();
    }
    if (!live) continue;
    const uint32_t ks = ring + (j % kStages) * R::kStage + hp * R::kTile;
    const uint32_t vs = ks + P * R::kTile;

    // s = q k^T, 64 rows x 64 keys; K = D in D/16 steps of 32 bytes
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma<64, 0>(s, qf[kk], smem_desc<D>(ks + kk * 32), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4n + e]: row g (e < 2) or g + 8, key 8n + 2t + (e & 1)
    const int k0 = j * kBK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + n * 8 + 2 * t + e < S;
        s[4 * n + e] = ok ? s[4 * n + e] * scale_log2 : -INFINITY;
        s[4 * n + 2 + e] = ok ? s[4 * n + 2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    // key 0 is in the first tile, so the maxima are finite from here on
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }
    // p = exp(s - m); the C fragments of key n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk of the PV product
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[4 * n] - m0), p1 = exp2f(s[4 * n + 1] - m0);
      const float p2 = exp2f(s[4 * n + 2] - m1), p3 = exp2f(s[4 * n + 3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // acc += p v: K = 64 keys in 4 steps of 16 key rows, V MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<D, 1>(acc, pf[kk], smem_desc<D>(vs + kk * 16 * D * 2), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  if (!live) return;

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + hbase + (size_t)r0 * ld + c) =
          pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + hbase + (size_t)r1 * ld + c) =
          pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

__device__ __forceinline__ uint32_t aligned_ring(unsigned char* dyn) {
  return ((uint32_t)__cvta_generic_to_shared(dyn) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------- kernels
// mha_batched_heads, bf16: the persistent walk over (b, h, 128-row block).
template <int D>
__global__ void __launch_bounds__(kWGs * kThreadsWG, 2)
batched_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int B, int S, int NH,
               float scale_log2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t ring = aligned_ring(dyn);
  const int H = NH * D, nqb = (S + 2 * kRowsWG - 1) / (2 * kRowsWG);
  const int items = B * NH * nqb;
  const int wg = threadIdx.x / kThreadsWG;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int b = i / (NH * nqb), h = i / nqb % NH, qb = i % nqb;
    item<D, 1>(q, k, v, o, (size_t)b * S * H + (size_t)h * D, S, H,
               qb * 2 * kRowsWG + wg * kRowsWG, 1, ring, scale_log2);
  }
}

// mha_fused, bf16, grid (q blocks, B): every head pair of one 64-row block.
template <int D>
__global__ void __launch_bounds__(kWGs * kThreadsWG, 2)
fused_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int B, int S, int NH,
             float scale_log2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t ring = aligned_ring(dyn);
  const int H = NH * D;
  const size_t base = (size_t)blockIdx.y * S * H;
  for (int h0 = 0; h0 < NH; h0 += 2)
    item<D, 2>(q, k, v, o, base + (size_t)h0 * D, S, H, blockIdx.x * kRowsWG,
               min(2, NH - h0), ring, scale_log2);
}

// f32: attention.cu's FMA tile (flash_common.cuh) under the same walks.
template <int D>
__global__ void __launch_bounds__(256, 2)
batched_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int B,
                   int S, int NH, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  auto& sm = *reinterpret_cast<Tiles<float, D>*>(dyn);
  const int H = NH * D, nqb = (S + 127) / 128;
  const int items = B * NH * nqb;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int b = i / (NH * nqb), h = i / nqb % NH, qb = i % nqb;
    const size_t base = (size_t)b * S * H + (size_t)h * D;
    tile<D, 8>(q, k, v, base, S, H, qb * 128, scale_log2, sm, o, base, H);
  }
}

template <int D>
__global__ void __launch_bounds__(128, 4)
fused_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int B,
                 int S, int NH, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  auto& sm = *reinterpret_cast<Tiles<float, D>*>(dyn);
  const int H = NH * D;
  const size_t base = (size_t)blockIdx.y * S * H;
  for (int h = 0; h < NH; ++h)
    tile<D, 4>(q, k, v, base + (size_t)h * D, S, H, blockIdx.x * 64,
               scale_log2, sm, o, base + (size_t)h * D, H);
}

// ------------------------------------------------------------------ launch
template <typename T>
using Kern = void (*)(const T*, const T*, const T*, T*, int, int, int, float);

// The instance of (function, dtype, D), with the threads and the dynamic
// shared memory it needs; nullptr for a D it is not compiled for. These
// numbers are ops/attention.py:launch_geometry's.
template <typename T, int F>
Kern<T> instance(int D, int* threads, int* smem) {
  constexpr bool kBf16 = sizeof(T) == 2;
  *threads = kBf16 || F == kBatched ? kWGs * kThreadsWG : 128;
  if constexpr (kBf16) {
    constexpr int P = F == kFused ? 2 : 1;
    if (D == 32) {
      *smem = Ring<32, P>::kBytes;
      return F == kFused ? fused_kernel<32> : batched_kernel<32>;
    }
    if (D == 64) {
      *smem = Ring<64, P>::kBytes;
      return F == kFused ? fused_kernel<64> : batched_kernel<64>;
    }
  } else {
    if (D == 32) {
      *smem = sizeof(Tiles<float, 32>);
      return F == kFused ? fused_kernel_f32<32> : batched_kernel_f32<32>;
    }
    if (D == 64) {
      *smem = sizeof(Tiles<float, 64>);
      return F == kFused ? fused_kernel_f32<64> : batched_kernel_f32<64>;
    }
  }
  return nullptr;
}

template <typename T, int F>
Kern<T> prepared(int D, int threads, int smem) {
  int need_threads = 0, need_smem = 0;
  Kern<T> kern = instance<T, F>(D, &need_threads, &need_smem);
  if (kern == nullptr || threads != need_threads || smem < need_smem)
    return nullptr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return kern;
}

template <typename T, int F>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int NH, int D, int gx, int gy, int gz, int threads, int smem,
           void* stream) {
  Kern<T> kern = prepared<T, F>(D, threads, smem);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  kern<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, B, S, NH,
      kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T, int F>
int occupancy(int D, int threads, int smem) {
  Kern<T> kern = prepared<T, F>(D, threads, smem);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// C entry points, one per (function, dtype). Pointers are device pointers to
// contiguous (B, S, NH * D) tensors, 16-byte aligned; (gx, gy, gz), threads
// and the dynamic shared memory in bytes are ops/attention.py's
// launch_geometry; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success); an instance that does not exist, or threads or
// shared memory other than it needs, is cudaErrorInvalidValue. The caller
// validates shapes.
#define PIPE_ENTRY(name, T, F)                                               \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      int B, int S, int NH, int D, int gx, int gy, int gz,  \
                      int threads, int smem, void* stream) {                 \
    return launch<T, F>(q, k, v, o, B, S, NH, D, gx, gy, gz, threads, smem, \
                        stream);                                             \
  }

PIPE_ENTRY(mha_batched_heads_bf16, __nv_bfloat16, kBatched)
PIPE_ENTRY(mha_batched_heads_f32, float, kBatched)
PIPE_ENTRY(mha_fused_bf16, __nv_bfloat16, kFused)
PIPE_ENTRY(mha_fused_f32, float, kFused)

// The CTAs of an instance that fit on one SM at (threads, smem), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them; a negative
// cudaError_t on failure.
#define OCC_ENTRY(name, T, F)                                   \
  extern "C" int name(int D, int threads, int smem) {           \
    return occupancy<T, F>(D, threads, smem);                   \
  }

OCC_ENTRY(mha_batched_heads_occupancy_bf16, __nv_bfloat16, kBatched)
OCC_ENTRY(mha_batched_heads_occupancy_f32, float, kBatched)
OCC_ENTRY(mha_fused_occupancy_bf16, __nv_bfloat16, kFused)
OCC_ENTRY(mha_fused_occupancy_f32, float, kFused)
