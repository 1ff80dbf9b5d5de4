// A flash-attention body built for Hopper, and the entry points of the
// port's ops/attention.py that run it.
//
// Replaces two Pallas kernels of zenker_audio_detection_tpu/ops/attention.py
// and, in f32, four more and the forward of its custom VJP (their bf16
// form is the warp-specialised walk of attention_ws.cu):
//   mha_packed, f32   <- _attn_kernel_packed (grid (B, q blocks) on packed
//                        (B, S, H = NH * D) projections, heads by lane
//                        slices). A contiguous packed tensor is the
//                        (B, S, NH, D) memory mha_batched_heads walks, so
//                        mha_packed launches batched_kernel_f32's instances
//                        as they are: no kernel of its own.
//   mha, mha_pairs,   <- _attn_kernel (grid (B * NH)), _attn_kernel_pairs
//   mha_qblock, f32      (two heads per program, even NH) and
//                        _attn_kernel_qblock (grid (B * NH, q blocks)): the
//                        same function on the same memory, so the same
//                        instances (attention_ws.cu says why the TPU
//                        decompositions are not carried over).
//   mha_packed_lse,   <- the forward of mha_packed_trainable (the custom
//   f32                  VJP, _attn_kernel_packed under autograd):
//                        batched_kernel_f32<D, true>, the same walk and
//                        tile, which also stores each row's log-sum-exp for
//                        the backward in attention_bwd.cu. Its output is
//                        mha_packed's bit for bit.
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
// Contract: reference_mha's (ops/attention.py): scores and softmax in f32,
// p rounded to the input dtype for the PV product, f32 accumulation.
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
//   * the online softmax is f32 in the log2 domain: the
//     unnormalised exp(s - m) is rounded to bf16 for the PV product and the
//     division by the row sum happens once, at the end;
//   * 256 threads and at most 128 registers a thread (the launch bounds), and
//     at most 97 KB of shared memory a CTA, so 2 CTAs (16 warps) share an SM:
//     while one waits on its products or its softmax the other issues.
//     The *_occupancy_* entry points report what the card makes of it.
// The f32 instances keep the FMA tile of flash_common.cuh (never TF32) under
// the same decompositions: 8 warps of 128 rows a work item for the persistent
// walk, and for mha_fused 4 warps walking the heads of 64 rows one at a time.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kStages = 3;  // K/V tiles in the ring
constexpr int kRowsWG = 64;  // query rows of a warpgroup (wgmma's M)
constexpr int kThreadsWG = 128;
constexpr int kWGs = 2;      // consumer warpgroups of a bf16 CTA
// the kernels: the persistent walk (mha_batched_heads; f32 mha_packed and,
// with the lse, mha_packed_lse), mha_fused's grid
enum Fn { kBatched, kFused };

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
    wgmma_wait<0>();
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
    wgmma_wait<0>();
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

// f32: the FMA tile (flash_common.cuh) under the same walks. With kLse
// (mha_packed_lse) each row's log-sum-exp also goes to the (B, NH, S) f32
// buffer lse, the last argument, which the other kernels do not take.
template <int D, bool kLse>
__global__ void __launch_bounds__(256, 2)
batched_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int B,
                   int S, int NH, float scale_log2, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char dyn[];
  auto& sm = *reinterpret_cast<Tiles<float, D>*>(dyn);
  const int H = NH * D, nqb = (S + 127) / 128;
  const int items = B * NH * nqb;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int b = i / (NH * nqb), h = i / nqb % NH, qb = i % nqb;
    const size_t base = (size_t)b * S * H + (size_t)h * D;
    tile<D, 8, kLse>(q, k, v, base, S, H, qb * 128, scale_log2, sm, o,
                        base, H, lse, ((size_t)b * NH + h) * S);
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
// The kernel of (function, dtype, D, lse). Kernels are handled as
// `const void*` and launched with cudaLaunchKernel, which reads as many
// arguments as the kernel takes: the lse form takes one pointer more, last.
template <typename T, int F, int D, bool kLse>
const void* kernel() {
  static_assert(!kLse || (sizeof(T) == 4 && F == kBatched),
                "the lse form is f32 mha_packed_lse (bf16: attention_ws.cu)");
  if constexpr (sizeof(T) == 2) {
    if constexpr (F == kFused) return (const void*)fused_kernel<D>;
    return (const void*)batched_kernel<D>;
  } else {
    if constexpr (F == kFused) return (const void*)fused_kernel_f32<D>;
    return (const void*)batched_kernel_f32<D, kLse>;
  }
}

// The instance of (function, dtype, lse), with the threads and the dynamic
// shared memory it needs; nullptr for a D it is not compiled for. These
// numbers are ops/attention.py:launch_geometry's.
template <typename T, int F, bool kLse>
const void* instance(int D, int* threads, int* smem) {
  constexpr bool kBf16 = sizeof(T) == 2;
  *threads = kBf16 || F != kFused ? kWGs * kThreadsWG : 128;
  if (D != 32 && D != 64) return nullptr;
  if constexpr (kBf16) {
    constexpr int P = F == kFused ? 2 : 1;
    *smem = D == 32 ? Ring<32, P>::kBytes : Ring<64, P>::kBytes;
  } else {
    *smem = D == 32 ? sizeof(Tiles<float, 32>) : sizeof(Tiles<float, 64>);
  }
  return D == 32 ? kernel<T, F, 32, kLse>() : kernel<T, F, 64, kLse>();
}

template <typename T, int F, bool kLse>
const void* prepared(int D, int threads, int smem) {
  int need_threads = 0, need_smem = 0;
  const void* kern = instance<T, F, kLse>(D, &need_threads, &need_smem);
  if (kern == nullptr || threads != need_threads || smem < need_smem)
    return nullptr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return kern;
}

// lse is the (B, NH, S) f32 buffer of the lse form, unread by the others.
template <typename T, int F, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int NH, int D, int gx, int gy, int gz, int threads,
           int smem, void* stream) {
  const void* kern = prepared<T, F, kLse>(D, threads, smem);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  float scale_log2 = kLog2e / sqrtf((float)D);
  void* args[] = {&q, &k, &v, &o, &B, &S, &NH, &scale_log2, &lse};
  cudaLaunchKernel(kern, dim3(gx, gy, gz), dim3(threads), args, smem,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename T, int F, bool kLse>
int occupancy(int D, int threads, int smem) {
  const void* kern = prepared<T, F, kLse>(D, threads, smem);
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
// validates shapes. f32 mha_packed, mha, mha_pairs and mha_qblock are
// mha_batched_heads' kernel on the same memory, so their entry points launch
// one instance.
#define PIPE_ENTRY(name, T, F)                                               \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      int B, int S, int NH, int D, int gx, int gy, int gz,  \
                      int threads, int smem, void* stream) {                 \
    return launch<T, F, false>(q, k, v, o, nullptr, B, S, NH, D, gx, gy,    \
                               gz, threads, smem, stream);                   \
  }

PIPE_ENTRY(mha_packed_f32, float, kBatched)
PIPE_ENTRY(mha_f32, float, kBatched)
PIPE_ENTRY(mha_pairs_f32, float, kBatched)
PIPE_ENTRY(mha_qblock_f32, float, kBatched)
PIPE_ENTRY(mha_batched_heads_bf16, __nv_bfloat16, kBatched)
PIPE_ENTRY(mha_batched_heads_f32, float, kBatched)
PIPE_ENTRY(mha_fused_bf16, __nv_bfloat16, kFused)
PIPE_ENTRY(mha_fused_f32, float, kFused)

// f32 mha_packed with the row log-sum-exp: as mha_packed's entry point,
// with lse a device pointer to a contiguous (B, NH, S) f32 buffer.
#define LSE_ENTRY(name, T)                                                   \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      void* lse, int B, int S, int NH, int D, int gx,       \
                      int gy, int gz, int threads, int smem, void* stream) { \
    return launch<T, kBatched, true>(q, k, v, o, lse, B, S, NH, D, gx, gy,  \
                                     gz, threads, smem, stream);             \
  }

LSE_ENTRY(mha_packed_lse_f32, float)

// The CTAs of an instance that fit on one SM at (threads, smem), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them; a negative
// cudaError_t on failure.
#define OCC_ENTRY(name, T, F, kLse)                             \
  extern "C" int name(int D, int threads, int smem) {           \
    return occupancy<T, F, kLse>(D, threads, smem);             \
  }

OCC_ENTRY(mha_packed_occupancy_f32, float, kBatched, false)
OCC_ENTRY(mha_packed_lse_occupancy_f32, float, kBatched, true)
OCC_ENTRY(mha_occupancy_f32, float, kBatched, false)
OCC_ENTRY(mha_pairs_occupancy_f32, float, kBatched, false)
OCC_ENTRY(mha_qblock_occupancy_f32, float, kBatched, false)
OCC_ENTRY(mha_batched_heads_occupancy_bf16, __nv_bfloat16, kBatched, false)
OCC_ENTRY(mha_batched_heads_occupancy_f32, float, kBatched, false)
OCC_ENTRY(mha_fused_occupancy_bf16, __nv_bfloat16, kFused, false)
OCC_ENTRY(mha_fused_occupancy_f32, float, kFused, false)
