// Fused multi-head self-attention for the port's ops/attention.py.
//
// Replaces three of the six Pallas kernels of zenker_audio_detection_tpu/ops/
// attention.py that compute one function on (B, S, NH, D), which is the same
// memory as packed (B, S, H = NH * D):
//   mha_pairs         <- _attn_kernel_pairs    grid (q tiles, NH / 2, B), two
//                                              heads per block on one staged
//                                              2 * D-lane K/V tile
//   mha               <- _attn_kernel          grid (B * NH), q tiles looped
//   mha_qblock        <- _attn_kernel_qblock   grid (q blocks, B * NH)
// (mha_packed, its lse forward, mha_batched_heads and mha_fused run the
// pipelined body of attention_pipelined.cu.)
// Each keeps its TPU counterpart's work decomposition; all of them run the
// same flash body below, so they agree with each other row for row.
// Contract (reference_mha there): scores = q k^T / sqrt(D) accumulated in
// f32, softmax in f32, p cast to the input dtype before the PV product, PV
// accumulated in f32, output in the input dtype. A head's D lanes are read
// through strides: no transposes, pads or copies around the call. Keys past
// S are masked inside the kernel and query rows past S are not stored, where
// the TPU wrappers pad S to a multiple of 128.
//
// What bounds it on an H100 SXM. At the AST shape (B, S, NH, D) =
// (128, 1214, 12, 64) bf16: 4 * B * NH * S^2 * D = 579.5 GFLOP of products,
// 0.59 ms at 989 TFLOP/s; q, k, v and the output are 4 x 238.7 MB = 955 MB,
// 0.29 ms at 3.35 TB/s; the 2.26 G exponentials take about the same 0.6 ms
// at the SFU rate. So it is compute-bound (tensor cores and exp), not bound
// by bytes.
//
// The TPU kernels keep all S keys of a head on chip. At S = 1214, K and V of
// one head are ~155 KB each in bf16, more than a block's shared memory holds
// together, so the body is the flash form instead:
//   * a tile of 16 * W query rows, W warps; each warp owns 16 rows and keeps
//     its Q fragments in registers;
//   * the block walks over the keys in tiles of 64, staged in shared memory
//     (K row-major, V transposed so that both products read 32-bit pairs);
//   * an online softmax keeps a running max and sum per query row in f32;
//     the unnormalised exp(s - m) is rounded to bf16 for the PV product and
//     the division by the row sum happens once, at the end. The reference
//     rounds the normalised p instead, so the two agree to a tolerance;
//   * bf16 products run on the tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate). The f32 body uses plain f32 FMAs and never
//     TF32;
//   * the ragged last key tile and query tile (1214 = 18 * 64 + 62) are
//     masked inside the kernel: keys past S score -inf, rows past S are
//     computed on zeros and not stored.
// D (32 or 64) and W are compile-time instances, and so is P, the heads
// that share one block's staged K/V tile (2 for mha_pairs, else 1). The TPU
// pairs kernel packs its two heads block-diagonally into (2S, 128) K/V with
// zeros to fill the 128-wide MXU; that doubles the products and is not
// carried over. What it buys here is one staged 2 * D-lane tile (256 B a row
// in bf16) for two heads: warps 0..W/2-1 take the first, the rest the second,
// each reading its half of the tile. The first design aims at right and
// simple; attention_pipelined.cu has the body built for Hopper (a cp.async
// ring and wgmma), which these decompositions do not use yet.

#include "flash_common.cuh"

namespace {

// The values keep the mangled names of the instances, which the build report
// reads (0 was mha_packed's, whose kernels are in attention_ws.cu and
// attention_pipelined.cu).
enum Kind { kPerHead = 1, kQBlock = 3, kPairs = 5 };

// One tile of 16 * W / P query rows of P heads of one batch element, bf16.
// Token 0, lane 0 of the first head is at q + base (and k, v + base), rows
// ld elements apart; the tile's first row is q0. Warp group hp (W / P warps)
// takes head hp, whose lanes start hp * D further on. Row r of head hp's
// result goes to out + obase + hp * D + r * ldo; rows past S are not
// stored. The kernel's own pointers and one offset are passed, not pointers
// offset in advance: that keeps the D = 64 body at the registers it needs
// without spilling.
//
// The fragments are laid out as flash_common.cuh:mma_bf16 gives them, with
// g = lane / 4 and t = lane % 4.
template <int D, int W, int P = 1>
__device__ __forceinline__ void tile(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     size_t base, int S, int ld, int q0,
                                     float scale_log2,
                                     Tiles<__nv_bfloat16, D, P>& sm,
                                     __nv_bfloat16* __restrict__ out,
                                     ptrdiff_t obase, int ldo) {
  using Sm = Tiles<__nv_bfloat16, D, P>;
  constexpr int kThreads = 32 * W;
  static_assert(W % P == 0, "each head takes W / P warps");
  static_assert((kBK * P * D / 8) % kThreads == 0,
                "staging must divide evenly");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's head of the P and its 16-row slice of the head's rows
  const int hp = P == 1 ? 0 : warp / (W / P);
  const int wr = P == 1 ? warp : warp % (W / P);
  const int r0 = q0 + wr * 16 + g, r1 = r0 + 8;

  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 x D Q slice
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = hp * D + kk * 16 + 2 * t;
    qf[kk][0] = r0 < S ? ld32(q + base + (size_t)r0 * ld + c) : 0u;
    qf[kk][1] = r1 < S ? ld32(q + base + (size_t)r1 * ld + c) : 0u;
    qf[kk][2] = r0 < S ? ld32(q + base + (size_t)r0 * ld + c + 8) : 0u;
    qf[kk][3] = r1 < S ? ld32(q + base + (size_t)r1 * ld + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < (kBK * P * D / 8) / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int key = c / (P * D / 8), d8 = (c % (P * D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + key < S) {
        const size_t off = base + (size_t)(k0 + key) * ld + d8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sm.k + key * Sm::kLdk + d8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.v[(d8 + j) * Sm::kLdv + key] = ve[j];
    }
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: eight 8-key n-tiles, K = D in D/16 steps
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp =
          sm.k + (n * 8 + g) * Sm::kLdk + hp * D + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + n * 8 + 2 * t + j < S;
        s[n][j] = ok ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
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
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // p = exp(s - m); the C fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk of the PV product
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - m0), p1 = exp2f(s[n][1] - m0);
      const float p2 = exp2f(s[n][2] - m1), p3 = exp2f(s[n][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // acc += p v: D/8 8-lane n-tiles of the head, K = 64 keys in 4 steps
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* vp =
          sm.v + (hp * D + n * 8 + g) * Sm::kLdv + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(acc[n], pf[kk], ld32(vp + kk * 16), ld32(vp + kk * 16 + 8));
    }
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = hp * D + n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + (obase + (ptrdiff_t)r0 * ldo + c)) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (obase + (ptrdiff_t)r1 * ldo + c)) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// One kernel per (dtype, D, W, decomposition). The block's tiles are
// 16 * W query rows; the grid is the one ops/attention.py:launch_geometry
// gives for the decomposition. The launch bounds hold a thread to 128
// registers, so that 16 warps fit on an SM: left alone, the compiler gave
// the bf16 D = 64 body 134, only 12 warps fit, and the kernel then serving
// mha_packed ran 8-9 % slower at the AST shape.
template <typename T, int D, int W, int K>
__global__ void __launch_bounds__(32 * W, 16 / W)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int NH,
            float scale_log2) {
  __shared__ __align__(16) Tiles<T, D> sm;
  constexpr int R = 16 * W;
  const int H = NH * D;
  const size_t seq = (size_t)S * H;  // elements of one batch element

  if constexpr (K == kQBlock) {
    // one tile: grid (q blocks, B * NH)
    const int b = blockIdx.y / NH;
    const int h = blockIdx.y % NH;
    const size_t base = b * seq + (size_t)h * D;
    tile<D, W>(q, k, v, base, S, H, blockIdx.x * R, scale_log2, sm, o, base,
               H);
  } else {
    // kPerHead, grid (B * NH): one head, all its q tiles. The loop over the
    // one head keeps the code (and the registers and spills) these
    // instances have had since they were measured.
    const int b = blockIdx.x / NH;
    const int h_begin = blockIdx.x % NH;
    const int h_end = h_begin + 1;
    for (int h = h_begin; h < h_end; ++h) {
      const size_t base = b * seq + (size_t)h * D;
      for (int q0 = 0; q0 < S; q0 += R)
        tile<D, W>(q, k, v, base, S, H, q0, scale_log2, sm, o, base, H);
    }
  }
}

// kPairs, grid (q tiles, NH / 2, B): heads 2p and 2p + 1 of one 16 * W / 2
// row q tile, on K/V tiles staged once for both. The pair's tiles are in
// dynamic shared memory: 64 KB in f32, over the 48 KB a static array may
// take. A kernel of its own, so that attn_kernel's instances stay as they
// were.
template <typename T, int D, int W>
__global__ void __launch_bounds__(32 * W, 16 / W)
pairs_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int NH,
             float scale_log2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  auto& sm = *reinterpret_cast<Tiles<T, D, 2>*>(dyn);
  const int H = NH * D;
  const size_t base =
      blockIdx.z * ((size_t)S * H) + (size_t)blockIdx.y * 2 * D;
  tile<D, W, 2>(q, k, v, base, S, H, blockIdx.x * (16 * W / 2), scale_log2,
                sm, o, base, H);
}

template <typename T, int D, int W, int K>
int launch(const void* q, const void* k, const void* v, void* o, int S,
           int NH, dim3 grid, int smem, cudaStream_t stream) {
  void (*kern)(const T*, const T*, const T*, T*, int, int, float);
  if constexpr (K == kPairs) {
    if (smem < (int)sizeof(Tiles<T, D, 2>))
      return (int)cudaErrorInvalidValue;  // the pair's tiles must fit
    kern = pairs_kernel<T, D, W>;
  } else {
    kern = attn_kernel<T, D, W, K>;
  }
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, 32 * W, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                       (T*)o, S, NH,
                                       kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// Picks the instance for (D, threads). mha_qblock has 4- and 8-warp tiles,
// mha_pairs 8 warps only (4 per head), mha 4 warps.
template <typename T, int K>
int dispatch(const void* q, const void* k, const void* v, void* o, int S,
             int NH, int D, int gx, int gy, int gz, int threads, int smem,
             void* stream) {
  const dim3 grid(gx, gy, gz);
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (K != kPairs) {
    if (threads == 128) {
      if (D == 32)
        return launch<T, 32, 4, K>(q, k, v, o, S, NH, grid, smem, st);
      if (D == 64)
        return launch<T, 64, 4, K>(q, k, v, o, S, NH, grid, smem, st);
    }
  }
  if constexpr (K == kQBlock || K == kPairs) {
    if (threads == 256) {
      if (D == 32) return launch<T, 32, 8, K>(q, k, v, o, S, NH, grid, smem, st);
      if (D == 64) return launch<T, 64, 8, K>(q, k, v, o, S, NH, grid, smem, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, one per (function, dtype). Pointers are device pointers to
// contiguous (B, S, NH * D) tensors, 16-byte aligned; (gx, gy, gz), threads
// and the dynamic shared memory in bytes are ops/attention.py's
// launch_geometry; `stream` is a cudaStream_t. Returns the cudaError_t of
// the launch (0 on success); an instance that does not exist is
// cudaErrorInvalidValue. The caller validates shapes.
#define ATTN_ENTRY(name, T, K)                                               \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      int S, int NH, int D, int gx, int gy, int gz,         \
                      int threads, int smem, void* stream) {                 \
    return dispatch<T, K>(q, k, v, o, S, NH, D, gx, gy, gz, threads, smem,  \
                          stream);                                           \
  }

ATTN_ENTRY(mha_pairs_bf16, __nv_bfloat16, kPairs)
ATTN_ENTRY(mha_pairs_f32, float, kPairs)
ATTN_ENTRY(mha_bf16, __nv_bfloat16, kPerHead)
ATTN_ENTRY(mha_f32, float, kPerHead)
ATTN_ENTRY(mha_qblock_bf16, __nv_bfloat16, kQBlock)
ATTN_ENTRY(mha_qblock_f32, float, kQBlock)
