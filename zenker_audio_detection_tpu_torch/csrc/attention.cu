// mha_qblock of the port's ops/attention.py on the synchronous flash body,
// the port's first attention body and the last entry point that runs it.
//
// Replaces the Pallas kernel _attn_kernel_qblock of
// zenker_audio_detection_tpu/ops/attention.py (grid (B * NH, q blocks) on
// (B, S, NH, D)) with its decomposition: grid (q blocks, B * NH), a block of
// 64 or 128 query rows (ops/attention.py:qblock_rows). A contiguous
// (B, S, NH, D) tensor is the same memory as packed (B, S, NH * D), which
// the other entry points walk on the Hopper bodies of attention_ws.cu and
// attention_pipelined.cu; this file is the next to move there (ROADMAP B5),
// after which it goes.
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
// D (32 or 64) and W are compile-time instances. The body stages its K/V
// tiles with plain loads between two __syncthreads and keeps no copy in
// flight while it computes: the Hopper bodies' rings and wgmma are what
// this file lacks.

#include "flash_common.cuh"

namespace {

// The value keeps the mangled names of the instances, which the build report
// reads.
enum Kind { kQBlock = 3 };

// One tile of 16 * W query rows of one head of one batch element, bf16.
// Token 0, lane 0 of the head is at q + base (and k, v + base), rows ld
// elements apart; the tile's first row is q0. Row r's result goes to
// out + obase + r * ldo; rows past S are not stored. The kernel's own
// pointers and one offset are passed, not pointers offset in advance: that
// keeps the D = 64 body at the registers it needs without spilling.
//
// The fragments are laid out as flash_common.cuh:mma_bf16 gives them, with
// g = lane / 4 and t = lane % 4.
template <int D, int W>
__device__ __forceinline__ void tile(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     size_t base, int S, int ld, int q0,
                                     float scale_log2,
                                     Tiles<__nv_bfloat16, D>& sm,
                                     __nv_bfloat16* __restrict__ out,
                                     ptrdiff_t obase, int ldo) {
  using Sm = Tiles<__nv_bfloat16, D>;
  constexpr int kThreads = 32 * W;
  static_assert((kBK * D / 8) % kThreads == 0, "staging must divide evenly");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 x D Q slice
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
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
    for (int i = 0; i < (kBK * D / 8) / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int key = c / (D / 8), d8 = (c % (D / 8)) * 8;
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
      const __nv_bfloat16* kp = sm.k + (n * 8 + g) * Sm::kLdk + 2 * t;
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
      const __nv_bfloat16* vp = sm.v + (n * 8 + g) * Sm::kLdv + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(acc[n], pf[kk], ld32(vp + kk * 16), ld32(vp + kk * 16 + 8));
    }
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + (obase + (ptrdiff_t)r0 * ldo + c)) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (obase + (ptrdiff_t)r1 * ldo + c)) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// One kernel per (dtype, D, W); K is kQBlock, kept for the mangled names.
// The grid is (q blocks, B * NH), a block's tile 16 * W query rows, as
// ops/attention.py:launch_geometry gives them. The launch bounds hold a
// thread to 128 registers, so that 16 warps fit on an SM: left alone, the
// compiler gave the bf16 D = 64 body 134, only 12 warps fit, and the kernel
// then serving mha_packed ran 8-9 % slower at the AST shape.
template <typename T, int D, int W, int K>
__global__ void __launch_bounds__(32 * W, 16 / W)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int NH,
            float scale_log2) {
  static_assert(K == kQBlock, "mha_qblock's grid only");
  __shared__ __align__(16) Tiles<T, D> sm;
  constexpr int R = 16 * W;
  const int H = NH * D;
  const size_t seq = (size_t)S * H;  // elements of one batch element
  const int b = blockIdx.y / NH;
  const int h = blockIdx.y % NH;
  const size_t base = b * seq + (size_t)h * D;
  tile<D, W>(q, k, v, base, S, H, blockIdx.x * R, scale_log2, sm, o, base, H);
}

template <typename T, int D, int W>
int launch(const void* q, const void* k, const void* v, void* o, int S,
           int NH, dim3 grid, int smem, cudaStream_t stream) {
  attn_kernel<T, D, W, kQBlock><<<grid, 32 * W, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, NH,
      kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// Picks the instance for (D, threads): 4- and 8-warp tiles.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int S,
             int NH, int D, int gx, int gy, int gz, int threads, int smem,
             void* stream) {
  const dim3 grid(gx, gy, gz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads == 128) {
    if (D == 32) return launch<T, 32, 4>(q, k, v, o, S, NH, grid, smem, st);
    if (D == 64) return launch<T, 64, 4>(q, k, v, o, S, NH, grid, smem, st);
  }
  if (threads == 256) {
    if (D == 32) return launch<T, 32, 8>(q, k, v, o, S, NH, grid, smem, st);
    if (D == 64) return launch<T, 64, 8>(q, k, v, o, S, NH, grid, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, one per dtype. Pointers are device pointers to contiguous
// (B, S, NH * D) tensors, 16-byte aligned; (gx, gy, gz), threads and the
// dynamic shared memory in bytes are ops/attention.py's launch_geometry;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success); an instance that does not exist is cudaErrorInvalidValue. The
// caller validates shapes.
#define ATTN_ENTRY(name, T)                                                  \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      int S, int NH, int D, int gx, int gy, int gz,         \
                      int threads, int smem, void* stream) {                 \
    return dispatch<T>(q, k, v, o, S, NH, D, gx, gy, gz, threads, smem,     \
                       stream);                                              \
  }

ATTN_ENTRY(mha_qblock_bf16, __nv_bfloat16)
ATTN_ENTRY(mha_qblock_f32, float)
