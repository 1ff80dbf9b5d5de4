// Fused multi-head self-attention on packed (B, S, H = NH * 64) projections.
//
// Replaces zenker_audio_detection_tpu/ops/attention.py:_attn_kernel_packed
// (the Pallas kernel behind mha_packed). Contract (reference_mha there):
// scores = q k^T / sqrt(D) accumulated in f32, softmax in f32, p cast to the
// input dtype before the PV product, PV accumulated in f32, output in the
// input dtype. The head's 64-lane slice is read from the packed layout
// through strides: no transposes, pads or copies around the call.
//
// What bounds it on an H100 SXM. At the AST shape (B, S, H) =
// (128, 1214, 768) bf16: 4 * B * NH * S^2 * D = 579.5 GFLOP of products,
// 0.59 ms at 989 TFLOP/s; q, k, v and the output are 4 x 238.7 MB = 955 MB,
// 0.29 ms at 3.35 TB/s; the 2.26 G exponentials take about the same 0.6 ms
// at the SFU rate. So it is compute-bound (tensor cores and exp), not bound
// by bytes.
//
// The TPU kernel keeps all S keys of a head on chip. At S = 1214, K and V
// of one head are ~155 KB each in bf16, more than a block's shared memory
// holds together, so this design is the flash form instead:
//   * one block per (64-query tile, head, batch element), 128 threads; each
//     warp owns 16 query rows and keeps its Q fragments in registers;
//   * the block walks over the keys in tiles of 64, staged in shared memory
//     (K row-major, V transposed so that both products read 32-bit pairs);
//   * an online softmax keeps a running max and sum per query row in f32;
//     the unnormalised exp(s - m) is rounded to bf16 for the PV product and
//     the division by the row sum happens once, at the end. The reference
//     rounds the normalised p instead, so the two agree to a tolerance;
//   * bf16 products run on the tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate). The f32 kernel uses plain f32 FMAs and
//     never TF32;
//   * the ragged last key tile and query tile (1214 = 18 * 64 + 62) are
//     masked inside the kernel: keys past S score -inf, rows past S are
//     computed on zeros and not stored.
// The first design aims at right and simple. Double-buffered cp.async/TMA
// staging, wgmma and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head width the kernels take
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kLds = kD + 8;    // bf16 row stride of the shared tiles; the pad
                                // keeps the fragment reads free of bank conflicts
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//      a2 (row g, cols 2t+8..2t+9), a3 (row g+8, cols 2t+8..2t+9)
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C: c0, c1 (row g, cols 2t..2t+1), c2, c3 (row g+8, same cols)
__global__ void __launch_bounds__(kThreads)
mha_packed_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int S, int H,
                       float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kLds];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_s[kD * kLds];   // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // element offset of (batch, token 0, this head's first lane)
  const size_t base = (size_t)blockIdx.z * S * H + (size_t)blockIdx.y * kD;
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qf[4][4];  // A fragments of this warp's 16 x 64 Q slice
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < S ? ld32(q + base + (size_t)r0 * H + c) : 0u;
    qf[kk][1] = r1 < S ? ld32(q + base + (size_t)r1 * H + c) : 0u;
    qf[kk][2] = r0 < S ? ld32(q + base + (size_t)r0 * H + c + 8) : 0u;
    qf[kk][3] = r1 < S ? ld32(q + base + (size_t)r1 * H + c + 8) : 0u;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < (kBK * kD / 8) / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int key = c >> 3, d8 = (c & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + key < S) {
        const size_t off = base + (size_t)(k0 + key) * H + d8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + key * kLds + d8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(d8 + j) * kLds + key] = ve[j];
    }
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: eight 8-key n-tiles, K = 64 in 4 steps
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = k_s + (n * 8 + g) * kLds + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
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
    for (int n = 0; n < 8; ++n) {
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

    // acc += p v: eight 8-lane n-tiles of the head, K = 64 keys in 4 steps
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* vp = vt_s + (n * 8 + g) * kLds + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(acc[n], pf[kk], ld32(vp + kk * 16), ld32(vp + kk * 16 + 8));
    }
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * H + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * H + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// f32: two threads per query row, each holding 32 of the 64 lanes of q and
// of the output; the partial dot products meet through one shuffle. Keys
// are handled 16 at a time for the online softmax.
__global__ void __launch_bounds__(kThreads)
mha_packed_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int S,
                      int H, float scale_log2) {
  __shared__ __align__(16) float k_s[kBK * kD];
  __shared__ __align__(16) float v_s[kBK * kD];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = blockIdx.x * kBQ + (tid >> 1);
  const size_t base = (size_t)blockIdx.z * S * H + (size_t)blockIdx.y * kD;
  const size_t qo = base + (size_t)row * H + half * 32;

  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = *reinterpret_cast<const float4*>(q + qo + i);
    qr[i] = x.x;
    qr[i + 1] = x.y;
    qr[i + 2] = x.z;
    qr[i + 3] = x.w;
    acc[i] = acc[i + 1] = acc[i + 2] = acc[i + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (kBK * kD / 4) / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int key = c >> 4, d4 = (c & 15) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + key < S) {
        const size_t off = base + (size_t)(k0 + key) * H + d4;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(k_s + key * kD + d4) = kv;
      *reinterpret_cast<float4*>(v_s + key * kD + d4) = vv;
    }
    __syncthreads();

    for (int kb = 0; kb < kBK; kb += 16) {
      float s[16];
      float mx = m;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float* kr = k_s + (kb + j) * kD + half * 32;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) part = fmaf(qr[i], kr[i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        s[j] = k0 + kb + j < S ? part * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float c = exp2f(m - mx);
      m = mx;
      l *= c;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= c;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = exp2f(s[j] - m);
        l += p;
        const float* vr = v_s + (kb + j) * kD + half * 32;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
  }

  if (row < S) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < 32; i += 4)
      *reinterpret_cast<float4*>(o + qo + i) =
          make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv,
                      acc[i + 3] * inv);
  }
}

}  // namespace

// C entry points. Pointers are device pointers to contiguous (B, S, NH * 64)
// tensors, 16-byte aligned; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). The caller validates shapes.
extern "C" int mha_packed_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int NH, void* stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, NH, B);
  const float scale_log2 = kLog2e / sqrtf((float)kD);
  mha_packed_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, NH * kD, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" int mha_packed_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int S, int NH, void* stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, NH, B);
  const float scale_log2 = kLog2e / sqrtf((float)kD);
  mha_packed_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S,
      NH * kD, scale_log2);
  return (int)cudaGetLastError();
}
