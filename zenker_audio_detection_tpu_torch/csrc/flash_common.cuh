// What the port's attention sources share: register and warp helpers, the
// asynchronous copies, the K/V tiles of the synchronous flash body and that
// body's f32 form. Included by every attention source; each is its own
// library, so everything here is internal to the file that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16x16, row-major) * B (16x8, column-major), bf16 in, f32 accumulate.
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//      a2 (row g, cols 2t+8..2t+9), a3 (row g+8, cols 2t+8..2t+9)
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C: c0, c1 (row g, cols 2t..2t+1), c2, c3 (row g+8, same cols)
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

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8 and receives, of matrix i, rows 2t and 2t+1 of column g
// in r[i]. On a row-major tile whose rows are the k dimension, matrices 0
// and 1 (rows r..r+7 and r+8..r+15, columns c..c+7) are the B fragment
// (b0, b1) of an 8-column n-tile, and matrices 2 and 3 those of the next.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared (a shared-window address), asynchronous;
// zero-filled when !ok (the source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, ok);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The shared-memory K/V tiles of the synchronous body: one head's D lanes
// of 64 keys. bf16 rows are padded by 8 elements, which keeps the fragment
// reads free of bank conflicts (a row is 4 banks apart from the next at
// either width).
template <typename T, int D>
struct Tiles;

template <int D>
struct Tiles<__nv_bfloat16, D> {
  static constexpr int kLdk = D + 8;    // k[key][d]
  static constexpr int kLdv = kBK + 8;  // v[d][key], V transposed
  __nv_bfloat16 k[kBK * kLdk];
  __nv_bfloat16 v[D * kLdv];
};

template <int D>
struct Tiles<float, D> {
  float k[kBK * D];  // k[key][d]
  float v[kBK * D];  // v[key][d]
};

// One tile of 16 * W query rows of one head of one batch element, f32: two
// threads per query row, each holding D/2 of the D lanes of q and of the
// output; the partial dot products meet through one shuffle. Keys are
// handled 16 at a time for the online softmax. Token 0, lane 0 of the head
// is at q + base (and k, v + base), rows ld elements apart; the tile's
// first row is q0. Row r's result goes to out + obase + r * ldo; rows past
// S are not stored. With kLse the tile also stores each row's log-sum-exp,
// m + log2(l) in the log2 domain with the scale folded in, at
// lse[lbase + row] (rows < S).
template <int D, int W, bool kLse = false>
__device__ __forceinline__ void tile(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     size_t base, int S, int ld, int q0,
                                     float scale_log2, Tiles<float, D>& sm,
                                     float* __restrict__ out, ptrdiff_t obase,
                                     int ldo, float* __restrict__ lse = nullptr,
                                     size_t lbase = 0) {
  constexpr int kThreads = 32 * W, kHalf = D / 2, kLd = D;
  static_assert((kBK * D / 4) % kThreads == 0, "staging must divide evenly");
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = q0 + (tid >> 1);
  const int lane0 = half * kHalf;  // this thread's first lane
  const size_t qo = base + (size_t)row * ld + lane0;

  float qr[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; i += 4) {
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
    for (int i = 0; i < (kBK * D / 4) / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int key = c / (kLd / 4), d4 = (c % (kLd / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + key < S) {
        const size_t off = base + (size_t)(k0 + key) * ld + d4;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(sm.k + key * kLd + d4) = kv;
      *reinterpret_cast<float4*>(sm.v + key * kLd + d4) = vv;
    }
    __syncthreads();

    for (int kb = 0; kb < kBK; kb += 16) {
      float s[16];
      float mx = m;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float* kr = sm.k + (kb + j) * kLd + lane0;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) part = fmaf(qr[i], kr[i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        s[j] = k0 + kb + j < S ? part * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float c = exp2f(m - mx);
      m = mx;
      l *= c;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] *= c;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = exp2f(s[j] - m);
        l += p;
        const float* vr = sm.v + (kb + j) * kLd + lane0;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
  }

  if (row < S) {
    const float inv = 1.f / l;
    float* dst = out + (obase + (ptrdiff_t)row * ldo + lane0);
#pragma unroll
    for (int i = 0; i < kHalf; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv,
                      acc[i + 3] * inv);
    if constexpr (kLse) {
      if (half == 0) lse[lbase + row] = m + log2f(l);
    }
  }
}

}  // namespace
